from .coloring import Coloring, greedy_coloring
from .generators import (complete_bipolar, erdos_renyi,
                         ground_state_planted_grid, small_world,
                         sparse_bipolar_edges, torus_grid, torus_grid_edges)
from .gset import GSET_SAMPLE, parse_gset, parse_gset_edges
from .maxcut import (MaxCutInstance, cut_from_energy, cut_value,
                     energy_from_cut, maxcut_edges_to_ising, maxcut_to_ising)
from .qubo import ising_to_qubo, qubo_to_ising

__all__ = ["Coloring", "GSET_SAMPLE", "MaxCutInstance", "complete_bipolar",
           "cut_from_energy", "cut_value", "energy_from_cut", "erdos_renyi",
           "greedy_coloring", "ground_state_planted_grid", "ising_to_qubo",
           "maxcut_edges_to_ising", "maxcut_to_ising", "parse_gset",
           "parse_gset_edges", "qubo_to_ising", "small_world",
           "sparse_bipolar_edges", "torus_grid", "torus_grid_edges"]
