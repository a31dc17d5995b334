from .coloring import Coloring, greedy_coloring
from .generators import (complete_bipolar, erdos_renyi, sparse_bipolar_edges,
                         torus_grid_edges)
from .maxcut import (MaxCutInstance, cut_from_energy, maxcut_edges_to_ising,
                     maxcut_to_ising)

__all__ = ["Coloring", "MaxCutInstance", "complete_bipolar",
           "cut_from_energy", "erdos_renyi", "greedy_coloring",
           "maxcut_edges_to_ising", "maxcut_to_ising",
           "sparse_bipolar_edges", "torus_grid_edges"]
