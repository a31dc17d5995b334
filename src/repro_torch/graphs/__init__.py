from .generators import complete_bipolar, erdos_renyi, sparse_bipolar_edges
from .maxcut import (MaxCutInstance, cut_from_energy, maxcut_edges_to_ising,
                     maxcut_to_ising)

__all__ = ["MaxCutInstance", "complete_bipolar", "cut_from_energy",
           "erdos_renyi", "maxcut_edges_to_ising", "maxcut_to_ising",
           "sparse_bipolar_edges"]
