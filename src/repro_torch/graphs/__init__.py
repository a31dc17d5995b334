from .generators import complete_bipolar, erdos_renyi
from .maxcut import MaxCutInstance, cut_from_energy, maxcut_to_ising

__all__ = ["MaxCutInstance", "complete_bipolar", "cut_from_energy",
           "erdos_renyi", "maxcut_to_ising"]
