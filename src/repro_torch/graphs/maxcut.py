"""Max-Cut ↔ Ising mapping (paper §II-A/B). Port of ``repro.graphs.maxcut``.

J = −w and h = 0, so ``cut(s) = (Σ_{i<j} w_ij − H(s)) / 2``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.ising import EdgeList, IsingProblem


@dataclasses.dataclass(frozen=True)
class MaxCutInstance:
    """Dense symmetric weight matrix with zero diagonal."""

    weights: np.ndarray  # (N, N) float32
    name: str = "maxcut"
    best_known: float | None = None

    @property
    def num_vertices(self) -> int:
        return self.weights.shape[0]

    @property
    def num_edges(self) -> int:
        return int(np.count_nonzero(np.triu(self.weights, 1)))

    @property
    def total_weight(self) -> float:
        return float(np.triu(self.weights, 1).sum())

    @property
    def density(self) -> float:
        n = self.num_vertices
        return 2.0 * self.num_edges / (n * (n - 1))


def maxcut_to_ising(instance: MaxCutInstance, device=None) -> IsingProblem:
    """J = −w, h = 0, offset 0 (``best_energy`` maps to a cut through
    :func:`cut_from_energy`)."""
    w = np.asarray(instance.weights, np.float32)
    return IsingProblem.create(J=-w, h=None, offset=0.0, device=device)


def maxcut_edges_to_ising(weight_edges: EdgeList) -> IsingProblem:
    """Dense-J-free counterpart of :func:`maxcut_to_ising`: an ``EdgeList``
    of weights w → the edge-list J = −w problem (h = 0, offset 0)."""
    if not isinstance(weight_edges, EdgeList):
        raise TypeError(f"maxcut_edges_to_ising needs an EdgeList of weights, "
                        f"got {type(weight_edges).__name__}")
    return IsingProblem.create_sparse(weight_edges.negated())


def cut_value(instance: MaxCutInstance, spins):
    """Cut weight of the bipartition induced by ±1 spins (one row gives a
    float, a batch an array)."""
    s = np.asarray(spins, np.float32)
    w = np.asarray(instance.weights, np.float32)
    if s.ndim == 1:
        return float(np.sum(np.triu(w, 1) * (1.0 - np.outer(s, s))) / 2.0)
    return np.array([cut_value(instance, row) for row in s])


def cut_from_energy(instance: MaxCutInstance, ising_energy) -> np.ndarray:
    """cut = (Σw − H)/2 for H from the J=−w encoding."""
    return (instance.total_weight - np.asarray(ising_energy)) / 2.0


def energy_from_cut(instance: MaxCutInstance, cut) -> np.ndarray:
    """H = Σw − 2·cut, the inverse of :func:`cut_from_energy`."""
    return instance.total_weight - 2.0 * np.asarray(cut)
