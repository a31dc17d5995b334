"""Other NP-hard encodings from the paper's motivation (§II-A, Lucas).
Port of ``repro.graphs.partitioning``.

* Balanced graph partitioning (min-cut with a balance penalty), the engine
  behind ``core.placement``.
* Number partitioning: split {a_i} into two sets with equal sums;
  H = (Σ a_i s_i)² ⇒ J_ij = −2 a_i a_j, ground energy −Σa² iff a perfect
  partition exists.
"""
from __future__ import annotations

import numpy as np

from ..core.ising import IsingProblem


def graph_partitioning_to_ising(weights: np.ndarray, balance_weight: float,
                                device=None) -> IsingProblem:
    """min Σ_{i<j} w_ij [s_i≠s_j] + λ(Σ s_i)² as an Ising instance."""
    w = np.asarray(weights, np.float64)
    n = w.shape[0]
    J = w / 2.0 - 2.0 * balance_weight
    np.fill_diagonal(J, 0.0)
    # cut = Σ w/2 − Σ_{i<j} (w/2) s_i s_j ; balance = λ(n + Σ_{i≠j} s_i s_j)
    offset = np.triu(w, 1).sum() / 2.0 + balance_weight * n
    return IsingProblem.create(J=J.astype(np.float32), offset=float(offset),
                               device=device)


def partition_cost(weights: np.ndarray, spins, balance_weight: float) -> float:
    s = np.asarray(spins, np.float64)
    w = np.asarray(weights, np.float64)
    cut = float(np.triu(w * (s[:, None] != s[None, :]), 1).sum())
    return cut + balance_weight * float(s.sum()) ** 2


def number_partitioning_to_ising(values, device=None) -> IsingProblem:
    """H(s) = (Σ a_i s_i)² − Σ a_i²: J_ij = −2 a_i a_j with offset Σ a_i²,
    so a perfect partition has energy + offset 0."""
    a = np.asarray(values, np.float64)
    J = -2.0 * np.outer(a, a)
    np.fill_diagonal(J, 0.0)
    return IsingProblem.create(J=J.astype(np.float32),
                               offset=float(np.sum(a * a)), device=device)


def partition_residue(values, spins) -> float:
    """|Σ_{S} a − Σ_{S̄} a| for the bipartition induced by spins."""
    a = np.asarray(values, np.float64)
    s = np.asarray(spins, np.float64)
    return abs(float(np.sum(a * s)))
