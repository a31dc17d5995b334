"""QUBO ↔ Ising conversions (paper §II-B). Port of ``repro.graphs.qubo``.

QUBO: minimize xᵀQx over x ∈ {0,1}ⁿ. With x = (s+1)/2 and S = (Q + Qᵀ)/2:
J_ij = −S_ij/2 (i≠j), h_i = −(Σ_{j≠i} S_ij + S_ii)/2 and offset =
Σ_{i≠j} S_ij/4 + Σ_i S_ii/2, so that qubo(x) == H(s) + offset.
"""
from __future__ import annotations

import numpy as np

from ..core.ising import IsingProblem


def qubo_to_ising(Q: np.ndarray, device=None) -> IsingProblem:
    Q = np.asarray(Q, np.float64)
    S = (Q + Q.T) / 2.0  # symmetrized; diagonal handled separately
    off_diag = S - np.diag(np.diag(S))
    # x_i x_j = (1 + s_i + s_j + s_i s_j)/4 for i≠j ; x_i^2 = x_i = (1+s_i)/2.
    J = -off_diag / 2.0  # pair term: Σ_{i<j} (S_ij/2) s_i s_j = -Σ J_ij s_i s_j
    h = -(off_diag.sum(axis=1) + np.diag(S)) / 2.0
    offset = off_diag.sum() / 4.0 + np.diag(S).sum() / 2.0
    np.fill_diagonal(J, 0.0)
    return IsingProblem.create(J=J.astype(np.float32), h=h.astype(np.float32),
                               offset=float(offset), device=device)


def ising_to_qubo(problem: IsingProblem) -> tuple[np.ndarray, float]:
    """Inverse map: ``(Q, offset)`` with xᵀQx + offset == H(s) +
    problem.offset."""
    J = problem.couplings.detach().cpu().numpy().astype(np.float64)
    h = problem.fields.detach().cpu().numpy().astype(np.float64)
    # s = 2x − 1: −Σ_{i<j} J_ij s_i s_j − Σ h_i s_i
    #   = −Σ_{i<j} J_ij (4 x_i x_j − 2x_i − 2x_j + 1) − Σ h_i (2x_i − 1)
    Q = -2.0 * J  # off-diagonal: −4 J_ij/2 per unordered pair split symmetrically
    lin = 2.0 * J.sum(axis=1) - 2.0 * h
    Q = Q + np.diag(lin)
    offset = -J[np.triu_indices_from(J, 1)].sum() + h.sum()
    return Q, float(offset + problem.offset)


def qubo_energy(Q: np.ndarray, x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    return float(x @ np.asarray(Q, np.float64) @ x)
