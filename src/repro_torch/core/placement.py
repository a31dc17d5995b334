"""Ising-based balanced graph partitioning for device placement (paper
§II-A). Port of ``repro.core.placement``.

Given a symmetric traffic matrix ``C`` (bytes exchanged between experts
placed on *different* devices), a balanced D-way partition minimizing
cross-device traffic is found by recursive bisection, each bisection solved
by the annealed solver:

    minimize  Σ_{i<j} C_ij · [s_i ≠ s_j]  +  λ (Σ_i m_i s_i)²

Ising form: J_ij = C_ij/2 − λ m_i m_j, h = 0 for equal loads m ≡ 1. The
bisections run the port's ``solve``, whose default backend is "fused" (the
JAX package's is "reference"), so an assignment is the port's own, held by
its invariants and cut, not bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import solver as solver_lib
from .ising import IsingProblem
from .schedules import geometric


@dataclasses.dataclass(frozen=True)
class PlacementResult:
    assignment: np.ndarray      # (E,) int device index in [0, D)
    cut_bytes: float            # total cross-device traffic
    imbalance: float            # max device load / mean load − 1
    num_devices: int


def _bisect(C: np.ndarray, loads: np.ndarray, balance_weight: float, seed: int,
            steps: int, replicas: int, device=None) -> np.ndarray:
    n = C.shape[0]
    if n == 1:
        return np.array([1], np.int8)
    scale = max(float(np.abs(C).max()), 1e-9)
    lam = balance_weight * scale
    m = loads / max(loads.mean(), 1e-9)
    J = C / 2.0 - lam * np.outer(m, m)
    np.fill_diagonal(J, 0.0)
    problem = IsingProblem.create(J=J.astype(np.float32))
    t0 = max(float(np.abs(J).sum(1).max()), 1.0)
    cfg = solver_lib.SolverConfig(
        num_steps=steps, schedule=geometric(t0, t0 * 1e-3, steps), mode="rwa",
        num_replicas=replicas, use_pwl=True)
    result = solver_lib.solve(problem, seed, cfg, device=device)
    best = int(result.best_energy.argmin())
    return result.best_spins[best].cpu().numpy()


def cut_bytes(C: np.ndarray, assignment: np.ndarray) -> float:
    a = np.asarray(assignment)
    mask = a[:, None] != a[None, :]
    return float(np.triu(np.asarray(C) * mask, 1).sum())


def place(C: np.ndarray, num_devices: int, loads: np.ndarray | None = None,
          balance_weight: float = 0.75, seed: int = 0, steps: int = 2000,
          replicas: int = 8, device=None) -> PlacementResult:
    """Recursive-bisection D-way placement (D must be a power of two).
    ``device`` as in :func:`repro_torch.device.resolve_device`."""
    C = np.asarray(C, np.float64)
    n = C.shape[0]
    if num_devices & (num_devices - 1):
        raise ValueError("num_devices must be a power of two (recursive bisection)")
    if loads is None:
        loads = np.ones(n)
    assignment = np.zeros(n, np.int64)
    groups = [np.arange(n)]
    level = 0
    while len(groups) < num_devices:
        next_groups = []
        for g, idx in enumerate(groups):
            spins = _bisect(C[np.ix_(idx, idx)], loads[idx], balance_weight,
                            seed + 1000 * level + g, steps, replicas, device)
            left = idx[spins > 0]
            right = idx[spins < 0]
            if left.size == 0 or right.size == 0:  # degenerate balance: split evenly
                half = idx.size // 2
                left, right = idx[:half], idx[half:]
            next_groups.extend([left, right])
        groups = next_groups
        level += 1
    for d, idx in enumerate(groups):
        assignment[idx] = d
    device_loads = np.array([loads[assignment == d].sum() for d in range(num_devices)])
    imb = float(device_loads.max() / max(device_loads.mean(), 1e-9) - 1.0)
    return PlacementResult(assignment=assignment, cut_bytes=cut_bytes(C, assignment),
                           imbalance=imb, num_devices=num_devices)


def expert_traffic_matrix(router_probs: np.ndarray) -> np.ndarray:
    """Co-activation traffic proxy from router probabilities (T, E): experts
    co-selected for the same token exchange activations during combine."""
    p = np.asarray(router_probs, np.float64)
    C = p.T @ p
    np.fill_diagonal(C, 0.0)
    return C
