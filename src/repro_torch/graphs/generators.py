"""Synthetic instance generators (port of ``repro.graphs.generators``).

Numpy code kept identical to the reference, so the same seed gives
bit-identical weights: K<N> is the complete graph with uniform ±1 couplings
(the paper's K2000, §V-A2) and er<N> the G(n, m) Erdős–Rényi family.
"""
from __future__ import annotations

import numpy as np

from .maxcut import MaxCutInstance


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed))


def _signed_weights(rng: np.random.Generator, mask: np.ndarray) -> np.ndarray:
    """Uniform ±1 weights on the upper-triangular edge mask, symmetrized."""
    n = mask.shape[0]
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), size=(n, n))
    w = np.triu(mask, 1) * signs
    return (w + w.T).astype(np.float32)


def erdos_renyi(n: int, num_edges: int, seed: int = 0, signed: bool = True,
                name: str = "er") -> MaxCutInstance:
    """G(n, m): exactly ``num_edges`` uniform random edges (G6/G61 family)."""
    rng = _rng(seed)
    iu = np.triu_indices(n, 1)
    total = iu[0].size
    pick = rng.choice(total, size=min(num_edges, total), replace=False)
    mask = np.zeros((n, n), np.float32)
    mask[iu[0][pick], iu[1][pick]] = 1.0
    mask = mask + mask.T
    w = (_signed_weights(rng, mask) if signed
         else (np.triu(mask, 1) + np.triu(mask, 1).T))
    return MaxCutInstance(weights=w, name=name)


def complete_bipolar(n: int, seed: int = 0, name: str = "K") -> MaxCutInstance:
    """Complete graph with J_ij ∈ {−1,+1} uniform — the paper's K2000."""
    rng = _rng(seed)
    mask = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    w = _signed_weights(rng, mask)
    return MaxCutInstance(weights=w, name=f"{name}{n}")
