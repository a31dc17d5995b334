"""Synthetic instance generators (port of ``repro.graphs.generators``).

Numpy code kept identical to the reference, so the same seed gives
bit-identical weights: K<N> is the complete graph with uniform ±1 couplings
(the paper's K2000, §V-A2), er<N> the G(n, m) Erdős–Rényi family, sw<N>
the Watts–Strogatz small world, torus<side> the 2-D periodic grid,
:func:`ground_state_planted_grid` a torus with a known optimum,
:func:`sparse_bipolar_edges` the G(n, m) family as an edge list,
dense-J-free, and :func:`torus_grid_edges` the torus as an edge list. These
are the Gset topology families (Table I); the Gset files themselves are
read by :mod:`repro_torch.graphs.gset`.
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


def small_world(n: int, k: int, rewire_p: float = 0.1, seed: int = 0,
                signed: bool = True, name: str = "sw") -> MaxCutInstance:
    """Watts–Strogatz ring lattice with rewiring (G18/G64 family)."""
    rng = _rng(seed)
    mask = np.zeros((n, n), np.float32)
    for d in range(1, k // 2 + 1):
        idx = np.arange(n)
        mask[idx, (idx + d) % n] = 1.0
    # Rewire each lattice edge with probability rewire_p.
    edges = np.argwhere(mask > 0)
    for (i, j) in edges:
        if rng.random() < rewire_p:
            mask[i, j] = 0.0
            tgt = int(rng.integers(n))
            while tgt == i:
                tgt = int(rng.integers(n))
            a, b = min(i, tgt), max(i, tgt)
            mask[a, b] = 1.0
    mask = np.triu(mask + mask.T, 1)
    mask = ((mask + mask.T) > 0).astype(np.float32)
    w = (_signed_weights(rng, mask) if signed
         else np.triu(mask, 1) + np.triu(mask, 1).T)
    return MaxCutInstance(weights=w, name=name)


def torus_grid(rows: int, cols: int, seed: int = 0, signed: bool = True,
               name: str = "torus") -> MaxCutInstance:
    """2D torus (periodic grid), the G11/G62 family, as a dense instance."""
    rng = _rng(seed)
    n = rows * cols
    mask = np.zeros((n, n), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for (rr, cc) in (((r + 1) % rows, c), (r, (c + 1) % cols)):
                j = rr * cols + cc
                if i != j:
                    a, b = min(i, j), max(i, j)
                    mask[a, b] = 1.0
    mask = mask + mask.T
    w = (_signed_weights(rng, mask) if signed
         else np.triu(mask, 1) + np.triu(mask, 1).T)
    return MaxCutInstance(weights=w, name=name)


def complete_bipolar(n: int, seed: int = 0, name: str = "K") -> MaxCutInstance:
    """Complete graph with J_ij ∈ {−1,+1} uniform — the paper's K2000."""
    rng = _rng(seed)
    mask = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    w = _signed_weights(rng, mask)
    return MaxCutInstance(weights=w, name=f"{name}{n}")


def sparse_bipolar_edges(n: int, num_edges: int, seed: int = 0):
    """G(n, m) with ±1 weights as a canonical ``core.ising.EdgeList``, with
    no (n, n) array: endpoints are sampled with replacement, deduplicated,
    then signed, so the realized edge count is ≤ ``num_edges``."""
    from ..core.ising import EdgeList

    rng = _rng(seed)
    i = rng.integers(0, n, size=num_edges, dtype=np.int64)
    j = rng.integers(0, n - 1, size=num_edges, dtype=np.int64)
    j = np.where(j >= i, j + 1, j)  # uniform over off-diagonal pairs
    key = np.unique(np.minimum(i, j) * np.int64(n) + np.maximum(i, j))
    w = rng.choice(np.array([-1, 1], np.int64), size=key.size)
    return EdgeList.create(key // n, key % n, w, n)


def torus_grid_edges(rows: int, cols: int, seed: int = 0,
                     signed: bool = True):
    """2D periodic torus (G11/G62 family) as a canonical
    ``core.ising.EdgeList`` — the deterministic known-χ instance for the
    colored execution mode: with both dimensions even the torus is
    bipartite, so ``graphs.coloring.greedy_coloring`` returns exactly two
    color classes of N/2 spins each (the checkerboard), and a colored sweep
    flips O(N/2) spins per step. O(N) edges, no (N, N) mask. Edge weights
    are ±1 drawn from the same PCG64 stream family as the dense generators
    (``signed=False`` gives the uniform ferromagnet, weight +1)."""
    from ..core.ising import EdgeList

    if rows < 3 or cols < 3:
        raise ValueError(f"torus needs rows, cols >= 3, got {rows}x{cols} "
                         "(smaller dims collapse wrap-around edges)")
    rng = _rng(seed)
    n = rows * cols
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // cols, idx % cols
    down = ((r + 1) % rows) * cols + c
    right = r * cols + (c + 1) % cols
    i = np.concatenate([idx, idx])
    j = np.concatenate([down, right])
    w = (rng.choice(np.array([-1, 1], np.int64), size=i.size) if signed
         else np.ones(i.size, np.int64))
    return EdgeList.create(i, j, w, n)


def ground_state_planted_grid(rows: int, cols: int, seed: int = 0,
                              name: str = "planted"):
    """Ferromagnetic torus with a planted bipartition (known optimum):
    ``(instance with best_known, planted ±1 spins)``."""
    from .maxcut import cut_value

    rng = _rng(seed)
    inst = torus_grid(rows, cols, seed=seed, signed=False, name=name)
    planted = rng.choice(np.array([-1, 1], np.int8), size=rows * cols)
    # Gauge transform w_ij = -w0_ij p_i p_j: H(s) = -Σ w0 (p⊙s)_i (p⊙s)_j is
    # minimized exactly at s = ±p, so the max cut is attained at the plant.
    w = (-inst.weights * np.outer(planted, planted)).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    planted_inst = MaxCutInstance(weights=w, name=name)
    best = float(cut_value(planted_inst, planted))
    return MaxCutInstance(weights=w, name=name, best_known=best), planted
