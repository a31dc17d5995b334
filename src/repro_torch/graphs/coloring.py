"""Conflict-graph coloring for parallel spin updates. Port of
``repro.graphs.coloring`` (numpy, kept identical so the colors, the
permutation and the class offsets are bit-equal to the reference's).

Two spins that share no coupling have independent flip energetics: flipping
one cannot change the other's local field, so an entire *color class* of the
conflict graph (the coupling graph itself — vertices are spins, edges are
nonzero couplings) can be updated simultaneously with exact Gibbs semantics
(Aadit et al., arXiv:2110.02481). The colored execution mode
(``SolverConfig(flip_mode="colored")``) schedules one class per kernel step,
scaling the paper's asynchronous updates from 1 to O(N/χ) flips per step on
sparse instances.

This module is the host-side ingest pass: pure numpy over the canonical COO
edges (dense-J-free — the (N, N) matrix is never formed for ``EdgeList``
inputs), deterministic, and cheap (O(N + nnz)). The resulting
:class:`Coloring` is content-hashed like ``core.ising.EdgeList`` so it can
key caches, and :func:`greedy_coloring` memoizes per edge-list digest so
repeated solves of one instance pay the pass once.

Algorithm: a BFS proper 2-coloring is attempted first (components scanned in
vertex-id order), so every bipartite conflict graph — torus/grid lattices,
trees, even cycles — gets the optimal χ = 2 regardless of what a greedy
vertex order would produce. Non-bipartite graphs fall back to greedy
smallest-available-color in vertex-id order (χ ≤ maxdeg + 1; a dense clique
degenerates to N singleton classes, i.e. colored mode gracefully collapses
to single-flip work per step). Determinism under edge *permutation* is
inherited from ``EdgeList.create``'s canonical ordering: the algorithm only
consumes the adjacency structure, which is permutation-invariant.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Optional, Union

import numpy as np
import torch

from ..core.ising import EdgeList


@dataclasses.dataclass(frozen=True, eq=False)
class Coloring:
    """A proper coloring of the conflict graph, with the color-sorted layout
    the colored sweep kernel consumes.

    ``colors[i]`` is vertex i's class; ``perm`` is the stable color-sorted
    vertex order (``perm[k]`` = original vertex at permuted slot ``k``), so
    class ``c`` occupies the contiguous permuted range
    ``[offsets[c], offsets[c+1])``. Content-based identity (like
    ``EdgeList``): two colorings of equal content hash/compare equal, so a
    ``Coloring`` can key caches and memo tables.
    """

    colors: np.ndarray    # (N,) int32 proper coloring, classes 0..χ-1
    perm: np.ndarray      # (N,) int32 stable color-sorted vertex order
    offsets: np.ndarray   # (χ+1,) int64 class boundaries in perm order
    num_spins: int

    @property
    def num_classes(self) -> int:
        return int(self.offsets.size - 1)

    @property
    def class_sizes(self) -> np.ndarray:
        """(χ,) int64 members per color class — the per-class size stats
        surfaced by launch/bench summaries (flips/step is bounded by the
        scheduled class's size; the mean size is the O(N/χ) headline)."""
        return np.diff(self.offsets)

    @property
    def max_class_size(self) -> int:
        return int(self.class_sizes.max(initial=0))

    @cached_property
    def inverse_perm(self) -> np.ndarray:
        """(N,) int32 with ``inverse_perm[perm[k]] = k`` — maps permuted
        spin vectors back to original vertex order."""
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.perm.size, dtype=self.perm.dtype)
        return inv

    def validate_against(self, edges: EdgeList) -> None:
        """Assert the proper-coloring invariant: no edge joins same-color
        endpoints (the exactness precondition of parallel class updates)."""
        bad = self.colors[edges.rows] == self.colors[edges.cols]
        if bad.any():
            k = int(np.flatnonzero(bad)[0])
            raise AssertionError(
                f"edge ({int(edges.rows[k])}, {int(edges.cols[k])}) joins "
                f"two color-{int(self.colors[edges.rows[k]])} vertices")

    @cached_property
    def _digest(self) -> bytes:
        h = hashlib.sha256()
        h.update(str(self.num_spins).encode())
        h.update(self.colors.tobytes())
        return h.digest()

    def __eq__(self, other) -> bool:
        return (isinstance(other, Coloring)
                and self.num_spins == other.num_spins
                and self._digest == other._digest)

    def __hash__(self) -> int:
        return hash((self.num_spins, self._digest))


def _adjacency(rows: np.ndarray, cols: np.ndarray, n: int):
    """CSR neighbor lists from canonical COO: ``nbrs[starts[v]:starts[v+1]]``
    are v's neighbors, each in ascending order (counting sort over the
    doubled edge set — O(N + nnz), no (N, N) anything)."""
    src = np.concatenate([rows, cols]).astype(np.int64)
    dst = np.concatenate([cols, rows]).astype(np.int64)
    order = np.lexsort((dst, src))
    nbrs = dst[order]
    deg = np.bincount(src, minlength=n)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    return nbrs, starts


def _try_bipartite(nbrs: np.ndarray, starts: np.ndarray,
                   n: int) -> Optional[np.ndarray]:
    """BFS proper 2-coloring in vertex-id component order, or None if any
    odd cycle exists. Isolated vertices take color 0."""
    colors = np.full(n, -1, np.int32)
    for root in range(n):
        if colors[root] >= 0:
            continue
        colors[root] = 0
        frontier = [root]
        while frontier:
            nxt = []
            for v in frontier:
                cv = colors[v]
                for u in nbrs[starts[v]:starts[v + 1]]:
                    if colors[u] < 0:
                        colors[u] = 1 - cv
                        nxt.append(int(u))
                    elif colors[u] == cv:
                        return None
            frontier = nxt
    return colors


def _greedy(nbrs: np.ndarray, starts: np.ndarray, n: int) -> np.ndarray:
    """Smallest-available-color greedy in vertex-id order (χ ≤ maxdeg+1)."""
    colors = np.full(n, -1, np.int32)
    for v in range(n):
        taken = colors[nbrs[starts[v]:starts[v + 1]]]
        taken = set(int(c) for c in taken if c >= 0)
        c = 0
        while c in taken:
            c += 1
        colors[v] = c
    return colors


def _finalize(colors: np.ndarray, n: int) -> Coloring:
    num_classes = int(colors.max(initial=-1)) + 1 if n else 1
    num_classes = max(num_classes, 1)
    perm = np.argsort(colors, kind="stable").astype(np.int32)
    counts = np.bincount(colors, minlength=num_classes).astype(np.int64)
    offsets = np.zeros(num_classes + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Coloring(colors=colors, perm=perm, offsets=offsets, num_spins=n)


_COLORING_MEMO: dict[EdgeList, Coloring] = {}


def greedy_coloring(source: Union[EdgeList, np.ndarray, torch.Tensor],
                    num_spins: Optional[int] = None) -> Coloring:
    """Deterministic proper coloring of the conflict graph of ``source``.

    ``source`` is a canonical :class:`~repro_torch.core.ising.EdgeList` (the
    dense-J-free ingest path — memoized per content digest) or a dense
    symmetric J, numpy or a tensor (read on the host), whose nonzero
    structure defines the edges (tests / small dense problems). Bipartite
    graphs always get χ = 2 (BFS pass); otherwise greedy in vertex order.
    Every class is guaranteed non-empty and classes are numbered
    0..χ-1 in first-use order.
    """
    if isinstance(source, EdgeList):
        cached = _COLORING_MEMO.get(source)
        if cached is not None:
            return cached
        n = source.num_spins
        rows, cols = source.rows, source.cols
    else:
        if isinstance(source, torch.Tensor):
            source = source.detach().cpu().numpy()
        J = np.asarray(source)
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise ValueError(f"dense coloring source must be square, "
                             f"got {J.shape}")
        n = J.shape[0]
        rows, cols = np.nonzero(np.triu(J, 1))
    if num_spins is not None and int(num_spins) != n:
        raise ValueError(f"num_spins={num_spins} != source N={n}")
    nbrs, starts = _adjacency(rows, cols, n)
    colors = _try_bipartite(nbrs, starts, n)
    if colors is None:
        colors = _greedy(nbrs, starts, n)
    out = _finalize(colors, n)
    if isinstance(source, EdgeList):
        _COLORING_MEMO[source] = out
    return out
