"""Gset benchmark file format parser (paper §V-A2). Port of
``repro.graphs.gset``.

Format: first line ``|V| |E|``; then one line per edge ``i j w`` (1-indexed).
:data:`GSET_SAMPLE` is a 10-vertex signed graph in exact Gset syntax; point
:func:`parse_gset` or :func:`parse_gset_edges` at a Gset file (G1–G81) to
solve the original instances.
"""
from __future__ import annotations

import io

import numpy as np

from .maxcut import MaxCutInstance

GSET_SAMPLE = """10 14
1 2 1
1 3 -1
2 4 1
3 4 1
4 5 -1
5 6 1
6 7 1
6 8 -1
7 9 1
8 9 1
8 10 -1
9 10 1
2 7 1
3 8 -1
"""


def _open(source):
    if isinstance(source, str) and "\n" in source:
        return io.StringIO(source)
    if hasattr(source, "read"):
        return source
    return open(source)


def parse_gset(source, name: str = "gset") -> MaxCutInstance:
    """Parse a Gset file from a path, file object, or literal string into a
    dense weight matrix (for large instances use :func:`parse_gset_edges`,
    which never makes the (N, N) array)."""
    fh = _open(source)
    try:
        header = fh.readline().split()
        n, m = int(header[0]), int(header[1])
        w = np.zeros((n, n), np.float32)
        count = 0
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            i, j, wt = int(parts[0]) - 1, int(parts[1]) - 1, float(parts[2])
            w[i, j] = wt
            w[j, i] = wt
            count += 1
        if count != m:
            raise ValueError(f"Gset header declared {m} edges, file had {count}")
        return MaxCutInstance(weights=w, name=name)
    finally:
        fh.close()


def parse_gset_edges(source):
    """Dense-J-free Gset parser: the same format as :func:`parse_gset`,
    returned as a canonical ``core.ising.EdgeList`` of the edge weights w
    in O(nnz) memory; ``graphs.maxcut.maxcut_edges_to_ising`` makes the
    J = −w problem the plane tiers consume.

    A file listing the same undirected edge twice (either orientation) is
    refused: ``EdgeList`` sums duplicates where the dense parser keeps the
    last, so the two parsers would describe different instances."""
    from ..core.ising import EdgeList

    fh = _open(source)
    try:
        header = fh.readline().split()
        n, m = int(header[0]), int(header[1])
        rows, cols, weights = [], [], []
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            rows.append(int(parts[0]) - 1)
            cols.append(int(parts[1]) - 1)
            weights.append(float(parts[2]))
        if len(rows) != m:
            raise ValueError(
                f"Gset header declared {m} edges, file had {len(rows)}")
        edges = EdgeList.create(np.asarray(rows), np.asarray(cols),
                                np.asarray(weights), n)
        if edges.nnz != len(rows):
            raise ValueError(
                f"Gset file lists {len(rows)} edges but only {edges.nnz} "
                "distinct undirected pairs survive coalescing — duplicate "
                "edge lines are malformed (the dense parser would keep the "
                "last, the edge-list path would sum them)")
        return edges
    finally:
        fh.close()

