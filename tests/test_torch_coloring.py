"""The port's conflict-graph coloring against the JAX package's, on the CPU.

``repro_torch.graphs.coloring`` is a numpy copy of ``repro.graphs.coloring``:
on every graph here — tori, Erdős–Rényi graphs, an odd cycle, cliques,
isolated vertices, a dense-J source and the N=16384 colored anchor — its
``colors``, ``perm`` and ``offsets`` are equal to the reference's, element
for element (integers: no tolerance). The invariants of
``tests/test_coloring.py`` (properness, one color-sorted layout, χ = 2 on
even tori, singleton classes on cliques, determinism under edge
permutation, the memo and the error paths) hold for the port too.
"""
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro.core.ising import EdgeList as JEdgeList
from repro.graphs import sparse_bipolar_edges as jsparse
from repro.graphs import torus_grid_edges as jtorus
from repro.graphs.coloring import greedy_coloring as jcoloring
from repro_torch import interop
from repro_torch.core.ising import EdgeList
from repro_torch.graphs import (Coloring, greedy_coloring,
                                sparse_bipolar_edges, torus_grid_edges)


def _er(n, m, seed):
    """The same random edge set in both packages (weights in ±{1, 2})."""
    g = np.random.default_rng(seed)
    i = g.integers(0, n, size=m)
    j = g.integers(0, n, size=m)
    keep = i != j
    w = g.choice([-2, -1, 1, 2], size=m)
    return (JEdgeList.create(i[keep], j[keep], w[keep], n),
            EdgeList.create(i[keep], j[keep], w[keep], n))


def _cycle(n):
    i = np.arange(n)
    return (JEdgeList.create(i, (i + 1) % n, np.ones(n, np.int64), n),
            EdgeList.create(i, (i + 1) % n, np.ones(n, np.int64), n))


def _clique(n):
    iu = np.triu_indices(n, 1)
    w = np.ones(iu[0].size, np.int64)
    return (JEdgeList.create(iu[0], iu[1], w, n),
            EdgeList.create(iu[0], iu[1], w, n))


GRAPHS = {
    "torus8x8": lambda: (jtorus(8, 8, seed=5), torus_grid_edges(8, 8, seed=5)),
    "torus6x8": lambda: (jtorus(6, 8, seed=2), torus_grid_edges(6, 8, seed=2)),
    "torus5x7": lambda: (jtorus(5, 7, seed=1), torus_grid_edges(5, 7, seed=1)),
    "torus128": lambda: (jtorus(128, 128), torus_grid_edges(128, 128)),
    "er96": lambda: (jsparse(96, 400, seed=11),
                     sparse_bipolar_edges(96, 400, seed=11)),
    "er_rand": lambda: _er(60, 240, seed=3),
    "odd_cycle": lambda: _cycle(5),
    "even_cycle": lambda: _cycle(12),
    "clique": lambda: _clique(9),
    "isolated": lambda: (JEdgeList.create([0], [1], [1], 5),
                         EdgeList.create([0], [1], [1], 5)),
    "anchor16384": lambda: (jsparse(16384, 131072, seed=16384),
                            sparse_bipolar_edges(16384, 131072, seed=16384)),
}


def _assert_same(jcol, tcol):
    np.testing.assert_array_equal(np.asarray(jcol.colors), tcol.colors)
    np.testing.assert_array_equal(np.asarray(jcol.perm), tcol.perm)
    np.testing.assert_array_equal(np.asarray(jcol.offsets), tcol.offsets)
    assert tcol.colors.dtype == np.int32 and tcol.perm.dtype == np.int32
    assert tcol.offsets.dtype == np.int64
    assert tcol.num_classes == jcol.num_classes
    assert tcol.max_class_size == jcol.max_class_size
    np.testing.assert_array_equal(tcol.inverse_perm,
                                  np.asarray(jcol.inverse_perm))


def _assert_layout(col):
    n = col.num_spins
    assert sorted(col.perm.tolist()) == list(range(n))
    assert col.inverse_perm[col.perm].tolist() == list(range(n))
    assert col.offsets[0] == 0 and col.offsets[-1] == n
    assert (col.class_sizes > 0).all()
    for c in range(col.num_classes):
        members = col.perm[col.offsets[c]:col.offsets[c + 1]]
        assert (col.colors[members] == c).all()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_coloring_equals_reference(graph):
    jedges, tedges = GRAPHS[graph]()
    np.testing.assert_array_equal(np.asarray(jedges.rows), tedges.rows)
    np.testing.assert_array_equal(np.asarray(jedges.weights), tedges.weights)
    jcol, tcol = jcoloring(jedges), greedy_coloring(tedges)
    _assert_same(jcol, tcol)
    tcol.validate_against(tedges)
    _assert_layout(tcol)


def test_anchor_classes():
    """The slice's instance: χ = 11, the largest class 2932 spins."""
    _, tedges = GRAPHS["anchor16384"]()
    col = greedy_coloring(tedges)
    assert tedges.nnz == 131_019
    assert col.num_classes == 11 and col.max_class_size == 2932
    assert col.class_sizes.tolist() == [2932, 2682, 2502, 2244, 1988, 1622,
                                        1234, 791, 331, 57, 1]


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_dense_source_equals_reference_and_edge_list(source):
    jedges, tedges = _er(24, 60, seed=9)
    J = tedges.to_dense()
    dense = torch.from_numpy(J) if source == "tensor" else J
    tcol = greedy_coloring(dense)
    _assert_same(jcoloring(np.asarray(jedges.to_dense())), tcol)
    assert tcol == greedy_coloring(tedges)


@given(st.integers(min_value=2, max_value=40),
       st.integers(min_value=0, max_value=160),
       st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_random_graphs_equal_reference_and_proper(n, m, seed):
    jedges, tedges = _er(n, m, seed)
    tcol = greedy_coloring(tedges)
    _assert_same(jcoloring(jedges), tcol)
    tcol.validate_against(tedges)
    assert (tcol.colors[tedges.rows] != tcol.colors[tedges.cols]).all()
    _assert_layout(tcol)


@given(st.integers(min_value=3, max_value=30),
       st.integers(min_value=1, max_value=120),
       st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_deterministic_under_edge_permutation(n, m, seed):
    _, edges = _er(n, m, seed)
    g = np.random.default_rng(seed + 1)
    p = g.permutation(edges.rows.size)
    flip = g.random(edges.rows.size) < 0.5
    i = np.where(flip, edges.cols, edges.rows)[p]
    j = np.where(flip, edges.rows, edges.cols)[p]
    shuffled = EdgeList.create(i, j, edges.weights[p], n)
    assert shuffled == edges
    a, b = greedy_coloring(edges), greedy_coloring(shuffled)
    assert a == b and hash(a) == hash(b)
    np.testing.assert_array_equal(a.perm, b.perm)


@pytest.mark.parametrize("half_rows,half_cols", [(2, 2), (3, 4), (8, 5)])
def test_even_torus_is_two_colored(half_rows, half_cols):
    rows, cols = 2 * half_rows, 2 * half_cols
    col = greedy_coloring(torus_grid_edges(rows, cols, seed=rows + cols))
    assert col.class_sizes.tolist() == [rows * cols // 2] * 2


def test_clique_and_odd_cycle():
    col = greedy_coloring(_clique(7)[1])
    assert col.class_sizes.tolist() == [1] * 7 and col.max_class_size == 1
    assert greedy_coloring(_cycle(5)[1]).num_classes == 3


def test_isolated_vertices_take_color_zero():
    col = greedy_coloring(EdgeList.create([0], [1], [1], 5))
    assert col.num_classes == 2 and (col.colors[2:] == 0).all()


def test_memoized_per_edge_list_digest():
    _, edges = _er(16, 30, seed=4)
    same = EdgeList.create(edges.rows, edges.cols, edges.weights, 16)
    assert greedy_coloring(edges) is greedy_coloring(same)
    _, other = _er(16, 30, seed=5)
    assert greedy_coloring(other) != greedy_coloring(edges)


def test_errors():
    _, edges = _er(8, 10, seed=0)
    with pytest.raises(ValueError, match="num_spins"):
        greedy_coloring(edges, num_spins=9)
    with pytest.raises(ValueError, match="square"):
        greedy_coloring(np.zeros((3, 4)))
    col = greedy_coloring(edges)
    bad = Coloring(colors=np.zeros(8, np.int32), perm=col.perm,
                   offsets=col.offsets, num_spins=8)
    with pytest.raises(AssertionError, match="joins"):
        bad.validate_against(edges)


def test_interop_carries_the_reference_coloring():
    jedges, tedges = GRAPHS["er96"]()
    jcol = jcoloring(jedges)
    col = interop.coloring_from_numpy(jcol.colors, jcol.perm, jcol.offsets,
                                      jcol.num_spins)
    assert col == greedy_coloring(tedges)
    _assert_same(jcol, col)
