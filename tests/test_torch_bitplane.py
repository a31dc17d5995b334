"""The port's bit-plane store, edge lists and popcount init against the JAX
package, on the CPU.

* Bit-equal: the plane words of ``encode_couplings``, ``encode_edges`` and
  ``edge_plane_words`` (B ∈ {1, 2, 5}, ``align_words`` ∈ {1, 128}, signed J,
  N not a multiple of 32), ``decode_couplings`` round trips, ``pack_spins``,
  ``EdgeList``'s canonical COO and content digest, and the decoded rows of
  ``decode_bitplane_rows``.
* Exact (integers in f32, compared with ``assert_array_equal``):
  ``local_fields_from_planes`` and the plain ``bitplane_field_init`` against
  ``repro.kernels.ref.bitplane_field_init`` and the Pallas kernel in
  interpret mode.
* ``coalesce_rows``: all four outputs equal JAX's, on random and on
  duplicate-heavy site vectors (hypothesis).

The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.core import bitplane as jbit
from repro.core import ising as jising
from repro.graphs import generators as jgen
from repro.kernels import bitplane_field as jfield
from repro.kernels import common as jcommon
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import bitplane as tbit
from repro_torch.core import ising as tising
from repro_torch.graphs import generators as tgen
from repro_torch.kernels import bitplane_field, common, ops, ref


def _signed_j(n, num_planes, seed):
    """Symmetric zero-diagonal integer J using all 2^B − 1 magnitudes."""
    g = np.random.default_rng(seed)
    lim = (1 << num_planes) - 1
    J = np.triu(g.integers(-lim, lim + 1, size=(n, n)), 1)
    return (J + J.T).astype(np.float32)


def _assert_planes_equal(jplanes, tplanes):
    pos, neg = tplanes.to_numpy()
    np.testing.assert_array_equal(np.asarray(jplanes.pos), pos)
    np.testing.assert_array_equal(np.asarray(jplanes.neg), neg)
    assert tplanes.num_spins == jplanes.num_spins
    assert tplanes.nbytes == jplanes.nbytes
    assert tplanes.pos.dtype == torch.int32


def _spins(r, n, seed):
    g = np.random.default_rng(seed)
    return np.where(g.random((r, n)) < 0.5, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("n", [45, 70])
@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("num_planes", [1, 2, 5])
def test_plane_words_bit_equal(num_planes, align, n):
    J = _signed_j(n, num_planes, seed=n + num_planes)
    tplanes = tbit.encode_couplings(J, num_planes, align)
    _assert_planes_equal(jbit.encode_couplings(J, num_planes, align), tplanes)
    tedges = tising.EdgeList.from_dense(J)
    _assert_planes_equal(jbit.encode_edges(jising.EdgeList.from_dense(J),
                                           num_planes, align),
                         tbit.encode_edges(tedges, num_planes, align))
    from_edges = tbit.encode_edges(tedges, num_planes, align)
    assert torch.equal(tplanes.pos, from_edges.pos)
    assert torch.equal(tplanes.neg, from_edges.neg)
    for rows in ((0, n), (7, 31), (n - 3, n)):
        jp, jn = jbit.edge_plane_words(jising.EdgeList.from_dense(J),
                                       num_planes, align, row_range=rows)
        tp, tn = tbit.edge_plane_words(tedges, num_planes, align,
                                       row_range=rows)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jn, tn)
    np.testing.assert_array_equal(tbit.decode_couplings(tplanes),
                                  J.astype(np.int64))
    np.testing.assert_array_equal(
        tbit.decode_couplings(tplanes),
        jbit.decode_couplings(jbit.encode_couplings(J, num_planes, align)))


def test_encoders_refuse_what_the_reference_refuses():
    J = _signed_j(12, 2, seed=0)
    for bad, match in ((J, "more than 1 planes"),
                       (J + 0.5 * (J != 0), "integer"),
                       (np.triu(J), "symmetric")):
        for enc in (jbit.encode_couplings, tbit.encode_couplings):
            with pytest.raises(ValueError, match=match):
                enc(bad, 1)
    with pytest.raises(ValueError, match="align_words"):
        tbit.encode_couplings(J, 2, align_words=0)
    diag = J.copy()
    diag[0, 0] = 1.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tbit.encode_couplings(diag, 2)
    assert any("diagonal" in str(w.message) for w in caught)
    edges = tising.EdgeList.from_dense(J)
    with pytest.raises(ValueError, match="edge #"):
        tbit.edge_plane_words(edges, 1)
    with pytest.raises(ValueError, match="row_range"):
        tbit.edge_plane_words(edges, 2, row_range=(5, 2))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float32])
def test_pack_spins_bit_equal(dtype):
    s = _spins(5, 70, seed=3)
    want = np.asarray(jbit.pack_spins(jnp.asarray(s)))
    got = tbit.pack_spins(torch.from_numpy(s).to(dtype))
    np.testing.assert_array_equal(want, got.numpy().view(np.uint32))
    padded = tbit.pack_spins(torch.from_numpy(s), num_words=8)
    np.testing.assert_array_equal(
        np.asarray(jbit.pack_spins(jnp.asarray(s), 8)),
        padded.numpy().view(np.uint32))
    assert bool((padded[:, 3:] == 0).all())
    with pytest.raises(ValueError, match="num_words"):
        tbit.pack_spins(torch.from_numpy(s), num_words=2)


def test_edge_list_canonical_coo_and_digest_equal_the_reference():
    g = np.random.default_rng(5)
    n = 40
    rows = g.integers(0, n, size=300)
    cols = g.integers(0, n, size=300)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    w = g.integers(-3, 4, size=rows.size)
    jedges = jising.EdgeList.create(rows, cols, w, n)
    tedges = interop.edges_from_numpy(rows, cols, w, n)
    for name in ("rows", "cols", "weights"):
        a, b = getattr(jedges, name), getattr(tedges, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tedges.nnz == jedges.nnz and tedges.nbytes == jedges.nbytes
    assert tedges.max_abs_weight == jedges.max_abs_weight
    assert tedges._digest == jedges._digest
    np.testing.assert_array_equal(tedges.to_dense(), jedges.to_dense())
    np.testing.assert_array_equal(tedges.negated().weights, -tedges.weights)
    # Content identity: the same edges in another order and direction are
    # equal; another weight or size is not.
    perm = g.permutation(rows.size)
    same = tising.EdgeList.create(cols[perm], rows[perm], w[perm], n)
    assert same == tedges and hash(same) == hash(tedges)
    assert tising.EdgeList.create(rows, cols, w + 7, n) != tedges
    assert tising.EdgeList.create(rows, cols, w, n + 1) != tedges
    assert tising.EdgeList.from_dense(tedges.to_dense()) == tedges


@pytest.mark.parametrize("bad,match", [
    (dict(rows=[0, 1], cols=[1, 1], weights=[1, 1]), "self-loop"),
    (dict(rows=[0], cols=[1], weights=[0.5]), "integer"),
    (dict(rows=[0], cols=[1], weights=[np.inf]), "finite"),
    (dict(rows=[0], cols=[9], weights=[1]), "out of range"),
])
def test_edge_list_refuses_what_the_reference_refuses(bad, match):
    for cls in (jising.EdgeList, tising.EdgeList):
        with pytest.raises(ValueError, match=match):
            cls.create(bad["rows"], bad["cols"], bad["weights"], 4)


def test_sparse_generator_equals_the_reference():
    for n, m, seed in ((300, 2400, 1), (1000, 8000, 1000)):
        a = jgen.sparse_bipolar_edges(n, m, seed=seed)
        b = tgen.sparse_bipolar_edges(n, m, seed=seed)
        assert a._digest == b._digest and b.nnz <= m
        assert set(np.unique(b.weights).tolist()) <= {-1, 1}


@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("num_planes", [1, 3])
def test_popcount_fields_exact_against_reference_and_pallas(num_planes,
                                                            align):
    n, r = 96, 8
    J = _signed_j(n, num_planes, seed=11 + num_planes)
    s = _spins(r, n, seed=12)
    jplanes = jbit.encode_couplings(J, num_planes, align)
    tplanes = tbit.encode_couplings(J, num_planes, align)
    words = jbit.pack_spins(jnp.asarray(s), jplanes.num_words)
    want_ref = np.asarray(jref.bitplane_field_init(jplanes.pos, jplanes.neg,
                                                   words, n))
    want_kernel = np.asarray(jfield.bitplane_field_init(
        jplanes.pos, jplanes.neg, words, block_r=4, block_n=32,
        interpret=True))
    want_oracle = np.asarray(jbit.local_fields_from_planes(jplanes,
                                                           jnp.asarray(s)))
    st_ = torch.from_numpy(s)
    twords = tbit.pack_spins(st_, tplanes.num_words)
    got_ref = ref.bitplane_field_init(tplanes.pos, tplanes.neg, twords)
    got_wrapper = bitplane_field.bitplane_field_init(tplanes.pos, tplanes.neg,
                                                     twords)
    got_ops = ops.bitplane_field_init(tplanes, st_)
    got_oracle = tbit.local_fields_from_planes(tplanes, st_)
    for want in (want_ref, want_kernel, want_oracle, s @ J.T):
        for got in (got_ref, got_wrapper, got_ops, got_oracle):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(want, got.numpy())


def test_plane_fields_take_any_leading_shape():
    J = _signed_j(40, 2, seed=2)
    planes = tbit.encode_couplings(J, 2)
    s = _spins(6, 40, seed=4)
    one = tbit.local_fields_from_planes(planes, torch.from_numpy(s[0]))
    many = tbit.local_fields_from_planes(
        planes, torch.from_numpy(s.reshape(2, 3, 40)))
    assert one.shape == (40,) and many.shape == (2, 3, 40)
    np.testing.assert_array_equal(many.reshape(6, 40).numpy(), s @ J.T)
    np.testing.assert_array_equal(one.numpy(), s[0] @ J.T)


@pytest.mark.parametrize("num_planes", [1, 2, 5])
def test_decoded_rows_bit_equal(num_planes):
    n = 70
    J = _signed_j(n, num_planes, seed=21)
    jplanes = jbit.encode_couplings(J, num_planes, 128)
    tplanes = tbit.encode_couplings(J, num_planes, 128)
    sites = np.array([0, 69, 5, 5, 33], np.int32)
    want = jcommon.decode_bitplane_rows(jnp.take(jplanes.pos, sites, axis=1),
                                        jnp.take(jplanes.neg, sites, axis=1),
                                        n)
    idx = torch.from_numpy(sites).long()
    got = common.decode_bitplane_rows(tplanes.pos[:, idx],
                                      tplanes.neg[:, idx], n)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(got.numpy(), J[sites])


def _coalesce_equal(sites):
    j = np.asarray(sites, np.int32)
    want = [np.asarray(x) for x in jcommon.coalesce_rows(jnp.asarray(j))]
    got = common.coalesce_rows(torch.from_numpy(j))
    for name, a, b in zip(("nu", "usite", "uo", "fetched"), want, got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    assert int(got[3].sum()) == int(got[0])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 10_000), min_size=1, max_size=16))
def test_coalesce_rows_equal_on_random_sites(sites):
    _coalesce_equal(sites)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 2), min_size=1, max_size=16))
def test_coalesce_rows_equal_on_duplicate_heavy_sites(sites):
    _coalesce_equal(sites)


def test_rows_fetched_step_groups_replicas():
    j = torch.tensor([4, 4, 1, 2, 4, 2, 2, 9], dtype=torch.int32)
    assert common.rows_fetched_step(j, 8, True).tolist() == \
        [1, 0, 1, 1, 0, 0, 0, 1]
    assert common.rows_fetched_step(j, 4, True).tolist() == \
        [1, 0, 1, 1, 1, 1, 0, 1]
    assert common.rows_fetched_step(j, 8, False).tolist() == [1] * 8
