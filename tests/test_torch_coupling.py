"""The port's coupling-store registry and its contracts, on the CPU.

* The registry names, the plane alignment and the "auto" decision structure
  equal the JAX package's ``core.coupling`` (its VMEM thresholds replaced by
  the port's, read on the card: both modules are given the same thresholds
  for the comparison); "auto" picks the tiers those readings name.
* Edge lists never resolve to dense and never build an (N, N) array; the
  sharded tiers resolve (served by the sharded driver, past the sweep's
  shared-memory ceiling too, with the JAX package's per-rank byte
  accounting) and the single-device drivers refuse them, naming
  ``solve_sharded``; N past the ceiling raises on the single-device tiers;
  plane tiers reject ``gather="onehot"``.
* ``CouplingStore`` and ``fused_anneal``'s store contract: a prebuilt store
  and a ``coupling=`` override are mutually exclusive, a dense store must
  hold the problem's own couplings tensor, N must match.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coupling as jcoupling
from repro.core import ising as jising
from repro_torch.core import bitplane as tbit
from repro_torch.core import coupling as tcoupling
from repro_torch.core import ising as tising
from repro_torch.core.schedules import linear
from repro_torch.core.solver import SolverConfig
from repro_torch.graphs import (complete_bipolar, maxcut_to_ising,
                                sparse_bipolar_edges)
from repro_torch.kernels import ops, sweep


def _int_j(n, amax, seed):
    g = np.random.default_rng(seed)
    J = np.triu(g.integers(-amax, amax + 1, size=(n, n)), 1)
    return (J + J.T).astype(np.float32)


def _cfg(steps=64, **kw):
    return SolverConfig(num_steps=steps, schedule=linear(4.0, 0.05, steps),
                        mode="rsa", num_replicas=4, **kw)


def test_registry_equals_the_reference():
    assert tuple(tcoupling.FORMATS) == tuple(jcoupling.FORMATS)
    for name, spec in tcoupling.FORMATS.items():
        ref = jcoupling.FORMATS[name]
        assert (spec.packed, spec.align_words, spec.kernel_mode,
                spec.coalescable) == (ref.packed, ref.align_words,
                                      ref.kernel_mode, ref.coalescable)
    for attr in ("COUPLING_FORMATS", "PLANE_FORMATS", "KERNEL_COUPLING_MODES",
                 "KERNEL_PLANE_MODES", "COALESCABLE_FORMATS",
                 "STREAM_ALIGN_WORDS", "DENSE_COUPLING_BITS"):
        assert getattr(tcoupling, attr) == getattr(jcoupling, attr), attr


def test_thresholds_follow_from_l2_and_shared_memory():
    """The thresholds are the card's readings under the rule of the module
    docstring (``scripts/tier_crossover.py``), and a dense J at the dense
    threshold stays within the stated share of device memory."""
    assert tcoupling.DENSE_COUPLING_MAX_N == 32_768
    assert tcoupling.BITPLANE_L2_MAX_N == 6_144
    cap = tcoupling.DENSE_MEMORY_BYTES
    assert cap == tcoupling.DEVICE_MEMORY_BYTES // 16 == 5 * 10 ** 9
    n = tcoupling.DENSE_MEMORY_MAX_N
    assert 4 * n * n <= cap < 4 * (n + 1) ** 2 and n == 35_355
    n = tcoupling.DENSE_COUPLING_MAX_N
    assert n <= tcoupling.DENSE_MEMORY_MAX_N and 4 * n * n <= cap
    n = tcoupling.SWEEP_STATE_MAX_N
    blocks = tcoupling.SWEEP_MAX_BLOCKS
    assert blocks == sweep.MAX_CLUSTER == 8
    assert 12 * n <= blocks * tcoupling.SHARED_MEMORY_BYTES < 12 * (n + 1)
    assert (sweep.MAX_SHARED_BYTES + sweep.STATIC_SHARED_BYTES
            == tcoupling.SHARED_MEMORY_BYTES)
    for rwa in (False, True):
        assert sweep.max_n(rwa) <= tcoupling.SWEEP_STATE_MAX_N


def test_auto_picks_the_tiers_the_readings_name():
    """K4096's integer J stays dense (it went to ``bitplane`` before the
    readings); at N=16,384 an integer dense J stays dense and the edge list
    streams its planes."""
    k4096 = maxcut_to_ising(complete_bipolar(4096, seed=4096)).couplings
    assert tcoupling.resolve_format("auto", k4096, 4096) == "dense"
    n = 16_384
    ones = torch.ones((n, n), dtype=torch.int8)
    ones.fill_diagonal_(0)
    assert tcoupling.resolve_format("auto", ones, n) == "dense"
    del ones
    edges = sparse_bipolar_edges(n, 8 * n, seed=n)
    assert tcoupling.resolve_format("auto", edges, n) == "bitplane_hbm"


@pytest.mark.parametrize("fmt", [None, "auto", "dense", "bitplane",
                                 "bitplane_hbm"])
def test_resolve_format_decision_structure_equals_the_reference(
        monkeypatch, fmt):
    """With both modules given thresholds 16 and 40, every case resolves
    alike: small, mid and large N; integral, fractional and wide J; dense
    matrices and edge lists."""
    monkeypatch.setattr(jcoupling, "DENSE_COUPLING_MAX_N", 16)
    monkeypatch.setattr(jcoupling, "BITPLANE_VMEM_MAX_N", 40)
    monkeypatch.setattr(tcoupling, "DENSE_COUPLING_MAX_N", 16)
    monkeypatch.setattr(tcoupling, "BITPLANE_L2_MAX_N", 40)
    for n in (12, 24, 48):
        for J in (_int_j(n, 3, n), _int_j(n, 3, n) * 0.5,
                  _int_j(n, 1, n) * 70000):
            want = jcoupling.resolve_format(fmt, jnp.asarray(J), n)
            assert tcoupling.resolve_format(fmt, J, n) == want
            assert tcoupling.resolve_format(fmt, torch.from_numpy(J), n) == want
        jedges = jising.EdgeList.from_dense(_int_j(n, 3, n))
        tedges = tising.EdgeList.from_dense(_int_j(n, 3, n))
        if fmt == "dense":
            for resolve, e in ((jcoupling.resolve_format, jedges),
                               (tcoupling.resolve_format, tedges)):
                with pytest.raises(ValueError, match="dense-J-free"):
                    resolve(fmt, e, n)
        else:
            assert (tcoupling.resolve_format(fmt, tedges, n)
                    == jcoupling.resolve_format(fmt, jedges, n))


def test_unserved_tiers_and_past_the_ceiling_raise():
    J = _int_j(64, 2, 0)
    jstore = jcoupling.CouplingStore.build(J, "bitplane_sharded")
    for fmt in ("bitplane_sharded", "bitplane_sharded_2d"):
        assert tcoupling.resolve_format(fmt, J, 64) == fmt
        store = tcoupling.CouplingStore.build(J, fmt)
        assert store.planes.num_words % 128 == 0
        for shards in (1, 2, 4):
            assert store.plane_bytes_per_shard(shards) == \
                jstore.plane_bytes_per_shard(shards)
        for shape in ((4,), (2, 2), (2, 4)):
            assert store.plane_bytes_per_device(shape) == \
                jstore.plane_bytes_per_device(shape)
        with pytest.raises(ValueError, match="cannot shard evenly"):
            store.plane_bytes_per_shard(3)
        # The single-device sweep does not serve them: it names the
        # sharded driver.
        with pytest.raises(ValueError, match="solve_sharded"):
            store.require(tcoupling.KERNEL_COUPLING_MODES, "fused_anneal")
        # "auto" never resolves to them, and the ceiling is not theirs.
        big = tcoupling.SWEEP_STATE_MAX_N + 1
        edges = tising.EdgeList.create([0], [big - 1], [1], big)
        assert tcoupling.resolve_format(fmt, edges, big) == fmt
    with pytest.raises(ValueError, match="no planes"):
        tcoupling.CouplingStore.build(J, "dense").plane_bytes_per_shard(2)
    with pytest.raises(ValueError, match="coupling format"):
        tcoupling.resolve_format("sparse", J, 8)
    big = tcoupling.SWEEP_STATE_MAX_N + 1
    edges = tising.EdgeList.create([0], [big - 1], [1], big)
    for fmt in ("auto", "bitplane", "bitplane_hbm"):
        with pytest.raises(ValueError, match="thread-block cluster"):
            tcoupling.resolve_format(fmt, edges, big)
    edges = tising.EdgeList.create([0], [big - 2], [1], big - 1)
    assert tcoupling.resolve_format("auto", edges, big - 1) == "bitplane_hbm"
    # Past one block's old ceiling of 19,370 spins the tiers are served.
    for n in (19_371, 32_768):
        edges = tising.EdgeList.create([0], [n - 1], [1], n)
        assert tcoupling.resolve_format("bitplane_hbm", edges, n) == \
            "bitplane_hbm"


def test_store_build_and_accessors():
    J = _int_j(50, 3, 1)
    dense = tcoupling.CouplingStore.build(torch.from_numpy(J), "dense")
    assert dense.kernel_operand is dense.dense and dense.planes is None
    assert dense.nbytes == 50 * 50 * 4 and dense.spec.name == "dense"
    for fmt, words in (("bitplane", 2), ("bitplane_hbm", 128)):
        store = tcoupling.CouplingStore.build(J, fmt)
        assert store.kernel_operand is store.planes
        assert store.planes.num_planes == 2
        assert store.planes.num_words == words
        assert store.nbytes == 2 * 2 * 50 * words * 4
        np.testing.assert_array_equal(tbit.decode_couplings(store.planes), J)
        wider = tcoupling.CouplingStore.build(J, fmt, num_planes=4)
        assert wider.planes.num_planes == 4
        jstore = jcoupling.CouplingStore.build(jnp.asarray(J), fmt)
        assert store.nbytes == jstore.nbytes
    planes = tbit.encode_couplings(J, 2)
    wrapped = tcoupling.CouplingStore.from_planes(planes, "bitplane_hbm")
    assert wrapped.planes is planes and wrapped.num_spins == 50
    with pytest.raises(ValueError, match="plane format"):
        tcoupling.CouplingStore.from_planes(planes, "dense")
    assert wrapped.require_num_spins(50, "x") is wrapped
    with pytest.raises(ValueError, match="N=50"):
        wrapped.require_num_spins(51, "x")
    with pytest.raises(ValueError, match="not supported"):
        wrapped.require(("dense",), "x")
    moved = wrapped.to("cpu")
    assert torch.equal(moved.planes.pos, planes.pos)


def test_validate_kernel_operand_contract():
    J = _int_j(40, 1, 2)
    planes = tbit.encode_couplings(J, 1)
    tcoupling.validate_kernel_operand("dense", torch.from_numpy(J), 40)
    tcoupling.validate_kernel_operand("bitplane", planes, 40)
    with pytest.raises(ValueError, match="coupling must be"):
        tcoupling.validate_kernel_operand("bitplane_sharded", planes, 40)
    with pytest.raises(TypeError, match="BitPlanes"):
        tcoupling.validate_kernel_operand("bitplane", torch.from_numpy(J), 40)
    with pytest.raises(ValueError, match="onehot"):
        tcoupling.validate_kernel_operand("bitplane_hbm", planes, 40, "onehot")
    with pytest.raises(ValueError, match="N=40 != state N=41"):
        tcoupling.validate_kernel_operand("bitplane", planes, 41)
    short = tbit.BitPlanes(planes.pos, planes.neg, 70)
    with pytest.raises(ValueError, match="cannot cover"):
        tcoupling.validate_planes_cover(short, 70)
    with pytest.raises(ValueError, match="shape"):
        tcoupling.validate_kernel_operand("dense", torch.zeros(40, 39), 40)


def test_edge_list_build_makes_no_dense_array(monkeypatch):
    n = 4096
    edges = sparse_bipolar_edges(n, 8 * n, seed=n)
    store, stats = tcoupling.timed_build(edges, "auto")
    assert store.fmt == "bitplane" and store.dense is None
    assert store.nbytes <= stats["peak_bytes"] < n * n * 4 // 4
    assert stats["seconds"] > 0
    assert tcoupling.CouplingStore.build(edges, "bitplane_hbm").fmt == \
        "bitplane_hbm"

    def refuse(*_args, **_kwargs):
        raise AssertionError("an (N, N) array was built")

    # The whole plane-fed solve never asks for a dense matrix.
    monkeypatch.setattr(tising.EdgeList, "to_dense", refuse)
    problem = tising.IsingProblem.create_sparse(edges)
    res = ops.fused_anneal(problem, 0, _cfg(32), device="cpu")
    assert res.best_spins.shape == (4, n)
    assert bool(torch.isfinite(res.best_energy).all())


def test_dense_helpers_refuse_edge_list_problems():
    problem = tising.IsingProblem.create_sparse(
        tising.EdgeList.create([0, 1], [1, 2], [1, -1], 3))
    s = torch.ones(3)
    for fn in (tising.energy, tising.local_fields):
        with pytest.raises(ValueError, match="edge-list-backed"):
            fn(problem, s)
    with pytest.raises(ValueError, match="incompatible"):
        tising.IsingProblem.create_sparse(problem.edges, h=np.zeros(4))
    assert problem.coupling_source is problem.edges
    assert problem.to("cpu").couplings is None


def test_brute_force_ground_state_equals_the_reference():
    J = _int_j(10, 2, 3)
    h = np.random.default_rng(4).integers(-1, 2, size=10).astype(np.float32)
    want = jising.brute_force_ground_state(
        jising.IsingProblem.create(J, h, offset=-2.0))
    got = tising.brute_force_ground_state(
        tising.IsingProblem.create(J, h, offset=-2.0))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    with pytest.raises(ValueError, match="N<=24"):
        tising.brute_force_ground_state(
            tising.IsingProblem.create(np.zeros((25, 25), np.float32)))


def test_fused_anneal_store_contract():
    J = _int_j(32, 2, 5)
    problem = tising.IsingProblem.create(J)
    cfg = _cfg()
    store = tcoupling.CouplingStore.build(problem.couplings, "bitplane")
    with pytest.raises(ValueError, match="not both"):
        ops.fused_anneal(problem, 0, cfg, store=store, coupling="bitplane",
                         device="cpu")
    copy = tcoupling.CouplingStore.build(problem.couplings.clone(), "dense")
    with pytest.raises(ValueError, match="couplings tensor"):
        ops.fused_anneal(problem, 0, cfg, store=copy, device="cpu")
    other = tcoupling.CouplingStore.build(_int_j(33, 2, 5), "bitplane")
    with pytest.raises(ValueError, match="N=33"):
        ops.fused_anneal(problem, 0, cfg, store=other, device="cpu")
    own = tcoupling.CouplingStore.build(problem.couplings, "dense")
    via_store = ops.fused_anneal(problem, 0, cfg, store=own, device="cpu")
    via_planes = ops.fused_anneal(problem, 0, cfg, store=store, device="cpu")
    prepacked = ops.fused_anneal(problem, 0, cfg, coupling=store.planes,
                                 device="cpu")
    by_name = ops.fused_anneal(problem, 0, cfg, coupling="bitplane",
                               device="cpu")
    for a, b, c, d in zip(via_store, via_planes, prepacked, by_name):
        assert torch.equal(a, b) and torch.equal(b, c) and torch.equal(c, d)
    with pytest.raises(ValueError, match="onehot"):
        ops.fused_anneal(problem, 0, cfg, coupling="bitplane",
                         gather="onehot", device="cpu")
    with pytest.raises(ValueError, match="solve_sharded"):
        ops.fused_anneal(problem, 0, dataclasses.replace(
            cfg, coupling_format="bitplane_sharded"), device="cpu")
