"""The port's schedules, PWL table, flip probability, roulette helpers,
instances and Ising functions against the JAX package.

Tolerances: ``linear``/``constant`` temperatures, the PWL table, the PWL flip
probability (gather form), instances and energies are bitwise. ``geometric``
is within 2 ulp (``torch.pow`` against XLA's ``pow``; the gap is measured
here). The exact sigmoid is within 4 ulp, values below the smallest normal
f32 (which XLA flushes to zero) counted equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snowball as jsnow
from repro.core import ising as jising
from repro.core import pwl as jpwl
from repro.core import schedules as jsched
from repro.graphs import generators as jgen
from repro.graphs import maxcut as jmaxcut
from repro.kernels import common as jcommon
from repro_torch.configs import snowball as tsnow
from repro_torch.core import coupling as tcoupling
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.core import schedules as tsched
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import maxcut as tmaxcut
from repro_torch.kernels import common as tcommon


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tiny = np.finfo(np.float32).tiny
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float64)
    out = gap / ulp
    out[(np.abs(a) < tiny) & (np.abs(b) < tiny)] = 0.0
    return out


def _temps(sched_j, sched_t, steps):
    t = np.arange(steps, dtype=np.int32)
    want = np.asarray(jax.vmap(sched_j)(jnp.asarray(t))).astype(np.float32)
    got = sched_t(torch.from_numpy(t)).to(torch.float32).numpy()
    return want, got


@pytest.mark.parametrize("kind", ["linear", "constant"])
@pytest.mark.parametrize("t0,t1,steps", [(44.72136, 0.05, 20000),
                                         (8.0, 0.05, 512), (3.0, 0.0, 1)])
def test_linear_and_constant_schedules_bitwise(kind, t0, t1, steps):
    want, got = _temps(jsched.Schedule(kind, t0, t1, steps),
                       tsched.Schedule(kind, t0, t1, steps), steps)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n,steps", [(2000, 20000), (64, 512), (250, 512)])
def test_geometric_schedule_within_two_ulp(n, steps):
    cj = jsnow.default_solver(n, steps)
    ct = tsnow.default_solver(n, steps)
    want, got = _temps(cj.schedule, ct.schedule, steps)
    ulps = _ulps(want, got)
    assert ulps.max() <= 2.0, ulps.max()
    # The gap is real: a few hundred of K2000's 20k temperatures differ.
    if steps == 20000:
        assert 0 < int((ulps > 0).sum()) < steps // 10


def test_cosine_schedule_close():
    """Near the end 1 + cos(π·frac) cancels, so the gap is held to 4 ulp of
    the schedule's scale t0, not of each value."""
    want, got = _temps(jsched.cosine(10.0, 0.1, 300),
                       tsched.cosine(10.0, 0.1, 300), 300)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * float(np.spacing(np.float32(10.0))))


def test_default_solver_config_matches():
    for mode in ("rsa", "rwa"):
        a = dataclasses.asdict(jsnow.default_solver(2000, 20000, mode=mode))
        b = dataclasses.asdict(tsnow.default_solver(2000, 20000, mode=mode))
        assert a == b
    assert (jsnow.K2000.num_vertices, jsnow.K2000.target_cut) == (
        tsnow.K2000.num_vertices, tsnow.K2000.target_cut)


@pytest.mark.parametrize("segs,zmax", [(64, 8.0), (32, 6.0), (17, 5.0)])
def test_pwl_table_bitwise(segs, zmax):
    np.testing.assert_array_equal(np.asarray(jpwl.pwl_table(segs, zmax)),
                                  tpwl.pwl_table(segs, zmax).numpy())


TEMPS = [0.0, -1.0, 0.05, 0.37, 1.0, 2.5, 44.72136, 100.0]
_DE = np.concatenate([np.linspace(-400, 400, 80001),
                      np.arange(-500, 501)]).astype(np.float32)
_flip_jit = jax.jit(lambda d, t, tbl: jcommon.flip_probability(
    d, t, tbl, "gather"))
_sigmoid_jit = jax.jit(lambda d, t: jcommon.flip_probability(d, t, None))


@pytest.mark.parametrize("segs,zmax", [(64, 8.0), (17, 5.0)])
def test_pwl_flip_probability_bitwise_over_dense_grid(segs, zmax):
    """The gather form, as the jitted reference computes it (XLA contracts
    its multiply-adds into FMAs; the port rounds them once too)."""
    tj, tt = jpwl.pwl_table(segs, zmax), tpwl.pwl_table(segs, zmax)
    for t in TEMPS:
        want = np.asarray(_flip_jit(jnp.asarray(_DE), jnp.float32(t), tj))
        got = tcommon.flip_probability(torch.from_numpy(_DE), t, tt).numpy()
        np.testing.assert_array_equal(want, got, err_msg=f"T={t}")


def test_exact_sigmoid_within_four_ulp():
    for t in TEMPS:
        want = np.asarray(_sigmoid_jit(jnp.asarray(_DE), jnp.float32(t)))
        got = tcommon.flip_probability(torch.from_numpy(_DE), t, None).numpy()
        assert _ulps(want, got).max() <= 4.0, t


def test_fma_rounds_once():
    g = np.random.default_rng(0)
    a, b, c = (g.normal(size=200000).astype(np.float32) for _ in range(3))
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = tcommon.fma(*map(torch.from_numpy, (a, b, c))).numpy()
    np.testing.assert_array_equal(want, got)


def test_lane_and_block_helpers():
    for n in (1, 7, 64, 125, 250, 2000, 2003, 4096):
        assert tcommon.default_lane(n) == jcommon.default_lane(n)
        for target in (1, 8, 256, 512):
            assert tcommon.fit_block(n, target) == jcommon.fit_block(n, target)
    assert tcommon.default_lane(2000) == 125


@pytest.mark.parametrize("lane", [8, 125])
def test_roulette_pick_matches_away_from_ties(lane):
    """Bitwise on weights whose partial sums are exact (multiples of 1/64),
    so summation order cannot matter."""
    g = np.random.default_rng(lane)
    n = lane * 4
    p = (g.integers(0, 65, size=(64, n)) / 64.0).astype(np.float32)
    u = g.random(64).astype(np.float32)
    sj, tj, dj = jcommon.roulette_pick(jnp.asarray(p), jnp.asarray(u), lane)
    st, tt, dt = tcommon.roulette_pick(torch.from_numpy(p),
                                       torch.from_numpy(u), lane)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_roulette_degenerate_total():
    p = torch.zeros((2, 250))
    site, total, degenerate = tcommon.roulette_pick(p, torch.tensor([0.3, 0.9]),
                                                    125)
    assert degenerate.all() and (total == 0).all()
    assert ((site >= 0) & (site < 250)).all()


@pytest.mark.parametrize("n,seed", [(64, 0), (250, 3), (2000, 0)])
def test_complete_bipolar_and_maxcut_bitwise(n, seed):
    ij, it = jgen.complete_bipolar(n, seed=seed), tgen.complete_bipolar(n,
                                                                        seed=seed)
    np.testing.assert_array_equal(ij.weights, it.weights)
    assert (ij.name, ij.total_weight, ij.num_edges) == (
        it.name, it.total_weight, it.num_edges)
    pj, pt = jmaxcut.maxcut_to_ising(ij), tmaxcut.maxcut_to_ising(it)
    np.testing.assert_array_equal(np.asarray(pj.couplings),
                                  pt.couplings.numpy())
    np.testing.assert_array_equal(np.asarray(pj.fields), pt.fields.numpy())
    assert pj.offset == pt.offset
    e = np.array([-1234.0, 0.0, 17.0], np.float32)
    np.testing.assert_array_equal(jmaxcut.cut_from_energy(ij, e),
                                  tmaxcut.cut_from_energy(it, e))


@pytest.mark.parametrize("n,m,seed", [(64, 300, 1), (250, 6000, 2)])
def test_erdos_renyi_bitwise(n, m, seed):
    np.testing.assert_array_equal(jgen.erdos_renyi(n, m, seed=seed).weights,
                                  tgen.erdos_renyi(n, m, seed=seed).weights)


def test_ising_functions_bitwise():
    g = np.random.default_rng(5)
    n = 250
    J = np.rint(g.normal(size=(n, n)) * 2)
    J = np.triu(J, 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    s = np.where(g.random((8, n)) < 0.5, 1, -1).astype(np.int8)
    pj = jising.IsingProblem.create(J, h, offset=2.5)
    pt = tising.IsingProblem.create(J, h, offset=2.5)
    sj, st = jnp.asarray(s), torch.from_numpy(s)
    np.testing.assert_array_equal(np.asarray(jising.energy(pj, sj)),
                                  tising.energy(pt, st).numpy())
    uj = jising.local_fields(pj, sj)
    ut = tising.local_fields(pt, st)
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
    np.testing.assert_array_equal(
        np.asarray(jising.energy_from_fields(uj - pj.fields, sj, pj.fields)),
        tising.energy_from_fields(ut - pt.fields, st, pt.fields).numpy())


def test_problem_validation_and_unported_paths_raise():
    with pytest.raises(ValueError, match="symmetric"):
        tising.IsingProblem.create(np.array([[0, 1], [2, 0]], np.float32))
    with pytest.raises(ValueError, match="finite"):
        tising.IsingProblem.create(np.array([[0, np.nan], [np.nan, 0]],
                                            np.float32))
    with pytest.raises(TypeError, match="EdgeList"):
        tising.IsingProblem.create_sparse(None)
    J = np.zeros((4, 4), np.float32)
    assert tcoupling.resolve_format("auto", J, 4) == "dense"
    assert tcoupling.resolve_format("dense", J, 4) == "dense"
    for fmt in ("bitplane", "bitplane_hbm"):
        assert tcoupling.resolve_format(fmt, J, 4) == fmt
    for fmt in ("bitplane_sharded", "bitplane_sharded_2d"):
        # Served by the sharded driver; the single-device sweep refuses
        # them, naming it.
        assert tcoupling.resolve_format(fmt, J, 4) == fmt
        with pytest.raises(ValueError, match="solve_sharded"):
            tcoupling.CouplingStore.build(J, fmt).require(
                tcoupling.KERNEL_COUPLING_MODES, "fused_anneal")
    with pytest.raises(ValueError):
        tcoupling.resolve_format("sparse", J, 4)
