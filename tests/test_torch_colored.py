"""The port's graph-colored path against the JAX package's, on the CPU.

* ``ref.colored_sweep`` (the plain version, which the wrapper
  ``kernels.sweep.colored_sweep`` runs for CPU tensors) is bitwise equal on
  all seven outputs to ``repro.kernels.ref.colored_sweep`` and to the Pallas
  ``repro.kernels.sweep.colored_sweep`` in interpret mode, given the
  reference plan's operands (coloring, permuted store, schedule) and the
  same uniforms: torus 8×8 (χ = 2) and ER 96/400 (χ > 2, ragged windows) ×
  dense, ``bitplane``, ``bitplane_hbm`` with the PWL flip probability and
  integer J and h; with warm-started chunks; at temperature 0.
* The exact sigmoid: ``torch.sigmoid`` and ``jax.nn.sigmoid`` differ by up
  to 3 ulp, so one step from many states agrees with the reference on every
  replica except those with an accept uniform within 4 ulp of its p (a near
  tie); every split is such a replica, and the near ties are counted.
* ``colored_anneal`` and ``solve(backend="colored")`` are bitwise equal to
  the JAX package's, seed for seed (linear schedules: the geometric one
  differs by ≤ 2 ulp, see ``test_torch_core.py``), in best_energy,
  best_spins (original vertex order), final_energy, num_flips,
  trace_energy and rows_fetched — across chunk boundaries and a remainder
  chunk; the three tiers agree; the results do not depend on the selection
  mode; a prebuilt plan gives the same result; the routing guards raise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core.pwl import pwl_table as jpwl_table
from repro.core.schedules import linear as jlinear
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import solve as jsolve
from repro.graphs import sparse_bipolar_edges as jsparse
from repro.graphs import torus_grid_edges as jtorus
from repro.graphs.coloring import greedy_coloring as jcoloring
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sweep import colored_sweep as jkernel
from repro_torch import interop
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.core.coupling import CouplingStore
from repro_torch.core.solver import solve
from repro_torch.graphs import sparse_bipolar_edges, torus_grid_edges
from repro_torch.kernels import common, ops, ref, sweep

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy", "rows_fetched")
TIERS = ("dense", "bitplane", "bitplane_hbm")
GRAPHS = {
    "torus": (lambda: jtorus(8, 8, seed=5),
              lambda: torus_grid_edges(8, 8, seed=5)),
    "er": (lambda: jsparse(96, 400, seed=11),
           lambda: sparse_bipolar_edges(96, 400, seed=11)),
}


def _plans(graph, fmt, offset=0.0):
    """The reference's colored plan of ``graph`` and the port's plan carried
    from it (its coloring and, on the plane tiers, its permuted planes)."""
    jedges, tedges = GRAPHS[graph][0](), GRAPHS[graph][1]()
    n = tedges.num_spins
    h = np.round(np.linspace(-2, 2, n)).astype(np.float32)
    if fmt == "dense":
        jprob = jising.IsingProblem.create(np.asarray(jedges.to_dense()), h,
                                           offset=offset)
        tprob = tising.IsingProblem.create(tedges.to_dense(), h,
                                           offset=offset)
    else:
        jprob = jising.IsingProblem.create_sparse(jedges, h=h, offset=offset)
        tprob = tising.IsingProblem.create_sparse(tedges, h=h, offset=offset)
    jplan = jops.ColoredPlan(jcoloring(jprob.coupling_source), jprob, fmt)
    planes = None
    if jplan.store.planes is not None:
        planes = (np.asarray(jplan.store.planes.pos),
                  np.asarray(jplan.store.planes.neg))
    col = jplan.coloring
    tplan = interop.colored_plan_from_numpy(col.colors, col.perm,
                                            col.offsets, tprob, fmt, planes)
    return jplan, tplan, tprob


def _operands(jplan, r, t, seed, temps=None):
    """A consistent (u0, s0, e0) ensemble of the permuted problem, uniforms
    over the window, temperatures and the reference's class schedule."""
    g = np.random.default_rng(seed)
    J = np.asarray(jplan.problem.couplings) if jplan.problem.edges is None \
        else np.asarray(jplan.problem.edges.to_dense())
    n = J.shape[0]
    hp = np.asarray(jplan.problem.fields)
    s0 = np.where(g.random((r, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    u0 = (s0 @ J.T + hp[None, :]).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, s0 @ J.T) - s0 @ hp).astype(
        np.float32)
    unif = g.random((t, r, jplan.window)).astype(np.float32)
    if temps is None:
        temps = np.broadcast_to(np.geomspace(2.5, 0.05, t).astype(
            np.float32)[:, None], (t, r)).copy()
    sched = np.asarray(jops.colored_class_schedule(
        jplan.wstarts, jplan.offsets, jplan.sizes, jnp.arange(t)))
    return u0, s0, e0, unif, temps, sched


def _jax_operand(jplan, fmt):
    if fmt == "dense":
        return jnp.asarray(jplan.problem.couplings)
    return jplan.store.kernel_operand


def _torch(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


def _assert_outputs(want, got, msg):
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy(),
                                      err_msg=f"{msg}:{name}")


@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plan_equals_reference(graph, fmt):
    """The port's own plan (coloring, permuted problem, store, window math)
    equals the reference's: the integers exactly."""
    jplan, carried, tprob = _plans(graph, fmt)
    plan = ops.colored_plan(tprob, fmt)
    assert plan.coloring == carried.coloring
    assert plan.window == jplan.window and plan.store.fmt == fmt
    for name in ("wstarts", "offsets", "sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(jplan, name)),
                                      getattr(plan, name).numpy())
    np.testing.assert_array_equal(np.asarray(jplan.problem.fields),
                                  plan.problem.fields.numpy())
    if fmt == "dense":
        np.testing.assert_array_equal(np.asarray(jplan.problem.couplings),
                                      plan.store.dense.numpy())
    else:
        np.testing.assert_array_equal(np.asarray(jplan.problem.edges.rows),
                                      plan.problem.edges.rows)
        np.testing.assert_array_equal(np.asarray(jplan.store.planes.pos),
                                      plan.store.planes.to_numpy()[0])
        np.testing.assert_array_equal(np.asarray(jplan.store.planes.neg),
                                      plan.store.planes.to_numpy()[1])


@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_colored_sweep_pwl_bitwise_with_reference_and_pallas(graph, fmt):
    jplan, tplan, _ = _plans(graph, fmt)
    args = _operands(jplan, r=8, t=24, seed=3)
    jargs = tuple(map(jnp.asarray, args))
    op = _jax_operand(jplan, fmt)
    want_ref = jref.colored_sweep(op, *jargs, jpwl_table(), block_r=4)
    want_pallas = jkernel(op, *jargs, jpwl_table(), coupling=fmt, block_r=4,
                          interpret=True)
    before = sweep.colored_counter.count
    got = sweep.colored_sweep(tplan.store.kernel_operand, *_torch(args),
                              tpwl.pwl_table(), coupling=fmt, block_r=4)
    assert sweep.colored_counter.count == before   # the plain version
    _assert_outputs(want_ref, got, f"{graph}/{fmt}/ref")
    _assert_outputs(want_pallas, got, f"{graph}/{fmt}/pallas")
    plain = ref.colored_sweep(tplan.store.kernel_operand, *_torch(args),
                              tpwl.pwl_table(), block_r=4)
    _assert_outputs(want_ref, plain, f"{graph}/{fmt}/plain")
    nf, rf = got[5], got[6]
    assert int(nf.sum()) > 0 and bool((rf <= nf).all())


def _near_ties(de, temps, unif, valid, ulps=4):
    """(R,) bool: some accept uniform of the replica lies within ``ulps``
    ulp of its exact-sigmoid p (the sigmoids of the two frameworks differ
    by up to 3 ulp)."""
    p = common.flip_probability(de, temps[:, None], None)
    gap = torch.abs(unif - p)
    ulp = torch.nextafter(p, torch.full_like(p, 2.0)) - p
    return ((gap <= ulps * ulp) & valid).any(dim=1)


@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_colored_sweep_exact_sigmoid_one_step_from_many_states(graph, fmt):
    """One exact-sigmoid step from 512 states at temperatures across the
    anneal: equal to the reference on every replica but near ties."""
    r = 512
    jplan, tplan, _ = _plans(graph, fmt)
    temps = np.geomspace(4.0, 0.05, r).astype(np.float32)[None, :]
    args = _operands(jplan, r=r, t=1, seed=5, temps=temps)
    want = jref.colored_sweep(_jax_operand(jplan, fmt),
                              *map(jnp.asarray, args), None, block_r=1)
    targs = _torch(args)
    got = sweep.colored_sweep(tplan.store.kernel_operand, *targs, None,
                              coupling=fmt, block_r=1)
    u0, s0, _, unif, temps_t, sched = targs
    w, off, size = sched[0].tolist()
    idx = torch.arange(tplan.window) + w
    valid = ((idx >= off) & (idx < off + size))[None, :]
    de = 2.0 * s0[:, w:w + tplan.window] * u0[:, w:w + tplan.window]
    tie = _near_ties(de, temps_t[0], unif[0], valid)
    same = torch.ones(r, dtype=torch.bool)
    for a, b in zip(want, got):
        a = torch.from_numpy(np.array(a, np.float32))
        b = b.to(torch.float32)
        same &= (a == b).reshape(r, -1).all(dim=1)
    assert bool((same | tie).all()), f"splits off near ties: {(~same).sum()}"
    assert int(tie.sum()) <= r // 10, int(tie.sum())
    assert int(same.sum()) >= r - int(tie.sum())


@pytest.mark.parametrize("fmt", ["bitplane", "bitplane_hbm"])
def test_colored_sweep_exact_sigmoid_trajectory(fmt):
    """24 exact-sigmoid steps: equal to the reference unless some step had
    a near tie, replayed step by step on the reference's own states."""
    jplan, tplan, _ = _plans("er", fmt)
    u0, s0, e0, unif, temps, sched = _operands(jplan, r=8, t=24, seed=7)
    op = _jax_operand(jplan, fmt)
    want = jref.colored_sweep(op, *map(jnp.asarray, (u0, s0, e0, unif, temps,
                                                     sched)), None, block_r=4)
    got = sweep.colored_sweep(tplan.store.kernel_operand,
                              *_torch((u0, s0, e0, unif, temps, sched)), None,
                              coupling=fmt, block_r=4)
    equal = all(np.array_equal(np.asarray(a, np.float32),
                               b.to(torch.float32).numpy())
                for a, b in zip(want, got))
    ties = 0
    state = (u0, s0, e0)
    for t in range(24):
        step = (unif[t:t + 1], temps[t:t + 1], sched[t:t + 1])
        j1 = jref.colored_sweep(op, *map(jnp.asarray, state + step), None,
                                block_r=4)
        t1 = sweep.colored_sweep(tplan.store.kernel_operand,
                                 *_torch(state + step), None, coupling=fmt,
                                 block_r=4)
        w, off, size = (int(x) for x in sched[t])
        win = tplan.window
        idx = torch.arange(win) + w
        valid = ((idx >= off) & (idx < off + size))[None, :]
        tu, ts = torch.from_numpy(state[0]), torch.from_numpy(state[1])
        tie = _near_ties(2.0 * ts[:, w:w + win] * tu[:, w:w + win],
                         torch.from_numpy(temps[t]),
                         torch.from_numpy(unif[t]), valid)
        ties += int(tie.sum())
        if not bool(tie.any()):
            _assert_outputs(j1, t1, f"step {t}")
        state = tuple(np.asarray(x, np.float32) for x in j1[:3])
    assert equal or ties > 0


def test_colored_sweep_warm_started_chunks():
    jplan, tplan, _ = _plans("er", "bitplane_hbm")
    u0, s0, e0, unif, temps, sched = _operands(jplan, r=8, t=12, seed=1)
    op = jplan.store.kernel_operand
    jstate, tstate = (u0, s0, e0), _torch((u0, s0, e0))
    for c in range(3):
        un = np.random.default_rng(50 + c).random(unif.shape).astype(
            np.float32)
        rest = (un, temps, sched)
        want = jkernel(op, *map(jnp.asarray, jstate + rest), jpwl_table(),
                       coupling="bitplane_hbm", block_r=4, interpret=True)
        got = sweep.colored_sweep(tplan.store.kernel_operand,
                                  *(tstate + _torch(rest)), tpwl.pwl_table(),
                                  coupling="bitplane_hbm", block_r=4)
        _assert_outputs(want, got, f"chunk {c}")
        jstate = tuple(np.asarray(x) for x in want[:3])
        tstate = got[:3]


@pytest.mark.parametrize("fmt", ["dense", "bitplane"])
def test_colored_sweep_zero_temperature(fmt):
    """T=0 steps are greedy: the energy never rises, and the port equals
    the reference."""
    jplan, tplan, _ = _plans("torus", fmt)
    u0, s0, e0, unif, temps, sched = _operands(jplan, r=4, t=16, seed=9)
    temps = np.zeros_like(temps)
    args = (u0, s0, e0, unif, temps, sched)
    want = jref.colored_sweep(_jax_operand(jplan, fmt),
                              *map(jnp.asarray, args), None, block_r=4)
    got = sweep.colored_sweep(tplan.store.kernel_operand, *_torch(args),
                              coupling=fmt, block_r=4)
    _assert_outputs(want, got, fmt)
    assert bool((got[2] <= torch.from_numpy(e0)).all())


def _configs(steps=240, trace_every=40, fmt="bitplane", mode="rsa",
             num_replicas=4):
    jcfg = JConfig(steps, jlinear(3.0, 0.1, steps), mode=mode,
                   num_replicas=num_replicas, trace_every=trace_every,
                   flip_mode="colored", coupling_format=fmt)
    return jcfg, interop.config_from_dict(dataclasses.asdict(jcfg))


def _assert_results(jres, tres, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jres, name)),
                                      getattr(tres, name).numpy(),
                                      err_msg=f"{msg}:{name}")


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("fmt", TIERS)
def test_colored_anneal_equals_jax_seed_for_seed(fmt, seed):
    _, _, tprob = _plans("er", fmt, offset=2.5)
    jedges = GRAPHS["er"][0]()
    h = np.round(np.linspace(-2, 2, 96)).astype(np.float32)
    jprob = (jising.IsingProblem.create(np.asarray(jedges.to_dense()), h,
                                        offset=2.5) if fmt == "dense" else
             jising.IsingProblem.create_sparse(jedges, h=h, offset=2.5))
    jcfg, tcfg = _configs(fmt=fmt)
    jres = jops.colored_anneal(jprob, seed, jcfg)
    tres = ops.colored_anneal(tprob, seed, tcfg, device="cpu")
    _assert_results(jres, tres, fmt)
    assert tres.best_spins.dtype == torch.int8
    # best_energy is the energy of best_spins in the original vertex order.
    J = torch.from_numpy(GRAPHS["er"][1]().to_dense())
    exact = tising.energy(tising.IsingProblem(J, tprob.fields),
                          tres.best_spins) + 2.5
    assert torch.equal(tres.best_energy, exact)


def test_solve_colored_backend_equals_jax_and_chunk_boundaries():
    """solve(backend="colored") against JAX's, traced and untraced with a
    remainder chunk (300 steps in 128-step chunks: 128, 128, 44)."""
    jedges, tedges = GRAPHS["torus"][0](), GRAPHS["torus"][1]()
    jprob = jising.IsingProblem.create_sparse(jedges)
    tprob = tising.IsingProblem.create_sparse(tedges)
    jcfg, tcfg = _configs(steps=240, trace_every=40)
    _assert_results(jsolve(jprob, 3, jcfg, backend="colored"),
                    solve(tprob, 3, tcfg, backend="colored", device="cpu"),
                    "traced")
    jcfg, tcfg = _configs(steps=300, trace_every=0, fmt="bitplane_hbm")
    jres = jops.colored_anneal(jprob, 4, jcfg, chunk_steps=128)
    tres = ops.colored_anneal(tprob, 4, tcfg, chunk_steps=128, device="cpu")
    _assert_results(jres, tres, "chunked")
    assert tres.trace_energy.shape == (0, 4)


def test_class_schedule_across_chunk_boundaries():
    jplan, tplan, _ = _plans("er", "bitplane")
    steps = np.arange(300)
    want = np.asarray(jops.colored_class_schedule(
        jplan.wstarts, jplan.offsets, jplan.sizes, jnp.asarray(steps)))
    chunks = [ops.colored_class_schedule(tplan.wstarts, tplan.offsets,
                                         tplan.sizes, torch.arange(a, b))
              for a, b in ((0, 128), (128, 256), (256, 300))]
    got = torch.cat(chunks)
    assert got.dtype == torch.int32 and got.shape == (300, 3)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("mode,uniformized", [("rsa", False), ("rwa", True)])
def test_colored_results_do_not_depend_on_the_mode(mode, uniformized):
    tprob = tising.IsingProblem.create_sparse(torus_grid_edges(6, 8, seed=2))
    _, base = _configs(mode="rwa")
    cfg = dataclasses.replace(base, mode=mode, uniformized=uniformized)
    want = solve(tprob, 11, base, backend="colored", device="cpu")
    got = solve(tprob, 11, cfg, backend="colored", device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(want, name), getattr(got, name)), name


def test_tiers_agree_and_plan_reuse():
    tedges = sparse_bipolar_edges(128, 512, seed=7)
    sparse = tising.IsingProblem.create_sparse(tedges, offset=2.5)
    dense = tising.IsingProblem.create(tedges.to_dense(), offset=2.5)
    _, cfg = _configs(steps=300, trace_every=100)
    runs = {fmt: ops.colored_anneal(dense if fmt == "dense" else sparse, 3,
                                    dataclasses.replace(cfg,
                                                        coupling_format=fmt),
                                    device="cpu")
            for fmt in TIERS}
    for fmt in ("bitplane", "bitplane_hbm"):
        for name in FIELDS:
            assert torch.equal(getattr(runs["dense"], name),
                               getattr(runs[fmt], name)), (fmt, name)
    trace = runs["dense"].trace_energy
    assert trace.shape == (3, 4) and bool((trace[1:] <= trace[:-1]).all())
    plan = ops.colored_plan(sparse, "bitplane")
    reused = ops.colored_anneal(sparse, 3, cfg, plan=plan, device="cpu")
    again = ops.colored_anneal(sparse, 3, cfg, plan=plan, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(runs["bitplane"], name),
                           getattr(reused, name)), name
        assert torch.equal(getattr(reused, name), getattr(again, name)), name


def test_routing_guards():
    tprob = tising.IsingProblem.create_sparse(torus_grid_edges(4, 4, seed=0))
    _, colored = _configs(steps=16, trace_every=0, num_replicas=2)
    single = dataclasses.replace(colored, flip_mode="single")
    with pytest.raises(ValueError, match="colored"):
        ops.fused_anneal(tprob, 0, colored, device="cpu")
    with pytest.raises(ValueError, match="colored"):
        solve(tprob, 0, colored, backend="fused", device="cpu")
    with pytest.raises(ValueError, match="flip_mode"):
        ops.colored_anneal(tprob, 0, single, device="cpu")
    with pytest.raises(ValueError, match="colored"):
        solve(tprob, 0, single, backend="colored", device="cpu")
    store = CouplingStore.build(tprob.edges, "bitplane")
    with pytest.raises(ValueError, match="color-sorted"):
        solve(tprob, 0, colored, backend="colored", store=store,
              device="cpu")
    plan = ops.colored_plan(tprob, "bitplane")
    with pytest.raises(ValueError, match="not both"):
        ops.colored_anneal(tprob, 0, colored, plan=plan, coupling="bitplane",
                           device="cpu")
    with pytest.raises(ValueError, match="dense-J-free"):
        ops.colored_plan(tprob, "dense")
    other = tising.IsingProblem.create_sparse(torus_grid_edges(4, 6))
    with pytest.raises(ValueError, match="N="):
        ops.colored_anneal(other, 0, colored, plan=plan, device="cpu")


def test_wrapper_checks_shapes():
    jplan, tplan, _ = _plans("torus", "bitplane")
    u0, s0, e0, unif, temps, sched = _torch(_operands(jplan, r=4, t=4,
                                                      seed=0))
    op = tplan.store.kernel_operand
    with pytest.raises(ValueError, match="sched"):
        sweep.colored_sweep(op, u0, s0, e0, unif, temps, sched[:3],
                            coupling="bitplane")
    with pytest.raises(ValueError, match="uniforms"):
        sweep.colored_sweep(op, u0, s0, e0, unif[0], temps, sched,
                            coupling="bitplane")
    with pytest.raises(ValueError, match="temps"):
        sweep.colored_sweep(op, u0, s0, e0, unif, temps[:, :2], sched,
                            coupling="bitplane")
    with pytest.raises(TypeError, match="BitPlanes"):
        sweep.colored_sweep(torch.zeros(64, 64), u0, s0, e0, unif, temps,
                            sched, coupling="bitplane")
    big = torch.zeros((4, 4, 65))
    with pytest.raises(ValueError, match="window"):
        sweep.colored_sweep(op, u0, s0, e0, big, temps, sched,
                            coupling="bitplane")
