"""The port's plane-tier sweep and solve against the JAX package, on the CPU.

* Plane sweep, RSA + PWL: the plain version (the CPU path of
  ``kernels.sweep.mcmc_sweep``) is bitwise equal on all seven outputs,
  ``rows_fetched`` included, to ``repro.kernels.sweep.mcmc_sweep`` in
  interpret mode with ``coupling="bitplane"|"bitplane_hbm"`` and
  ``coalesce`` on and off, given JAX's own uniforms.
* ``solve``: the port's ``solve(..., coupling_format=...)`` on an edge-list
  problem (N ≤ 256, B=2, |J| ≤ 3) is bitwise equal to
  ``repro.core.solver.solve(..., backend="fused")`` on best_energy,
  best_spins, final_energy, num_flips, trace_energy and rows_fetched; the
  chunk driver is equal with coalescing on and off.
* The dense, ``bitplane`` and ``bitplane_hbm`` trajectories of one solve are
  bitwise equal to each other; rows_fetched is R·T except coalesced.
* RWA and the exact sigmoid on the plane tiers: one step from 512 states
  agrees except at near ties (radius within 1e-5·W of a cumulative boundary;
  RSA-exact: the accept uniform within 4 ulp of p), as the dense tier's tests
  hold them, and a long RWA solve keeps the exact invariants.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbit
from repro.core import ising as jising
from repro.core import pwl as jpwl
from repro.core import rng as jrng
from repro.core.schedules import linear as jlinear
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import solve as jsolve
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sweep import mcmc_sweep as jkernel
from repro_torch import interop
from repro_torch.core import bitplane as tbit
from repro_torch.core import coupling as tcoupling
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.core import rng as trng
from repro_torch.core.solver import solve, solve_many
from repro_torch.graphs import maxcut_edges_to_ising, sparse_bipolar_edges
from repro_torch.kernels import common, ops, parity, sweep

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy", "rows_fetched")
TIERS = ("bitplane", "bitplane_hbm")


def _edges(n, seed, amax=3):
    """A random edge list with integer weights in [−amax, amax] (B=2)."""
    g = np.random.default_rng(seed)
    m = 6 * n
    rows = g.integers(0, n, size=m)
    cols = g.integers(0, n - 1, size=m)
    cols = np.where(cols >= rows, cols + 1, cols)
    w = g.integers(1, amax + 1, size=m) * g.choice([-1, 1], size=m)
    jedges = jising.EdgeList.create(rows, cols, w, n)
    jedges = jising.EdgeList.create(jedges.rows, jedges.cols,
                                    np.clip(jedges.weights, -amax, amax), n)
    return jedges, interop.edges_from_numpy(jedges.rows, jedges.cols,
                                            jedges.weights, n)


def _sweep_inputs(J, r, t, seed, temps=None):
    g = np.random.default_rng(seed)
    s0 = np.where(g.random((r, J.shape[0])) < 0.5, 1.0, -1.0).astype(
        np.float32)
    h = np.rint(g.normal(size=J.shape[0])).astype(np.float32)
    u0 = (s0 @ J.T + h).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, u0 - h) - s0 @ h).astype(
        np.float32)
    unif = g.random((t, r, 4)).astype(np.float32)
    # Every other step, the first half of the replicas share a site.
    unif[::2, : r // 2, 0] = unif[::2, :1, 0]
    if temps is None:
        temps = np.broadcast_to(np.geomspace(8.0, 0.05, t).astype(
            np.float32)[:, None], (t, r)).copy()
    return h, (u0, s0, e0, unif, temps)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("n", [64, 200])
@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("tier", TIERS)
def test_plane_sweep_rsa_pwl_bitwise_with_pallas(tier, coalesce, n):
    r, t = 8, 96
    jedges, tedges = _edges(n, seed=n)
    align = tcoupling.FORMATS[tier].align_words
    jplanes = jbit.encode_edges(jedges, 2, align)
    tplanes = tbit.encode_edges(tedges, 2, align)
    J = tedges.to_dense()
    h, args = _sweep_inputs(J, r, t, seed=n + 1)
    jargs = tuple(map(jnp.asarray, args))
    want = jkernel(jplanes, *jargs, jpwl.pwl_table(), mode="rsa",
                   coupling=tier, coalesce=coalesce, block_r=4,
                   interpret=True)
    want_ref = jref.mcmc_sweep(jplanes, *jargs, jpwl.pwl_table(), mode="rsa")
    got = sweep.mcmc_sweep(tplanes, *_torch(args), tpwl.pwl_table(),
                           mode="rsa", coupling=tier, coalesce=coalesce,
                           block_r=4)
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    for name, a, b in zip(NAMES, want_ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    rf = got[6]
    if tier == "bitplane_hbm" and coalesce:
        assert int(rf.sum()) < r * t      # the forced shared sites coalesce
    else:
        assert int(rf.sum()) == r * t
    # The dense tier walks the same trajectory.
    dense = sweep.mcmc_sweep(torch.from_numpy(J), *_torch(args),
                             tpwl.pwl_table(), mode="rsa")
    for name, a, b in zip(NAMES[:6], dense, got):
        assert torch.equal(a, b), name


def _jax_and_port(jproblem, tproblem, seed, jcfg, fmt):
    jres = jsolve(jproblem, seed, dataclasses.replace(jcfg,
                                                       coupling_format=fmt),
                  backend="fused")
    tcfg = interop.config_from_dict(dataclasses.asdict(
        dataclasses.replace(jcfg, coupling_format=fmt)))
    return jres, solve(tproblem, seed, tcfg, backend="fused", device="cpu")


def _assert_results_equal(jres, tres, msg):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jres, name)),
                                      getattr(tres, name).numpy(),
                                      err_msg=f"{msg}{name}")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n", [96, 256])
def test_edge_list_solve_bitwise_with_jax(n, tier):
    jedges, tedges = _edges(n, seed=3 * n)
    h = np.rint(np.random.default_rng(n).normal(size=n)).astype(np.float32)
    jprob = jising.IsingProblem.create_sparse(jedges, h, offset=-1.5)
    tprob = interop.sparse_problem_from_numpy(
        jedges.rows, jedges.cols, jedges.weights, n, h, offset=-1.5)
    steps = 256
    cfg = JConfig(num_steps=steps, schedule=jlinear(2.0 * np.sqrt(n), 0.05,
                                                    steps),
                  mode="rsa", trace_every=64)
    for seed in (0, 7)[: 2 if n < 200 else 1]:
        jres, tres = _jax_and_port(jprob, tprob, seed, cfg, tier)
        _assert_results_equal(jres, tres, f"seed {seed}: ")
        assert tres.trace_energy.shape == (steps // 64, 8)
        total = int(tres.rows_fetched.sum())
        assert total <= 8 * steps
        if tier == "bitplane":
            assert total == 8 * steps


def test_untraced_auto_solve_of_an_edge_list_bitwise_with_jax():
    """"auto" on an edge list is a plane tier in both packages (and the
    same one at this N); the remainder chunk runs too."""
    n = 128
    jedges, tedges = _edges(n, seed=11)
    jprob = jising.IsingProblem.create_sparse(jedges)
    tprob = tising.IsingProblem.create_sparse(tedges)
    cfg = JConfig(num_steps=300, schedule=jlinear(9.0, 0.05, 300), mode="rsa")
    jres, tres = _jax_and_port(jprob, tprob, 4, cfg, "auto")
    _assert_results_equal(jres, tres, "auto: ")
    assert tres.trace_energy.shape == (0, 8)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("tier", TIERS)
def test_chunk_driver_bitwise_with_jax_coalescing_on_and_off(tier, coalesce):
    n, r, clen = 160, 8, 64
    jedges, tedges = _edges(n, seed=5)
    align = tcoupling.FORMATS[tier].align_words
    jplanes = jbit.encode_edges(jedges, 2, align)
    tplanes = interop.planes_from_numpy(jplanes.pos, jplanes.neg, n)
    encoded = tbit.encode_edges(tedges, 2, align)
    assert torch.equal(tplanes.pos, encoded.pos)
    assert torch.equal(tplanes.neg, encoded.neg)
    jprob = jising.IsingProblem.create_sparse(jedges)
    tprob = tising.IsingProblem.create_sparse(tedges)
    jbase = jax.random.fold_in(jax.random.key(0), 3)
    tbase = trng.fold_in(trng.key(0), 3)
    jstate = jops.fused_init_state(jprob, jbase, r, interpret=True,
                                   planes=jplanes)
    tstate = ops.fused_init_state(tprob, tbase, r, planes=tplanes)
    temps = np.broadcast_to(np.linspace(6.0, 0.1, clen, dtype=np.float32)[
        :, None], (clen, r)).copy()
    for c in range(2):
        jstate, jrf = jops.fused_sweep_chunk(
            jplanes, jstate, jrng.stream(jbase, jrng.Salt.SWEEP, c), clen,
            jnp.asarray(temps), mode="rsa", pwl_table=jpwl.pwl_table(),
            coupling=tier, coalesce=coalesce, block_r=4,
            with_rows_fetched=True, interpret=True)
        tstate, trf = ops.keyed_sweep_chunk(
            tplanes, tstate, trng.words(tbase), c, torch.from_numpy(temps),
            mode="rsa", pwl_table=tpwl.pwl_table(), coupling=tier,
            coalesce=coalesce, block_r=4, with_rows_fetched=True)
        for a, b in zip(jstate + (jrf,), tstate + (trf,)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_dense_and_plane_tiers_walk_one_trajectory(mode):
    n = 128
    _, tedges = _edges(n, seed=17)
    dense_prob = tising.IsingProblem.create(tedges.to_dense())
    sparse_prob = tising.IsingProblem.create_sparse(tedges)
    cfg = dataclasses.replace(interop.config_from_dict(dataclasses.asdict(
        JConfig(num_steps=256, schedule=jlinear(12.0, 0.05, 256), mode=mode,
                trace_every=64))), num_replicas=8)
    runs = {}
    for fmt in ("dense",) + TIERS:
        prob = dense_prob if fmt == "dense" else sparse_prob
        runs[fmt] = solve(prob, 2, dataclasses.replace(cfg,
                                                       coupling_format=fmt),
                          device="cpu")
    for fmt in TIERS:
        for name in FIELDS[:5]:
            assert torch.equal(getattr(runs["dense"], name),
                               getattr(runs[fmt], name)), (fmt, name)
    for fmt in ("dense", "bitplane"):
        assert int(runs[fmt].rows_fetched.sum()) == 8 * 256
    assert int(runs["bitplane_hbm"].rows_fetched.sum()) <= 8 * 256
    assert torch.equal(runs["dense"].best_energy,
                       tising.energy(dense_prob, runs["dense"].best_spins))


STEP_VARIANTS = {
    "rwa_pwl": dict(mode="rwa", pwl=True, uniformized=False),
    "rwa_uniformized_pwl": dict(mode="rwa", pwl=True, uniformized=True),
    "rwa_exact": dict(mode="rwa", pwl=False, uniformized=False),
    "rsa_exact": dict(mode="rsa", pwl=False, uniformized=False),
}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
def test_one_step_from_512_states_agrees_except_near_ties(variant, tier):
    v = STEP_VARIANTS[variant]
    n, r = 128, 512
    jedges, tedges = _edges(n, seed=23)
    align = tcoupling.FORMATS[tier].align_words
    jplanes = jbit.encode_edges(jedges, 2, align)
    tplanes = tbit.encode_edges(tedges, 2, align)
    g = np.random.default_rng(29)
    temps = g.uniform(0.2, 3.0 * np.sqrt(n), size=(1, r)).astype(np.float32)
    _, args = _sweep_inputs(tedges.to_dense(), r, 1, seed=31, temps=temps)
    jt = jpwl.pwl_table() if v["pwl"] else None
    tt = tpwl.pwl_table() if v["pwl"] else None
    kw = dict(mode=v["mode"], uniformized=v["uniformized"])
    got = sweep.mcmc_sweep(tplanes, *_torch(args), tt, coupling=tier, **kw)
    want = jref.mcmc_sweep(jplanes, *map(jnp.asarray, args), jt, **kw)
    u0, s0, _, unif, _ = _torch(args)
    if v["mode"] == "rwa":
        p_all = common.flip_probability(2.0 * s0 * u0,
                                        torch.from_numpy(temps[0])[:, None],
                                        tt)
        tie = parity.roulette_near_tie(p_all, unif[0, :, 2], unif[0, :, 3],
                                       v["uniformized"]).numpy()
    else:
        j = common.site_from_uniform(unif[0, :, 0], n)
        rows = torch.arange(r)
        de = 2.0 * s0[rows, j] * u0[rows, j]
        p = common.flip_probability(de, torch.from_numpy(temps[0]), tt)
        gap = (unif[0, :, 1] - p).abs() / torch.abs(p).clamp_min(
            np.finfo(np.float32).tiny)
        tie = (gap <= 4 * 2.0 ** -23).numpy()
    keep = ~tie
    assert keep.sum() >= 0.9 * r
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a)[keep], b.numpy()[keep],
                                      err_msg=f"{variant}:{name}")


@pytest.mark.parametrize("uniformized", [False, True])
def test_rwa_plane_solve_invariants(uniformized):
    n = 128
    _, tedges = _edges(n, seed=41)
    prob = maxcut_edges_to_ising(tedges)
    dense = tising.IsingProblem.create(-tedges.to_dense())
    cfg = interop.config_from_dict(dataclasses.asdict(JConfig(
        num_steps=192, schedule=jlinear(20.0, 0.05, 192), mode="rwa",
        uniformized=uniformized, coupling_format="bitplane_hbm",
        trace_every=64)))
    res = solve(prob, 3, cfg, device="cpu")
    assert torch.equal(res.best_energy, tising.energy(dense, res.best_spins))
    trace = res.trace_energy
    assert trace.shape == (3, 8)
    assert bool((trace[1:] <= trace[:-1]).all())
    assert torch.equal(trace[-1], res.best_energy)
    if uniformized:
        assert bool((res.num_flips <= 192).all())
    else:
        assert torch.equal(res.num_flips,
                           torch.full((8,), 192, dtype=torch.int32))


def test_solve_many_reuses_one_store():
    n = 96
    _, tedges = _edges(n, seed=43)
    prob = tising.IsingProblem.create_sparse(tedges)
    cfg = interop.config_from_dict(dataclasses.asdict(JConfig(
        num_steps=128, schedule=jlinear(6.0, 0.05, 128), mode="rsa")))
    store = tcoupling.CouplingStore.build(tedges, "bitplane_hbm")
    many = solve_many(prob, [3, 4], cfg, store=store, device="cpu")
    assert many.best_energy.shape == (2, 8)
    for i, seed in enumerate((3, 4)):
        one = solve(prob, seed, dataclasses.replace(
            cfg, coupling_format="bitplane_hbm"), device="cpu")
        for name in FIELDS:
            assert torch.equal(getattr(many, name)[i], getattr(one, name))


def test_sparse_maxcut_cut_matches_energy():
    n = 300
    edges = sparse_bipolar_edges(n, 8 * n, seed=n)
    prob = maxcut_edges_to_ising(edges)
    res = solve(prob, 0, interop.config_from_dict(dataclasses.asdict(JConfig(
        num_steps=256, schedule=jlinear(8.0, 0.05, 256), mode="rwa"))),
        device="cpu")
    w = edges.to_dense()
    s = res.best_spins.numpy().astype(np.float32)
    cuts = np.array([np.sum(np.triu(w, 1) * (1 - np.outer(x, x))) / 2
                     for x in s])
    total = float(edges.weights.sum())
    np.testing.assert_array_equal((total - res.best_energy.numpy()) / 2, cuts)


def test_cli_solves_a_sparse_instance_on_the_cpu():
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--instance",
         "sparse200", "--coupling-format", "bitplane_hbm", "--mode", "rsa",
         "--steps", "200", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "(edge list)" in out.stdout and "best cut =" in out.stdout
    assert "coupling_format=bitplane_hbm" in out.stdout
