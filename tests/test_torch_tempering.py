"""The port's parallel tempering (``repro_torch.core.tempering``) against the
JAX package's, on the CPU.

* Fused tempering (the sweep's plain version with the ladder as its
  per-replica temperature table, then the swap) equals JAX's fused
  ``solve_tempering`` (the Pallas sweep in interpret mode) bitwise on RSA +
  PWL + integer J and h: on the dense, ``bitplane`` and ``bitplane_hbm``
  tiers and from an ``EdgeList``; and, as measured at these inputs, on
  dense RWA. The reference tempering equals JAX's reference bitwise.
* A swap accepts where ``u < min(exp(clip(Δβ·ΔE)), 1)``; ``exp`` may differ
  between XLA and torch in the last ulp, so a run may split from JAX's
  only at a swap whose uniform lies within 4 ulp of its probability. Each
  solve test records the smallest margin it saw (``swap_margin_ulps``).
* The sweep's plain version with a distinct temperature column per replica
  (a ladder, a random table; T = 1, 10 and 64) equals JAX's
  ``fused_sweep_chunk`` on the same uniforms.
* ``_swap_phase`` equals JAX's on given energies and rounds; RWA tempering
  finds the brute-force ground state at N=12; each rung samples the
  Boltzmann law at its own temperature (the statistical tier's χ² gate,
  exact sigmoid); ``run_resilient`` over the tempering runner equals the
  monolithic solve after a crash, a budget stop and a tier downgrade.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coupling as jcoupling
from repro.core import ising as jising
from repro.core import rng as jrng
from repro.core.pwl import pwl_table as jpwl_table
from repro.core.resilience import run_resilient as jrun_resilient
from repro.core.tempering import TemperingConfig as JTConfig
from repro.core.tempering import _swap_phase as j_swap_phase
from repro.core.tempering import solve_tempering as jsolve_tempering
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.checkpoint import snapshot_steps
from repro_torch.core import coupling as tcoupling
from repro_torch.core import ising, rng, tempering
from repro_torch.core.pwl import pwl_table
from repro_torch.core.resilience import (STOP_COMPLETED, STOP_MAX_STEPS,
                                         BudgetConfig, inject_faults,
                                         run_resilient)
from repro_torch.core.tempering import (TemperingConfig, TemperingRunner,
                                        solve_tempering)
from repro_torch.kernels import ops, parity, ref

from fault_injection import (SimulatedCrash, kill_after_chunk_hook,
                             oom_once_hook)

N = 48
STEPS = 600
FIELDS = ("best_energy", "best_spins", "final_energy", "swap_acceptance",
          "num_flips")
#: A swap decision within this many ulp of its probability may go either
#: way between XLA's exp and torch's.
TIE_ULPS = 4


def _instance(n=N, seed=0, scale=1.5):
    g = np.random.default_rng(seed)
    J = np.triu(np.rint(g.normal(size=(n, n)) * scale), 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    return J, h, -2.5


def _jcfg(**kw):
    base = dict(num_steps=STEPS, t_min=0.1, t_max=6.0, num_replicas=8,
                swap_every=10, mode="rsa", backend="fused")
    base.update(kw)
    return JTConfig(**base)


def _tcfg(jcfg):
    return interop.tempering_config_from_dict(dataclasses.asdict(jcfg))


def _assert_same(want, got, msg=""):
    for name in FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        assert a.dtype == b.dtype and torch.equal(a, b.cpu()), msg + name


class _Margins:
    """Records, for every active swap decision a solve makes, the distance
    of its uniform from its probability in ulps of the probability."""

    def __init__(self, monkeypatch):
        self.ulps = []
        inner = tempering.swap_permutation

        def spy(energy, uniforms, dbeta):
            even_only = uniforms.clone()
            even_only[1] = tempering.INACTIVE_UNIFORM
            perm0, _ = inner(energy, even_only, dbeta)
            for parity_, e in ((0, energy), (1, energy[perm0])):
                p = torch.clamp(torch.exp(torch.clamp(
                    dbeta * (e[:-1] - e[1:]), -80.0, 80.0)), max=1.0)
                u = uniforms[parity_]
                active = u <= 1.0
                pn = p.numpy()
                with np.errstate(over="ignore"):
                    gap = np.abs(u.numpy() - pn) / np.spacing(pn)
                self.ulps.extend(gap[active.numpy()].tolist())
            return inner(energy, uniforms, dbeta)

        monkeypatch.setattr(tempering, "swap_permutation", spy)

    @property
    def smallest(self) -> float:
        return min(self.ulps) if self.ulps else float("inf")


def _held_to_jax(jres, tres, margins, record_property, msg=""):
    """Bitwise, unless some swap fell within :data:`TIE_ULPS`."""
    record_property("swap_margin_ulps", margins.smallest)
    print(f"{msg}smallest swap margin {margins.smallest:.1f} ulp over "
          f"{len(margins.ulps)} decisions")
    same = all(torch.equal(torch.from_numpy(np.array(getattr(jres, f))),
                           getattr(tres, f)) for f in FIELDS)
    if not same:
        assert margins.smallest <= TIE_ULPS, (
            f"{msg}the run split from JAX's with no swap within "
            f"{TIE_ULPS} ulp (smallest {margins.smallest:.1f})")
    else:
        _assert_same(jres, tres, msg)


def _problems(J, h, offset, edges=False):
    if edges:
        jedges = jising.EdgeList.from_dense(J)
        return (jising.IsingProblem.create_sparse(jedges, h=h, offset=offset),
                interop.sparse_problem_from_numpy(
                    jedges.rows, jedges.cols, jedges.weights, J.shape[0],
                    h, offset))
    return (jising.IsingProblem.create(J, h, offset=offset),
            interop.problem_from_numpy(J, h, offset))


# -------------------------------------------------------------- solve parity


@pytest.mark.parametrize("fmt,mode,edges", [
    ("dense", "rsa", False), ("bitplane", "rsa", False),
    ("bitplane_hbm", "rsa", False), ("auto", "rsa", True),
    ("dense", "rwa", False)])
def test_fused_tempering_bitwise_against_jax(monkeypatch, record_property,
                                             fmt, mode, edges):
    J, h, offset = _instance()
    jp, tp = _problems(J, h, offset, edges)
    jcfg = _jcfg(mode=mode, coupling_format=fmt)
    margins = _Margins(monkeypatch)
    for seed in ((3, 11) if fmt == "dense" and mode == "rsa" else (3,)):
        jres = jsolve_tempering(jp, seed, jcfg)
        tres = solve_tempering(tp, seed, _tcfg(jcfg), device="cpu")
        _held_to_jax(jres, tres, margins, record_property,
                     f"{fmt} {mode} seed {seed}: ")
    assert 0.0 < float(tres.swap_acceptance) < 1.0


@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_reference_tempering_bitwise_against_jax(monkeypatch, record_property,
                                                 mode):
    J, h, offset = _instance(32, seed=4)
    jp, tp = _problems(J, h, offset)
    jcfg = _jcfg(mode=mode, backend="reference", num_steps=400,
                 num_replicas=6, swap_every=8)
    margins = _Margins(monkeypatch)
    jres = jsolve_tempering(jp, 5, jcfg)
    tres = solve_tempering(tp, 5, _tcfg(jcfg), device="cpu")
    _held_to_jax(jres, tres, margins, record_property, f"reference {mode}: ")


def test_short_run_and_one_rung():
    """Fewer steps than one round run one round; one rung never swaps."""
    J, h, offset = _instance(24, seed=6)
    jp, tp = _problems(J, h, offset)
    for kw in (dict(num_steps=4), dict(num_replicas=1),
               dict(num_replicas=3, swap_every=1, num_steps=40)):
        jcfg = _jcfg(**kw)
        _assert_same(jsolve_tempering(jp, 2, jcfg),
                     solve_tempering(tp, 2, _tcfg(jcfg), device="cpu"),
                     f"{kw}: ")


def test_swap_phase_matches_jax():
    """The permutation, the accepted count and the attempted count of one
    round on given energies: equal energies, small gaps and gaps past the
    ±80 clip, over 16 rounds and three ladders."""
    g = np.random.default_rng(7)
    jbase = jax.random.fold_in(jax.random.key(0), jnp.uint32(9))
    tbase = rng.fold_in(rng.key(0), 9)
    for r, (t_hi, t_lo) in ((8, (6.0, 0.1)), (5, (2.0, 1.5)),
                            (2, (50.0, 0.01))):
        temps = np.geomspace(t_hi, t_lo, r).astype(np.float32)
        for k in range(16):
            e = np.rint(g.normal(size=r) * (3.0 if k % 2 else 40.0))
            e = e.astype(np.float32)
            if k % 5 == 0:
                e[:] = e[0]
            ids = np.arange(r, dtype=np.int32)
            jstate, (ja, jt) = j_swap_phase(
                (jnp.asarray(ids), jnp.asarray(e)), lambda st: st[1],
                jnp.asarray(temps), jbase, jnp.int32(k), r)
            tstate, (ta, tt) = tempering._swap_phase(
                (torch.from_numpy(ids), torch.from_numpy(e)),
                lambda st: st[1], torch.from_numpy(temps), tbase, k, r)
            for a, b in zip(jstate, tstate):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert int(ja) == int(ta) and int(jt) == int(tt) == r - 1


def test_swap_uniform_table_is_jax_draw():
    base = rng.fold_in(rng.key(0), 4)
    jbase = jax.random.fold_in(jax.random.key(0), jnp.uint32(4))
    table = tempering.swap_uniforms(base, torch.arange(6), 8)
    for k in range(6):
        for p in range(2):
            want = jrng.uniform01(jrng.stream(jbase, jrng.Salt.UNIFORMIZE, k,
                                              p), (7,))
            np.testing.assert_array_equal(np.asarray(want),
                                          table[k, p].numpy())
    masked = tempering.swap_table(base, 6, 8)
    assert torch.equal(masked[:, 0, 0::2], table[:, 0, 0::2])
    assert torch.equal(masked[:, 1, 1::2], table[:, 1, 1::2])
    assert (masked[:, 0, 1::2] == tempering.INACTIVE_UNIFORM).all()
    assert (masked[:, 1, 0::2] == tempering.INACTIVE_UNIFORM).all()


# ----------------------------------------- kernel A's per-replica temperatures


@pytest.mark.parametrize("fmt", ["dense", "bitplane", "bitplane_hbm"])
@pytest.mark.parametrize("t", [1, 10, 64])
def test_sweep_plain_version_per_replica_temperatures(fmt, t):
    """A distinct column per replica: the plain sweep equals JAX's
    ``fused_sweep_chunk`` (interpret mode) on the same uniforms, RSA +
    PWL, for a ladder and for a random table."""
    J, h, offset = _instance(32, seed=8)
    r = 8
    jp, tp = _problems(J, h, offset)
    jstore = jcoupling.CouplingStore.build(jp.couplings, fmt)
    tstore = tcoupling.CouplingStore.build(tp.couplings, fmt)
    jbase = jax.random.fold_in(jax.random.key(0), jnp.uint32(1))
    tbase = rng.fold_in(rng.key(0), 1)
    jstate = jops.fused_init_state(jp, jbase, r, interpret=True,
                                   planes=jstore.planes)
    tstate = ops.fused_init_state(tp, tbase, r, planes=tstore.planes)
    ladder = np.geomspace(6.0, 0.1, r).astype(np.float32)
    table = np.random.default_rng(t).uniform(0.05, 8.0, (t, r))
    for temps in (np.broadcast_to(ladder, (t, r)), table.astype(np.float32)):
        temps = np.ascontiguousarray(temps)
        for chunk in (0, 3):
            want = jops.fused_sweep_chunk(
                jstore.kernel_operand, jstate,
                jrng.stream(jbase, jrng.Salt.SWEEP, chunk), t,
                jnp.asarray(temps), mode="rsa", pwl_table=jpwl_table(),
                block_r=8, coupling=fmt, interpret=True)
            got = ops.keyed_sweep_chunk(
                tstore.kernel_operand, tstate, rng.words(tbase), chunk,
                torch.from_numpy(temps), mode="rsa", pwl_table=pwl_table(),
                block_r=8, coupling=fmt)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            jstate, tstate = want, got


@pytest.mark.parametrize("t", [1, 10, 63, 64, 65])
def test_kernel_draw_plain_version_on_short_chunks(t):
    """The keyed sweep's in-kernel draw (its plain version) is
    ``rng.uniform01`` also when a chunk is shorter than one staging window,
    as a tempering round is."""
    words = rng.words(rng.fold_in(rng.key(0), 12))
    want = rng.uniform01(rng.stream(rng.from_words(*words), rng.Salt.SWEEP,
                                    5), (t, 8, 4))
    assert torch.equal(ref.sweep_uniforms(words, 5, t, 8), want)


# ------------------------------------------------------------ the sampler


def test_rwa_tempering_finds_ground_state():
    g = np.random.default_rng(1)
    J = np.rint(g.normal(size=(12, 12)) * 2)
    J = np.triu(J, 1)
    J = J + J.T
    problem = ising.IsingProblem.create(J)
    e_star, _, _ = ising.brute_force_ground_state(problem)
    cfg = TemperingConfig(num_steps=600, t_min=0.05, t_max=8.0,
                          num_replicas=8, swap_every=10, mode="rwa",
                          backend="fused")
    res = solve_tempering(problem, 0, cfg, device="cpu")
    assert float(res.best_energy.min()) == e_star
    assert torch.equal(res.best_energy, ising.energy(problem, res.best_spins))
    assert 0.0 < float(res.swap_acceptance) < 1.0


def test_rung_marginals_are_boltzmann():
    """Each rung samples the Boltzmann law at its own temperature: rung k's
    state after every round (N=6, 4 rungs, exact sigmoid, RSA; two seeds,
    2,900 samples a rung) passes the χ² gate at T_k, and the law at T_k
    fits it better than at 2·T_k or T_k/2 (TV more than 3× smaller)."""
    g = np.random.default_rng(11)
    n = 6
    J = np.rint(g.normal(size=(n, n)) * 1.2)
    J = np.triu(J, 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    problem = ising.IsingProblem.create(J=J, h=h)
    r, every, rounds, burn = 4, 8, 1500, 50
    cfg = TemperingConfig(num_steps=rounds * every, t_min=1.25, t_max=5.0,
                          num_replicas=r, swap_every=every, use_pwl=False,
                          backend="fused")
    samples = []
    for seed in (0, 1):
        runner = TemperingRunner(problem, seed, cfg, device="cpu")
        state = runner.init()
        for k in range(runner.total_units):
            state = runner.run_chunk(state, k)
            if k >= burn:
                samples.append(parity.state_index(state[1]).numpy())
    samples = np.stack(samples)                       # (draws, R)
    assert 0.3 < float(runner.finalize(state, []).swap_acceptance) < 1.0
    for k, temp in enumerate(tempering.ladder_temps(cfg).tolist()):
        counts = np.bincount(samples[:, k], minlength=2 ** n)
        gates = parity.boltzmann_gates(counts, problem, temp)
        assert gates["x2"] < 2 * gates["crit"], (k, gates)
        assert all(w > 3 * gates["tv"] for w in gates["tv_wrong"]), (k, gates)


# ------------------------------------------------------------- supervision


@pytest.fixture(scope="module")
def sup_problem():
    J, h, offset = _instance(40, seed=2)
    return interop.problem_from_numpy(J, h, offset)


def _sup_cfg(fmt="auto"):
    return TemperingConfig(num_steps=120, t_min=0.1, t_max=5.0,
                           num_replicas=4, swap_every=20, mode="rsa",
                           backend="fused", coupling_format=fmt)


def test_resilient_tempering_equals_monolithic_after_a_crash(sup_problem,
                                                             tmp_path):
    cfg = _sup_cfg("bitplane")
    mono = solve_tempering(sup_problem, 7, cfg, device="cpu")
    run_dir = str(tmp_path / "run")
    with pytest.raises(SimulatedCrash):
        run_resilient(sup_problem, 7, cfg, run_dir=run_dir, device="cpu",
                      on_event=kill_after_chunk_hook(2))
    assert snapshot_steps(run_dir)[-1] == 2
    res = run_resilient(sup_problem, 7, cfg, run_dir=run_dir, device="cpu")
    assert res.resumed_from_chunk == 2 and res.stop_reason == STOP_COMPLETED
    assert res.total_chunks == 6 and res.steps_done == 120
    _assert_same(mono, res.result)


def test_resilient_tempering_resumes_after_a_budget_stop(sup_problem,
                                                         tmp_path):
    cfg = _sup_cfg()
    mono = solve_tempering(sup_problem, 7, cfg, device="cpu")
    run_dir = str(tmp_path / "run")
    stopped = run_resilient(sup_problem, 7, cfg, run_dir=run_dir,
                            budget=BudgetConfig(max_steps=60), device="cpu")
    assert stopped.stop_reason == STOP_MAX_STEPS
    assert stopped.chunks_done == 3
    res = run_resilient(sup_problem, 7, cfg, run_dir=run_dir, device="cpu")
    assert res.resumed_from_chunk == 3
    _assert_same(mono, res.result)


def test_resilient_tempering_tier_ladder(sup_problem):
    """An allocation failure at the dense store's build moves the run to
    ``bitplane``; the trajectory is unchanged."""
    cfg = _sup_cfg()
    mono = solve_tempering(sup_problem, 7, cfg, device="cpu")
    with inject_faults(oom_once_hook("store_build", fmts=("dense",))):
        res = run_resilient(sup_problem, 7, cfg, backend="tempering",
                            device="cpu")
    assert res.downgrades == (("dense", "bitplane", 0),)
    _assert_same(mono, res.result)


def test_resilient_tempering_equals_jax(sup_problem):
    """The port's supervised tempering equals the JAX package's."""
    J = sup_problem.couplings.numpy()
    h = sup_problem.fields.numpy()
    jp = jising.IsingProblem.create(J, h, offset=sup_problem.offset)
    jcfg = _jcfg(num_steps=120, t_max=5.0, num_replicas=4, swap_every=20)
    jres = jrun_resilient(jp, 7, jcfg, chunk_steps=50)
    tres = run_resilient(sup_problem, 7, _tcfg(jcfg), chunk_steps=50,
                         device="cpu")
    assert tres.total_chunks == jres.total_chunks == 6
    _assert_same(jres.result, tres.result)


def test_runner_state_round_trips_through_interop(sup_problem):
    runner = TemperingRunner(sup_problem, 7, _sup_cfg(), device="cpu")
    state = runner.run_chunk(runner.init(), 0)
    back = interop.tempering_state_from_numpy(
        interop.tempering_state_to_numpy(state))
    assert len(back) == 8
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- refusals


def test_refusals(sup_problem):
    colored = dataclasses.replace(_sup_cfg(), flip_mode="colored")
    with pytest.raises(ValueError, match="single-flip"):
        solve_tempering(sup_problem, 0, colored, device="cpu")
    with pytest.raises(ValueError, match="single-flip"):
        TemperingRunner(sup_problem, 0, colored, device="cpu")
    reference = dataclasses.replace(_sup_cfg(), backend="reference")
    with pytest.raises(ValueError, match="fused backend only"):
        TemperingRunner(sup_problem, 0, reference, device="cpu")
    with pytest.raises(ValueError, match="prebuilt CouplingStore"):
        solve_tempering(sup_problem, 0, reference, device="cpu",
                        store=tcoupling.CouplingStore.build(
                            sup_problem.couplings, "dense"))
    with pytest.raises(ValueError, match="backend must be"):
        solve_tempering(sup_problem, 0,
                        dataclasses.replace(_sup_cfg(), backend="magic"),
                        device="cpu")
    edges = ising.EdgeList.from_dense(sup_problem.couplings.numpy())
    with pytest.raises(ValueError, match="dense J"):
        solve_tempering(ising.IsingProblem.create_sparse(edges), 0,
                        reference, device="cpu")
    other = tcoupling.CouplingStore.build(
        sup_problem.couplings.clone(), "dense")
    with pytest.raises(ValueError, match="does not hold this problem"):
        solve_tempering(sup_problem, 0, _sup_cfg(), store=other,
                        device="cpu")


def test_prebuilt_store_is_reused(sup_problem):
    cfg = _sup_cfg("bitplane")
    store = tcoupling.CouplingStore.build(sup_problem.couplings, "bitplane")
    _assert_same(solve_tempering(sup_problem, 3, cfg, device="cpu"),
                 solve_tempering(sup_problem, 3, cfg, store=store,
                                 device="cpu"))
