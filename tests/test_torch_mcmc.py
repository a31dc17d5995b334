"""The reference engine's pieces against the JAX package: the site draw, the
flip probabilities, the Ising helpers and one dual-mode step, then the
ports of ``tests/test_core_mcmc.py``'s chain-law cases.

Tolerances:

* ``rng.uniform_index`` is bitwise on all three of its branches (the float
  rescale up to N=4096, the fixed point up to 2¹⁶, ``randint`` above), and
  so are ``rng.split`` and ``rng.randint`` against ``jax.random``.
* ``make_pwl_sigmoid`` and the PWL ``make_flip_probability`` are bitwise
  against the jitted JAX versions (XLA contracts the PWL's multiply-add
  into one FMA; the port rounds once too); the exact sigmoid is within
  4 ulp, as in ``tests/test_torch_core.py``.
* One ``rsa_step`` from the same ``ChainState`` is bitwise (PWL, integer J
  and h); one ``rwa_step``, plain or uniformized, is bitwise except where
  the roulette radius is a near tie (``kernels.parity``), which these
  states do not meet; the degenerate-W fallback and the uniformized null
  transition pick JAX's site and decision.
* The chain-law cases hold the JAX tests' gates (TV < 0.05 and 0.06).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core import mcmc as jmcmc
from repro.core import pwl as jpwl
from repro.core import rng as jrng
from repro_torch import interop
from repro_torch.core import ising, mcmc, pwl, rng, solver
from repro_torch.core.schedules import constant, geometric
from repro_torch.kernels import parity


def _jax_keys(seed, count):
    base = jax.random.fold_in(jax.random.key(0), seed)
    return jax.vmap(lambda i: jrng.stream(base, i))(jnp.arange(count))


def _port_keys(seed, count):
    return rng.stream(rng.fold_in(rng.key(0), seed), torch.arange(count))


# ------------------------------------------------------------ site draws

@pytest.mark.parametrize("n", [7, 4096, 4097, 65536, 65537, 1 << 20])
def test_uniform_index_bitwise_on_every_branch(n):
    for seed in (0, 5):
        jk = _jax_keys(seed, 4000)
        want = np.asarray(jax.vmap(lambda k: jrng.uniform_index(k, n))(jk))
        got = rng.uniform_index(_port_keys(seed, 4000), n).numpy()
        np.testing.assert_array_equal(want, got)
        assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("n", [3, 1000, 65537, 100_003, 1 << 20,
                               (1 << 31) - 1])
def test_randint_and_split_bitwise_on_keys(n):
    """The ``randint`` branch needs N past 2¹⁶ spins (a dense J of 17 GB
    there), so it is held on keys alone, against ``jax.random``."""
    jk = _jax_keys(11, 2000)
    tk = _port_keys(11, 2000)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (), 0, n, dtype=jnp.int32))(jk))
    np.testing.assert_array_equal(want, rng.randint(tk, n).numpy())
    splits = np.asarray(jax.vmap(lambda k: jax.random.key_data(
        jax.random.split(k, 3)))(jk))
    np.testing.assert_array_equal(splits, rng.split(tk, 3).numpy())


# ---------------------------------------------------- flip probabilities

def _grid():
    x = np.linspace(-9.0, 9.0, 1_000_001).astype(np.float32)
    extra = np.random.default_rng(0).normal(size=200_000) * 4.0
    knots = np.linspace(-8.0, 8.0, 65).astype(np.float32)
    return np.concatenate([x, extra.astype(np.float32), knots,
                           np.nextafter(knots, np.float32(np.inf)),
                           np.float32([-0.0, 1e-30, -1e-30])])


@pytest.mark.parametrize("segments,z_max", [(64, 8.0), (32, 6.0),
                                            (100, 7.5)])
def test_pwl_sigmoid_bitwise_against_jitted_reference(segments, z_max):
    x = _grid()
    want = np.asarray(jax.jit(jpwl.make_pwl_sigmoid(segments, z_max))(
        jnp.asarray(x)))
    got = pwl.make_pwl_sigmoid(segments, z_max)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tiny = np.finfo(np.float32).tiny
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float64)
    out = gap / ulp
    out[(np.abs(a) < tiny) & (np.abs(b) < tiny)] = 0.0
    return out


@pytest.mark.parametrize("temperature", [-1.0, 0.0, 0.05, 1.0, 2.3, 40.0])
def test_flip_probability_pwl_bitwise_exact_within_four_ulp(temperature):
    de = np.rint(np.random.default_rng(1).normal(size=100_000) * 20)
    de = np.concatenate([de, [0.0, -0.0, 2.0, -2.0]]).astype(np.float32)
    t = np.float32(temperature)
    jp = jax.jit(jpwl.pwl_flip_probability)(jnp.asarray(de), t)
    tp = pwl.pwl_flip_probability(torch.from_numpy(de), torch.tensor(t))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    je = jax.jit(jpwl.exact_flip_probability)(jnp.asarray(de), t)
    te = pwl.exact_flip_probability(torch.from_numpy(de), torch.tensor(t))
    assert _ulps(np.asarray(je), te.numpy()).max() <= 4
    assert pwl.pwl_error_bound(64, 8.0) == jpwl.pwl_error_bound(64, 8.0)


# ---------------------------------------------------------- Ising helpers

def _problem(n, seed=0, scale=1.5):
    g = np.random.default_rng(seed)
    J = np.triu(np.rint(g.normal(size=(n, n)) * scale), 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    return J, h


def test_delta_energies_and_incremental_update_bitwise():
    J, h = _problem(40, seed=3)
    jp = jising.IsingProblem.create(J, h)
    tp = interop.problem_from_numpy(J, h)
    s = np.where(np.random.default_rng(2).random((5, 40)) < 0.5, 1, -1)
    s = s.astype(np.int8)
    want = np.asarray(jax.vmap(lambda x: jising.delta_energies(jp, x))(
        jnp.asarray(s)))
    got = ising.delta_energies(tp, torch.from_numpy(s))
    np.testing.assert_array_equal(want, got.numpy())
    u = ising.local_fields(tp, torch.from_numpy(s))
    j = torch.tensor([0, 7, 39, 7, 12])
    s_old = torch.from_numpy(s)[torch.arange(5), j]
    got = ising.incremental_field_update(tp.couplings, u, j, s_old)
    want = np.stack([np.asarray(jising.incremental_field_update(
        jp.couplings, jnp.asarray(u[r].numpy()), int(j[r]),
        jnp.int8(int(s_old[r])))) for r in range(5)])
    np.testing.assert_array_equal(want, got.numpy())


# ------------------------------------------------------------- one step

def _states(J, h, r, seed):
    """A JAX ChainState batch (vmapped init) and the port's copy of it."""
    jp = jising.IsingProblem.create(J, h)
    keys = _jax_keys(seed, r)
    spins = jax.vmap(lambda k: jising.random_spins(k, (J.shape[0],)))(keys)
    jstate = jax.vmap(jmcmc.init_chain, in_axes=(None, 0))(jp, spins)
    tstate = interop.chain_state_from_numpy([np.asarray(x) for x in jstate])
    return jp, interop.problem_from_numpy(J, h), jstate, tstate


def _jax_step(fn, jp, jstate, keys, temps, cfg):
    return jax.jit(jax.vmap(lambda st, k, t: fn(jp, st, k, t, cfg)))(
        jstate, keys, temps)


def _assert_state_equal(jstate, tstate, rows=None):
    for name, want, got in zip(mcmc.ChainState._fields, jstate, tstate):
        want, got = np.asarray(want), got.numpy()
        if rows is not None:
            want, got = want[rows], got[rows]
        np.testing.assert_array_equal(want, got, err_msg=name)


def _configs(mode, uniformized=False, use_pwl=True):
    jfp = (jpwl.pwl_flip_probability if use_pwl
           else jpwl.exact_flip_probability)
    tfp = pwl.pwl_flip_probability if use_pwl else pwl.exact_flip_probability
    return (jmcmc.MCMCConfig(mode=mode, uniformized=uniformized,
                             flip_prob=jfp),
            mcmc.MCMCConfig(mode=mode, uniformized=uniformized,
                            flip_prob=tfp))


@pytest.mark.parametrize("n", [48, 4500])
def test_rsa_step_bitwise_from_the_same_state(n):
    J, h = _problem(n, seed=n)
    r = 24
    jp, tp, jstate, tstate = _states(J, h, r, seed=1)
    temps = np.linspace(0.0, 3.0 * np.sqrt(n), r).astype(np.float32)
    jcfg, tcfg = _configs("rsa")
    for step_seed in (2, 3):
        keys = _jax_keys(step_seed, r)
        jnew, jinfo = _jax_step(jmcmc.rsa_step, jp, jstate, keys,
                                jnp.asarray(temps), jcfg)
        tnew, tinfo = mcmc.rsa_step(
            tp, tstate, _port_keys(step_seed, r), torch.from_numpy(temps),
            tcfg)
        _assert_state_equal(jnew, tnew)
        np.testing.assert_array_equal(np.asarray(jinfo.site),
                                      tinfo.site.numpy())
        np.testing.assert_array_equal(np.asarray(jinfo.accepted),
                                      tinfo.accepted.numpy())
        jstate, tstate = jnew, tnew


@pytest.mark.parametrize("uniformized", [False, True])
def test_rwa_step_bitwise_from_the_same_state_except_near_ties(uniformized):
    J, h = _problem(96, seed=4)
    r = 64
    jp, tp, jstate, tstate = _states(J, h, r, seed=6)
    temps = np.linspace(0.2, 30.0, r).astype(np.float32)
    jcfg, tcfg = _configs("rwa", uniformized)
    keys = _jax_keys(9, r)
    jnew, jinfo = _jax_step(jmcmc.rwa_step, jp, jstate, keys,
                            jnp.asarray(temps), jcfg)
    tnew, tinfo = mcmc.rwa_step(tp, tstate, _port_keys(9, r),
                                torch.from_numpy(temps)[:, None], tcfg)
    same = ((np.asarray(jinfo.site) == tinfo.site.numpy())
            & (np.asarray(jinfo.accepted) == tinfo.accepted.numpy()))
    if not same.all():
        draws = mcmc.step_draws(_port_keys(9, r), 96, tcfg)
        de = 2.0 * tstate.spins.float() * tstate.fields
        p = tcfg.flip_prob(de, torch.from_numpy(temps)[:, None])
        unif = (draws.uniformize if uniformized
                else torch.zeros_like(draws.roulette))
        tie = parity.roulette_near_tie(p, draws.roulette, unif, uniformized)
        assert bool(tie[torch.from_numpy(~same)].all())
    _assert_state_equal(jnew, tnew, rows=same)
    assert same.sum() >= r - 1


@pytest.mark.parametrize("uniformized", [False, True])
def test_degenerate_weights_fallback_and_null_transition(uniformized):
    """All-up ferromagnet at T=0: every flip is uphill, W = 0. Plain RWA
    falls back to one random-scan update (which rejects: the site is
    JAX's); uniformized RWA makes a null transition."""
    n, r = 5, 6
    J = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    h = np.zeros(n, np.float32)
    jp = jising.IsingProblem.create(J, h)
    up = jnp.ones((r, n), jnp.int8)
    jstate = jax.vmap(jmcmc.init_chain, in_axes=(None, 0))(jp, up)
    tstate = interop.chain_state_from_numpy([np.asarray(x) for x in jstate])
    tp = interop.problem_from_numpy(J, h)
    jcfg, tcfg = _configs("rwa", uniformized, use_pwl=False)
    zeros = np.zeros(r, np.float32)
    for t in range(8):
        keys = _jax_keys(100 + t, r)
        jstate, jinfo = _jax_step(jmcmc.rwa_step, jp, jstate, keys,
                                  jnp.asarray(zeros), jcfg)
        tstate, tinfo = mcmc.rwa_step(tp, tstate, _port_keys(100 + t, r),
                                      torch.from_numpy(zeros)[:, None], tcfg)
        assert not tinfo.accepted.any()
        np.testing.assert_array_equal(np.asarray(jinfo.site),
                                      tinfo.site.numpy())
        _assert_state_equal(jstate, tstate)
    assert bool((tstate.spins == 1).all())
    assert bool(torch.isfinite(tstate.energy).all())


def test_chain_state_round_trips_through_numpy():
    J, h = _problem(16, seed=8)
    _, _, jstate, tstate = _states(J, h, 3, seed=2)
    back = interop.chain_state_to_numpy(tstate)
    for want, got in zip(jstate, back):
        assert np.asarray(want).dtype == got.dtype
        np.testing.assert_array_equal(np.asarray(want), got)


# ------------------------------------- ports of tests/test_core_mcmc.py

def _tiny_problem(seed=0, n=4):
    g = np.random.default_rng(seed)
    J = np.rint(g.normal(size=(n, n)) * 1.5)
    J = np.triu(J, 1)
    J = J + J.T
    h = np.rint(g.normal(size=n))
    return ising.IsingProblem.create(J=J, h=h)


def _gibbs(problem, T):
    _, _, all_e = ising.brute_force_ground_state(problem)
    w = np.exp(-(all_e - all_e.min()) / T)
    return w / w.sum()


def _spins_to_index(spins):
    bits = (np.asarray(spins) + 1) // 2
    return (bits * (1 << np.arange(bits.shape[-1]))).sum(-1)


def _chain_histogram(problem, mc, T, r=256, chunks=300, chunk=8,
                     burn_chunks=25, seed=0):
    """R chains of the reference engine at fixed T, sampled every ``chunk``
    steps after burn-in and pooled (the JAX test samples every step of one
    chain; R chains in a batch are what the port's engine runs fast)."""
    steps = chunks * chunk
    cfg = solver.SolverConfig(num_steps=steps, schedule=constant(T, steps),
                              num_replicas=r)
    states, keys = solver.reference_init_state(problem, seed, cfg)
    temps = solver.step_temperatures(cfg.schedule, steps)
    hist = np.zeros(2 ** problem.num_spins)
    for c in range(chunks):
        states = solver.run_reference_chunk(
            problem, states, keys, c, clen=chunk, chunk_len=chunk, mc=mc,
            temps=temps[c * chunk:(c + 1) * chunk])
        if c >= burn_chunks:
            hist += np.bincount(_spins_to_index(states.spins.numpy()),
                                minlength=hist.size)
    return hist / hist.sum()


@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_rsa_converges_to_gibbs(temperature):
    problem = _tiny_problem(seed=1, n=4)
    mc = mcmc.MCMCConfig(mode="rsa")
    emp = _chain_histogram(problem, mc, temperature)
    tv = 0.5 * np.abs(emp - _gibbs(problem, temperature)).sum()
    assert tv < 0.05, f"total variation {tv:.3f} too large"


def test_uniformized_rwa_converges_to_gibbs():
    problem = _tiny_problem(seed=2, n=4)
    mc = mcmc.MCMCConfig(mode="rwa", uniformized=True)
    emp = _chain_histogram(problem, mc, 1.5)
    tv = 0.5 * np.abs(emp - _gibbs(problem, 1.5)).sum()
    assert tv < 0.06, f"total variation {tv:.3f} too large"


def test_rwa_is_rejection_free_when_weights_positive():
    problem = _tiny_problem(seed=3, n=6)
    cfg = mcmc.MCMCConfig(mode="rwa")
    key = rng.key(0)
    state = mcmc.init_chain(problem, ising.random_spins(key, (6,)))
    for t in range(200):
        new_state, info = mcmc.step(problem, state, rng.stream(key, t),
                                    torch.tensor(1.0), cfg)
        changed = int((new_state.spins != state.spins).sum())
        assert changed == 1 and bool(info.accepted)
        state = new_state
    assert int(state.num_flips) == 200


@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_long_run_energy_bookkeeping(mode):
    problem = _tiny_problem(seed=4, n=16)
    cfg = solver.SolverConfig(num_steps=5000,
                              schedule=geometric(5.0, 0.01, 5000), mode=mode,
                              num_replicas=3, use_pwl=False)
    res = solver.solve(problem, 7, cfg, backend="reference", device="cpu")
    recomputed = ising.energy(problem, res.best_spins).numpy()
    np.testing.assert_allclose(res.best_energy.numpy(), recomputed,
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("mode,uniformized", [("rsa", False), ("rwa", False),
                                              ("rwa", True)])
def test_solver_finds_small_ground_state(mode, uniformized):
    problem = _tiny_problem(seed=5, n=10)
    e_star, _, _ = ising.brute_force_ground_state(problem)
    cfg = solver.SolverConfig(num_steps=4000,
                              schedule=geometric(6.0, 0.02, 4000), mode=mode,
                              uniformized=uniformized, num_replicas=8)
    res = solver.solve(problem, 0, cfg, backend="reference", device="cpu")
    assert float(res.best_energy.min()) == pytest.approx(e_star, abs=1e-2)


def test_deterministic_given_seed():
    problem = _tiny_problem(seed=6, n=12)
    cfg = solver.SolverConfig(num_steps=500,
                              schedule=geometric(4.0, 0.1, 500), mode="rwa",
                              num_replicas=4)
    r1 = solver.solve(problem, 42, cfg, backend="reference", device="cpu")
    r2 = solver.solve(problem, 42, cfg, backend="reference", device="cpu")
    assert torch.equal(r1.best_spins, r2.best_spins)
    assert torch.equal(r1.best_energy, r2.best_energy)
    hot = dataclasses.replace(cfg, schedule=constant(50.0, 500))
    h1 = solver.solve(problem, 42, hot, backend="reference", device="cpu")
    h2 = solver.solve(problem, 43, hot, backend="reference", device="cpu")
    assert not torch.equal(h1.final_energy, h2.final_energy)
