"""The port's reference engine (``solve(..., backend="reference")``) against
the JAX package's.

* The bit-exact anchor, RSA + PWL + integer J and h: ``best_energy``,
  ``best_spins``, ``final_energy``, ``num_flips`` and ``trace_energy`` are
  bitwise equal at N=64 (three seeds, traced) and at N=4500, where the
  site draw takes the fixed-point branch of ``rng.uniform_index``.
* RWA, one step from 512 states of a K2000-like instance (PWL, plain and
  uniformized, and the exact sigmoid): the port's sums add in another
  order than ``jnp.sum``/``jnp.cumsum``, so the picks may split where the
  roulette radius lies within 1e-5·W of a boundary (``kernels.parity``).
  Every split is such a near tie; the counts are asserted as measured (0
  splits; 22–23 states in the window).
* ``run_reference_chunk`` under any partition of the steps equals one long
  loop bitwise (geometric schedule, both modes).
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
from repro.core.schedules import linear as jlinear
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import solve as jsolve
from repro_torch import interop
from repro_torch.core import mcmc, pwl, rng, solver
from repro_torch.core.schedules import geometric
from repro_torch.kernels import parity

FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy")


def _problem(n, seed=0, scale=1.5):
    g = np.random.default_rng(seed)
    J = np.triu(np.rint(g.normal(size=(n, n)) * scale), 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    return J, h, -2.5


def _both(J, h, offset, seed, jcfg):
    jres = jsolve(jising.IsingProblem.create(J, h, offset=offset), seed, jcfg,
                  backend="reference")
    tres = solver.solve(interop.problem_from_numpy(J, h, offset), seed,
                        interop.config_from_dict(dataclasses.asdict(jcfg)),
                        backend="reference", device="cpu")
    return jres, tres


def _assert_equal(jres, tres, msg=""):
    for name in FIELDS:
        want = np.asarray(getattr(jres, name))
        got = getattr(tres, name).numpy()
        assert want.shape == got.shape, f"{msg}{name}"
        np.testing.assert_array_equal(want, got, err_msg=f"{msg}{name}")


@pytest.mark.parametrize("seed", [0, 1, 2024])
def test_reference_solve_bitwise_on_the_anchor(seed):
    J, h, offset = _problem(64)
    steps = 512
    cfg = JConfig(num_steps=steps, schedule=jlinear(16.0, 0.05, steps),
                  mode="rsa", trace_every=64)
    jres, tres = _both(J, h, offset, seed, cfg)
    _assert_equal(jres, tres, f"seed {seed}: ")
    assert tres.trace_energy.shape == (steps // 64, 8)
    assert tres.rows_fetched is None


def test_reference_solve_bitwise_untraced_and_short_traced():
    J, h, offset = _problem(64, seed=3)
    for steps, trace in ((300, 0), (10, 20)):
        cfg = JConfig(num_steps=steps, schedule=jlinear(8.0, 0.05, steps),
                      mode="rsa", num_replicas=4, trace_every=trace)
        jres, tres = _both(J, h, offset, 5, cfg)
        _assert_equal(jres, tres, f"steps {steps} trace {trace}: ")


def test_reference_solve_bitwise_past_the_float_index_branch():
    """N=4500 > FLOAT_INDEX_MAX_N: sites come from the fixed-point draw."""
    n = 4500
    assert rng.FLOAT_INDEX_MAX_N < n <= 1 << 16
    J, h, offset = _problem(n, seed=7)
    steps = 192
    cfg = JConfig(num_steps=steps, schedule=jlinear(150.0, 1.0, steps),
                  mode="rsa", trace_every=64)
    jres, tres = _both(J, h, offset, 3, cfg)
    _assert_equal(jres, tres)
    assert int(tres.num_flips.sum()) > 0


#: One RWA step from the 512 states below, port's reference against JAX's:
#: (measured splits, states whose radius lies in the 1e-5·W near-tie
#: window). Every split must be a near tie; none of the near ties split.
RWA_SPLITS = {("pwl", False): (0, 22), ("pwl", True): (0, 22),
              ("exact", False): (0, 23)}


@pytest.mark.parametrize("sigmoid,uniformized", sorted(RWA_SPLITS))
def test_rwa_one_step_splits_only_at_near_ties(sigmoid, uniformized):
    n, r = 2000, 512
    g = np.random.default_rng(2000)
    J = np.triu(np.where(g.random((n, n)) < 0.5, 1.0, -1.0), 1)
    J = (J + J.T).astype(np.float32)
    h = np.zeros(n, np.float32)
    jp = jising.IsingProblem.create(J, h)
    tp = interop.problem_from_numpy(J, h)
    base = jax.random.fold_in(jax.random.key(0), 17)
    keys = jax.vmap(lambda i: jrng.stream(base, i))(jnp.arange(r))
    spins = jax.vmap(lambda k: jising.random_spins(k, (n,)))(keys)
    jstate = jax.vmap(jmcmc.init_chain, in_axes=(None, 0))(jp, spins)
    tstate = interop.chain_state_from_numpy([np.asarray(x) for x in jstate])
    temps = np.geomspace(0.5, 90.0, r).astype(np.float32)
    use_pwl = sigmoid == "pwl"
    jfp = jpwl.pwl_flip_probability if use_pwl else jpwl.exact_flip_probability
    tfp = pwl.pwl_flip_probability if use_pwl else pwl.exact_flip_probability
    jcfg = jmcmc.MCMCConfig(mode="rwa", uniformized=uniformized, flip_prob=jfp)
    tcfg = mcmc.MCMCConfig(mode="rwa", uniformized=uniformized, flip_prob=tfp)
    step_keys = jax.vmap(lambda k: jrng.stream(k, 123))(keys)
    jnew, jinfo = jax.jit(jax.vmap(
        lambda st, k, t: jmcmc.rwa_step(jp, st, k, t, jcfg)))(
            jstate, step_keys, jnp.asarray(temps))
    tkeys = rng.stream(rng.stream(rng.fold_in(rng.key(0), 17),
                                  torch.arange(r)), 123)
    tnew, tinfo = mcmc.rwa_step(tp, tstate, tkeys,
                                torch.from_numpy(temps)[:, None], tcfg)
    split = ((np.asarray(jinfo.site) != tinfo.site.numpy())
             | (np.asarray(jinfo.accepted) != tinfo.accepted.numpy()))
    draws = mcmc.step_draws(tkeys, n, tcfg)
    p = tfp(2.0 * tstate.spins.float() * tstate.fields,
            torch.from_numpy(temps)[:, None])
    unif = (draws.uniformize if uniformized
            else torch.zeros_like(draws.roulette))
    tie = parity.roulette_near_tie(p, draws.roulette, unif,
                                   uniformized).numpy()
    assert not (split & ~tie).any(), np.nonzero(split & ~tie)
    assert (int(split.sum()), int(tie.sum())) == RWA_SPLITS[
        (sigmoid, uniformized)]
    for name, want, got in zip(mcmc.ChainState._fields, jnew, tnew):
        np.testing.assert_array_equal(np.asarray(want)[~split],
                                      got.numpy()[~split], err_msg=name)


@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_reference_chunks_compose_under_any_partition(mode):
    J, h, offset = _problem(40, seed=9)
    problem = interop.problem_from_numpy(J, h, offset)
    steps = 150
    cfg = solver.SolverConfig(num_steps=steps,
                              schedule=geometric(9.0, 0.05, steps),
                              mode=mode, num_replicas=6, use_pwl=True)
    mc = solver._mcmc_config(cfg)
    temps = solver.step_temperatures(cfg.schedule, steps)
    start, keys = solver.reference_init_state(problem, 11, cfg)
    whole = solver.run_reference_chunk(problem, start, keys, 0, clen=steps,
                                       chunk_len=steps, mc=mc, temps=temps)
    g = np.random.default_rng(0)
    for _ in range(3):
        cuts = np.sort(g.choice(np.arange(1, steps), size=7, replace=False))
        states, at = start, 0
        for stop in list(cuts) + [steps]:
            # chunk_len 1 makes chunk c start at global step c.
            states = solver.run_reference_chunk(
                problem, states, keys, at, clen=int(stop - at), chunk_len=1,
                mc=mc, temps=temps[at:stop])
            at = int(stop)
        for name, a, b in zip(mcmc.ChainState._fields, whole, states):
            assert torch.equal(a, b), name


def test_step_temperatures_do_not_depend_on_the_call():
    """A geometric temperature is the schedule at its own scalar step, so
    the table's entries equal one-step calls at any offset."""
    sched = geometric(44.72136, 0.05, 20000)
    table = solver.step_temperatures(sched, 20000)
    for t in (0, 1, 7, 8, 15, 16, 9999, 19999):
        assert torch.equal(table[t], sched(torch.tensor(t, dtype=torch.int32)))
