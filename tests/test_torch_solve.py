"""The port's ``solve(..., backend="fused", device="cpu")`` against the JAX
package's ``solve(..., backend="fused")`` (the Pallas sweep in interpret
mode), on the same problem, seed and config.

* RSA + PWL, linear schedule, integer J: ``best_energy``, ``best_spins``,
  ``final_energy``, ``num_flips``, ``trace_energy`` and ``rows_fetched`` are
  bitwise equal, for 3 seeds at N=64 and N=250.
* The geometric schedule of ``default_solver``: the port's temperatures
  differ from JAX's by up to 2 ulp. Replayed with JAX's temperatures the
  port is bitwise equal; with its own it is equal unless some step's accept
  uniform lies between the two flip probabilities, which the test finds.
* RWA at solve level keeps the exact invariants; its per-step contract is in
  ``test_torch_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import snowball as jsnow
from repro.core import ising as jising
from repro.core.schedules import linear as jlinear
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import solve as jsolve
from repro_torch import interop
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.core import rng as trng
from repro_torch.core.solver import solve, solve_many
from repro_torch.kernels import common, ops, ref

FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy", "rows_fetched")
SEEDS = (0, 1, 2024)


def _problem(n, seed=0, h_scale=1.0, offset=-3.0):
    g = np.random.default_rng(seed)
    J = np.triu(np.rint(g.normal(size=(n, n)) * 1.5), 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n) * h_scale).astype(np.float32)
    return J, h, offset


def _both(J, h, offset, seed, jcfg):
    jres = jsolve(jising.IsingProblem.create(J, h, offset=offset), seed, jcfg,
                  backend="fused")
    tres = solve(interop.problem_from_numpy(J, h, offset), seed,
                 interop.config_from_dict(dataclasses.asdict(jcfg)),
                 backend="fused", device="cpu")
    return jres, tres


def _assert_equal(jres, tres, msg=""):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jres, name)),
                                      getattr(tres, name).numpy(),
                                      err_msg=f"{msg}{name}")


@pytest.mark.parametrize("n", [64, 250])
def test_rsa_pwl_linear_solve_bitwise(n):
    J, h, offset = _problem(n)
    steps = 512
    cfg = JConfig(num_steps=steps, schedule=jlinear(2.0 * np.sqrt(n), 0.05,
                                                    steps),
                  mode="rsa", trace_every=64)
    for seed in SEEDS:
        jres, tres = _both(J, h, offset, seed, cfg)
        _assert_equal(jres, tres, f"seed {seed}: ")
        assert tres.trace_energy.shape == (steps // 64, 8)
        assert int(tres.rows_fetched.sum()) == 8 * steps


def test_untraced_solve_with_remainder_chunk_bitwise():
    J, h, offset = _problem(64, seed=4)
    cfg = JConfig(num_steps=600, schedule=jlinear(8.0, 0.05, 600), mode="rsa")
    jres, tres = _both(J, h, offset, 9, cfg)
    _assert_equal(jres, tres)
    assert tres.trace_energy.shape == (0, 8)


class _TableSchedule:
    """A schedule that returns given temperatures (JAX's, in the replay)."""

    def __init__(self, temps):
        self.temps = torch.from_numpy(np.array(temps, np.float32))

    def __call__(self, t):
        return self.temps[torch.as_tensor(t).long()]


def _accept_flips(J, h, seed, tcfg, jax_temps, port_temps):
    """Replay the trajectory one step at a time on JAX's temperatures and
    list the steps whose RSA accept decision differs under the port's
    temperatures: ``(step, replica, u_accept, p_jax, p_port)``."""
    prob = tising.IsingProblem.create(J, h)
    base = trng.fold_in(trng.key(0), seed)
    state = ops.fused_init_state(prob, base, tcfg.num_replicas)
    tbl = tpwl.pwl_table(tcfg.pwl_segments, tcfg.pwl_zmax)
    chunk_len, num_chunks, rem = ops.anneal_chunk_plan(tcfg, 256)
    plan = [(c, chunk_len) for c in range(num_chunks)]
    plan += [(num_chunks, rem)] if rem else []
    n = J.shape[0]
    flips = []
    rows = torch.arange(tcfg.num_replicas)
    for c, clen in plan:
        unif = trng.uniform01(trng.stream(base, trng.Salt.SWEEP, c),
                              (clen, tcfg.num_replicas, 4))
        u, s, e = state[:3]
        for k in range(clen):
            step = c * chunk_len + k
            j = common.site_from_uniform(unif[k, :, 0], n)
            de = 2.0 * s[rows, j] * u[rows, j]
            pj = common.flip_probability(de, float(jax_temps[step]), tbl)
            pt = common.flip_probability(de, float(port_temps[step]), tbl)
            ua = unif[k, :, 1]
            for rr in torch.nonzero((ua < pj) != (ua < pt)).flatten().tolist():
                flips.append((step, rr, float(ua[rr]), float(pj[rr]),
                              float(pt[rr])))
            temps = torch.full((1, tcfg.num_replicas),
                               float(jax_temps[step]))
            u, s, e = ref.mcmc_sweep(prob.couplings, u, s, e,
                                     unif[k:k + 1].contiguous(), temps, tbl,
                                     mode="rsa")[:3]
        state = (u, s, e) + state[3:]
    return flips


@pytest.mark.parametrize("n", [64, 250])
def test_rsa_geometric_solve_equal_unless_accept_within_ulps(n):
    J, h, offset = _problem(n, seed=7)
    steps = 512
    jcfg = dataclasses.replace(jsnow.default_solver(n, steps, mode="rsa"),
                               trace_every=128)
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    t = np.arange(steps, dtype=np.int32)
    jax_temps = np.asarray(jax.vmap(jcfg.schedule)(jnp.asarray(t)),
                           np.float32)
    port_temps = tcfg.schedule(torch.from_numpy(t)).numpy()
    assert np.abs(jax_temps.astype(np.float64) - port_temps).max() <= \
        2 * np.spacing(jax_temps).max()
    replay_cfg = dataclasses.replace(tcfg,
                                     schedule=_TableSchedule(jax_temps))
    for seed in SEEDS:
        jres = jsolve(jising.IsingProblem.create(J, h, offset=offset), seed,
                      jcfg, backend="fused")
        prob = interop.problem_from_numpy(J, h, offset)
        replay = solve(prob, seed, replay_cfg, device="cpu")
        _assert_equal(jres, replay, f"replay seed {seed}: ")
        own = solve(prob, seed, tcfg, device="cpu")
        flips = _accept_flips(J, h, seed, tcfg, jax_temps, port_temps)
        if not flips:
            _assert_equal(jres, own, f"own temps seed {seed}: ")
            continue
        # A differing decision: the uniform lies between the two
        # probabilities, which are a few ulp apart.
        for step, rr, ua, pj, pt in flips:
            lo, hi = min(pj, pt), max(pj, pt)
            assert lo <= ua < hi or lo < ua <= hi
            assert hi - lo <= 8 * np.spacing(np.float32(hi))


@pytest.mark.parametrize("uniformized", [False, True])
@pytest.mark.parametrize("use_pwl", [True, False])
def test_rwa_solve_invariants(uniformized, use_pwl):
    J, h, offset = _problem(250, seed=11)
    cfg = JConfig(num_steps=384, schedule=jlinear(20.0, 0.05, 384),
                  mode="rwa", uniformized=uniformized, use_pwl=use_pwl,
                  trace_every=128)
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    prob = interop.problem_from_numpy(J, h, offset)
    res = solve(prob, 3, tcfg, device="cpu")
    assert torch.equal(res.best_energy,
                       tising.energy(prob, res.best_spins) + offset)
    assert int(res.rows_fetched.sum()) == 8 * 384
    trace = res.trace_energy
    assert trace.shape == (3, 8)
    assert bool((trace[1:] <= trace[:-1]).all())
    assert torch.equal(trace[-1], res.best_energy)
    if not uniformized:
        # p > 0 at T > 0 with the PWL table and here with the sigmoid too:
        # every step flips (rejection-free).
        assert torch.equal(res.num_flips,
                           torch.full((8,), 384, dtype=torch.int32))
    else:
        assert bool((res.num_flips <= 384).all())


def test_rwa_pwl_solve_matches_reference_on_these_seeds():
    """Summation order can split RWA only at near ties, which these runs do
    not meet: the whole solve agrees bitwise."""
    J, h, offset = _problem(64, seed=2)
    cfg = JConfig(num_steps=256, schedule=jlinear(8.0, 0.05, 256),
                  mode="rwa", trace_every=64)
    jres, tres = _both(J, h, offset, 5, cfg)
    _assert_equal(jres, tres)


def test_solve_many_stacks_independent_runs():
    J, h, offset = _problem(64, seed=1)
    cfg = interop.config_from_dict(dataclasses.asdict(
        JConfig(num_steps=128, schedule=jlinear(6.0, 0.05, 128), mode="rsa")))
    prob = interop.problem_from_numpy(J, h, offset)
    many = solve_many(prob, [3, 4], cfg, device="cpu")
    assert many.best_energy.shape == (2, 8)
    for i, seed in enumerate((3, 4)):
        one = solve(prob, seed, cfg, device="cpu")
        for name in FIELDS:
            assert torch.equal(getattr(many, name)[i], getattr(one, name))
