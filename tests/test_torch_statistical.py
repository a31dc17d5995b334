"""Statistical tier: the port's chains sample the right distribution. Port of
``tests/test_statistical_correctness.py``, with its gates: χ² below twice
the α=1e-4 critical value, TV < 0.05, TV at a wrong temperature (2T, T/2)
more than 3× the TV at T, and cross-mode TV < 0.07.

Step parity (the other test files) cannot see a rule both sides share, and
RWA's picks and the exact sigmoid are not bitwise anyway; the enumerated
Boltzmann law of an N ≤ 12 instance can. The chains:

* RSA and uniformized RWA on the port's keyed sweep chunk
  (``ops.keyed_sweep_chunk``: the plain version here, kernel A with the
  ``cuda`` marker) and on the reference engine (``core.mcmc``);
* the colored chain (``ops.colored_sweep_chunk``: plain here, kernel D on
  the card);
* plain RWA, which is rejection-free and not Boltzmann-stationary: its
  jump chain's stationary law is π(s)·W(s), so chunk-boundary samples
  weighted by 1/W(s) must give the Boltzmann law (TV gate and power
  checks); and from one fixed state the roulette's picks over many chunk
  keys must follow p_i/W (sites in 32 bins of equal mass, χ² gate; 64 bins
  at N=16384 in ``chip_smoke.py``'s ``[stat]`` phase);
* at T=0, stochastic greedy descent: the energy never rises between chunk
  boundaries, and the tracked energies match a recomputation.

The card twins (``-m cuda``) skip here. Each chain pools R=64 replicas at
120 chunk boundaries (7,680 samples, as the JAX test's R=16 × 480).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import ising, rng, solver
from repro_torch.core.coupling import CouplingStore
from repro_torch.core.pwl import pwl_table
from repro_torch.core.schedules import constant
from repro_torch.kernels import ops, parity

R = 64
CHUNK = 48
CHUNKS = 130
BURN = 10
TEMP = 2.5


def _tiny_problem(seed=11, n=6, scale=1.2):
    g = np.random.default_rng(seed)
    J = np.rint(g.normal(size=(n, n)) * scale)
    J = np.triu(J, 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    return ising.IsingProblem.create(J=J, h=h)


def _tiny_sparse_problem(seed=13, n=7, m=10):
    g = np.random.default_rng(seed)
    i = g.integers(0, n, size=m)
    j = g.integers(0, n, size=m)
    keep = i != j
    w = g.choice([-2, -1, 1, 2], size=m)
    edges = ising.EdgeList.create(i[keep], j[keep], w[keep], n)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    return ising.IsingProblem.create_sparse(edges, h=h)


def _state_index(spins):
    return parity.state_index(torch.as_tensor(spins)).numpy()


def _assert_boltzmann(counts, problem, temp=TEMP, weights=None):
    g = parity.boltzmann_gates(counts, problem, temp, weights)
    assert parity.gates_pass(g), g


# ------------------------------------------------------------------ chains


@functools.cache
def _sweep_chain(mode, uniformized, temp, device="cpu", problem_seed=11,
                 n=6, chunks=CHUNKS, burn=BURN):
    """Fixed-T chain on the keyed sweep chunk: ``(energies per chunk,
    pooled state indices, final state)``."""
    problem = _tiny_problem(problem_seed, n).to(device)
    return parity.sweep_chain(problem, temp, mode=mode,
                              uniformized=uniformized, r=R, chunk=CHUNK,
                              chunks=chunks, burn=burn)


@functools.cache
def _reference_chain(mode, uniformized, temp, seed=3):
    """The same chain on the reference engine (``core.mcmc``)."""
    problem = _tiny_problem()
    steps = CHUNKS * CHUNK
    cfg = solver.SolverConfig(num_steps=steps, schedule=constant(temp, steps),
                              mode=mode, uniformized=uniformized,
                              use_pwl=False, num_replicas=R)
    mc = solver._mcmc_config(cfg)
    states, keys = solver.reference_init_state(problem, seed, cfg)
    temps = solver.step_temperatures(cfg.schedule, steps)
    samples = []
    for c in range(CHUNKS):
        states = solver.run_reference_chunk(
            problem, states, keys, c, clen=CHUNK, chunk_len=CHUNK, mc=mc,
            temps=temps[c * CHUNK:(c + 1) * CHUNK])
        if c >= BURN:
            samples.append(_state_index(states.spins.numpy()))
    return np.concatenate(samples)


@functools.cache
def _colored_chain(temp, device="cpu", problem_seed=13, n=7, m=10,
                   chunks=CHUNKS, burn=BURN):
    """The colored chain, with the permuted dense problem to enumerate its
    color-sorted samples in the same basis."""
    problem = _tiny_sparse_problem(problem_seed, n, m)
    plan = ops.colored_plan(problem, "bitplane").to(device)
    pdense = ising.IsingProblem.create(plan.problem.edges.to_dense(),
                                       h=plan.problem.fields.cpu().numpy())
    energies, idx, _ = parity.colored_chain(plan, temp, r=R, chunk=CHUNK,
                                            chunks=chunks, burn=burn)
    return energies, idx, pdense


def _counts(idx, n):
    return np.bincount(idx, minlength=2 ** n).astype(np.float64)


BOLTZMANN_MODES = [("rsa", False), ("rwa", True)]


# ------------------------------------------------- Boltzmann-stationary

@pytest.mark.parametrize("mode,uniformized", BOLTZMANN_MODES)
def test_sweep_chain_samples_boltzmann(mode, uniformized):
    _, idx, _ = _sweep_chain(mode, uniformized, TEMP)
    _assert_boltzmann(_counts(idx, 6), _tiny_problem())


@pytest.mark.parametrize("mode,uniformized", BOLTZMANN_MODES)
def test_reference_chain_samples_boltzmann(mode, uniformized):
    idx = _reference_chain(mode, uniformized, TEMP)
    _assert_boltzmann(_counts(idx, 6), _tiny_problem())


def test_uniformized_rwa_matches_rsa_distribution():
    rsa = _counts(_sweep_chain("rsa", False, TEMP)[1], 6)
    rwa = _counts(_sweep_chain("rwa", True, TEMP)[1], 6)
    assert parity.tv_distance(rsa, rwa / rwa.sum()) < 0.07


def test_reference_matches_sweep_distribution():
    """The reference engine and the sweep's plain version run other random
    streams; their laws must agree within the cross-mode gate."""
    for mode, uniformized in BOLTZMANN_MODES:
        a = _counts(_sweep_chain(mode, uniformized, TEMP)[1], 6)
        b = _counts(_reference_chain(mode, uniformized, TEMP), 6)
        assert parity.tv_distance(a, b / b.sum()) < 0.07, mode


def test_colored_chain_samples_boltzmann():
    _, idx, pdense = _colored_chain(TEMP)
    _assert_boltzmann(_counts(idx, 7), pdense)


def test_colored_chain_matches_rsa_distribution():
    _, idx_c, pdense = _colored_chain(TEMP)
    # The RSA chain on the same (color-sorted) instance.
    _, idx_s, _ = parity.sweep_chain(pdense, TEMP, mode="rsa", r=R,
                                     chunk=CHUNK, chunks=CHUNKS, burn=BURN)
    a = _counts(idx_c, 7)
    b = _counts(idx_s, 7)
    assert parity.tv_distance(a, b / b.sum()) < 0.07


# ------------------------------------------------------------- plain RWA

def _assert_jump_chain(idx, problem, temp=TEMP):
    """Samples of the rejection-free chain, each weighted by 1/W(s), give
    the Boltzmann law; unweighted they do not (the test can tell)."""
    counts = _counts(idx, problem.num_spins)
    w = 1.0 / parity.total_weight(problem, temp)
    _assert_boltzmann(counts, problem, temp, weights=w)
    assert (parity.tv_distance(counts, parity.boltzmann(problem, temp))
            > parity.boltzmann_gates(counts, problem, temp, w)["tv"])


def test_plain_rwa_jump_chain_weighted_by_inverse_w_is_boltzmann():
    _, idx, _ = _sweep_chain("rwa", False, TEMP)
    _assert_jump_chain(idx, _tiny_problem())


def test_reference_plain_rwa_jump_chain_is_boltzmann():
    _assert_jump_chain(_reference_chain("rwa", False, TEMP), _tiny_problem())


def _pick_law(device, n=512, r=128, keys=500, bins=32, seed=5):
    """One fixed state of a ±1 K_n copied to R replicas, one RWA step per
    chunk key: the flipped sites against p_i/W."""
    g = np.random.default_rng(seed)
    J = np.triu(np.where(g.random((n, n)) < 0.5, 1.0, -1.0), 1)
    problem = ising.IsingProblem.create(J + J.T, device=device)
    state = ops.fused_init_state(problem, rng.fold_in(rng.key(0), seed), 1)
    u, s, e = (x.expand((r,) + tuple(x.shape[1:])).contiguous()
               for x in state[:3])
    store = CouplingStore.build(problem.couplings, "dense")
    picks, p = parity.roulette_picks(store, u, s, e, float(np.sqrt(n)),
                                     pwl_table(device=device), keys=keys)
    return parity.pick_law_chi2(p, picks, bins)


def test_rwa_pick_law_follows_p_over_w():
    x2, df, crit = _pick_law("cpu")
    assert df == 31
    assert x2 < 2.0 * crit, (x2, crit)


def test_pick_law_gate_has_power():
    """The gate fails a roulette that picks uniformly."""
    p = np.linspace(0.05, 1.0, 512)
    picks = np.random.default_rng(0).integers(0, 512, size=64_000)
    x2, _, crit = parity.pick_law_chi2(p, picks, 32)
    assert x2 > 2.0 * crit


# -------------------------------------------------------------- T = 0

@pytest.mark.parametrize("mode,uniformized", BOLTZMANN_MODES)
def test_zero_temperature_descent_is_monotone(mode, uniformized):
    energies, _, _ = _sweep_chain(mode, uniformized, 0.0, problem_seed=5,
                                  n=10, chunks=12, burn=12)
    assert np.isfinite(energies).all()
    assert (np.diff(energies, axis=0) <= 1e-6).all(), \
        "zero-T chain increased energy"


def test_colored_zero_temperature_descent_is_monotone():
    energies, _, _ = _colored_chain(0.0, problem_seed=2, n=10, m=18,
                                    chunks=12, burn=12)
    assert np.isfinite(energies).all()
    assert (np.diff(energies, axis=0) <= 1e-6).all(), \
        "zero-T colored chain increased energy"


def test_zero_temperature_energy_bookkeeping_consistent():
    problem = _tiny_problem(seed=5, n=10)
    _, _, (_, s, e, be, bs, _) = _sweep_chain(
        "rsa", False, 0.0, problem_seed=5, n=10, chunks=12, burn=12)
    np.testing.assert_allclose(e.numpy(), ising.energy(problem, s).numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(be.numpy(), ising.energy(problem, bs).numpy(),
                               atol=1e-3)


# ------------------------------------------------- the card's kernels

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: kernels A and D run only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("mode,uniformized", BOLTZMANN_MODES)
def test_sweep_kernel_chain_samples_boltzmann(cuda_device, mode,
                                              uniformized):
    _, idx, _ = _sweep_chain(mode, uniformized, TEMP, cuda_device)
    _assert_boltzmann(_counts(idx, 6), _tiny_problem())


@pytest.mark.cuda
def test_sweep_kernel_jump_chain_is_boltzmann(cuda_device):
    _, idx, _ = _sweep_chain("rwa", False, TEMP, cuda_device)
    _assert_jump_chain(idx, _tiny_problem())


@pytest.mark.cuda
def test_colored_kernel_chain_samples_boltzmann(cuda_device):
    _, idx, pdense = _colored_chain(TEMP, cuda_device)
    _assert_boltzmann(_counts(idx, 7), pdense)


@pytest.mark.cuda
def test_sweep_kernel_pick_law(cuda_device):
    x2, df, crit = _pick_law(cuda_device, n=2048, r=64, keys=1000, bins=64)
    assert x2 < 2.0 * crit, (x2, crit)


def test_chi2_critical_value():
    assert abs(parity.chi2_critical(31) - 69.1057) < 1e-3
