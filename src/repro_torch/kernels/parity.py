"""The parity contract of the roulette paths, shared by the tests and
``chip_smoke.py``.

RSA with the PWL table and integer J is bit-exact everywhere. The RWA
roulette adds its block and lane sums in another order in each
implementation, so two implementations may pick different sites when the
roulette radius lies within a rounding error of a cumulative boundary. Such
a step is a near tie; every other step must agree exactly.

What cannot be held bitwise (RWA's picks, the exact sigmoid) is held to the
statistical tier as well: a chain at fixed T on an enumerable instance
samples the Boltzmann law (χ² and TV gates, with wrong-temperature power
checks), plain RWA's jump chain reweighted by 1/W(s) does too, and the
roulette's picks from one state follow p_i/W.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import ising, rng
from . import ops
from .common import flip_probability

#: A step is a near tie when the radius lies within this fraction of the
#: total weight W of a cumulative boundary (or, uniformized, u·N of W).
NEAR_TIE_REL = 1e-5


def roulette_near_tie(p_all: torch.Tensor, u_roulette: torch.Tensor,
                      u_uniformize: torch.Tensor, uniformized: bool,
                      rel: float = NEAR_TIE_REL) -> torch.Tensor:
    """(R,) bool: steps whose pick (or uniformized accept) can depend on the
    order of the float sums. Boundaries are recomputed in float64 from the
    f32 weights ``p_all`` (R, N)."""
    p = p_all.to(torch.float64)
    cum = torch.cumsum(p, dim=1)
    total = cum[:, -1]
    radius = u_roulette.to(torch.float64) * total
    gap = (cum - radius[:, None]).abs().min(dim=1).values
    tie = (total > 0) & (gap < rel * total)
    if uniformized:
        n = p.shape[1]
        accept_gap = (u_uniformize.to(torch.float64) * n - total).abs()
        tie |= (total > 0) & (accept_gap < rel * total)
    return tie


# --------------------------------------------------------------------------
# The statistical tier: what a chain must sample, and the gates.

def all_spins(n: int) -> torch.Tensor:
    """(2^n, n) f32 ±1 configurations; row k has spin j up iff bit j of k."""
    idx = torch.arange(2 ** n)
    return torch.where((idx[:, None] >> torch.arange(n)) & 1 == 1, 1.0, -1.0)


def state_index(spins: torch.Tensor) -> torch.Tensor:
    """(...,) int64 row of :func:`all_spins` for (..., n) ±1 spins."""
    bits = (spins > 0).to(torch.int64)
    return (bits << torch.arange(spins.shape[-1], device=spins.device)).sum(-1)


def boltzmann(problem, temp: float) -> np.ndarray:
    """The exact law p(s) ∝ exp(−E(s)/T) over all 2^N states (a dense
    problem, N ≤ 20), in float64."""
    e = ising.energy(problem.to("cpu"), all_spins(problem.num_spins))
    e = e.double().numpy()
    w = np.exp(-(e - e.min()) / temp)
    return w / w.sum()


def total_weight(problem, temp: float) -> np.ndarray:
    """W(s) = Σ_i σ(−ΔE_i/T) of every state, float64, exact sigmoid: the
    rate at which plain RWA leaves s. Its jump chain's stationary law is
    π(s)·W(s), so samples weighted by 1/W(s) follow π."""
    s = all_spins(problem.num_spins).double().numpy()
    u = (s @ problem.couplings.double().cpu().numpy()
         + problem.fields.double().cpu().numpy())
    return (1.0 / (1.0 + np.exp(2.0 * s * u / temp))).sum(axis=1)


def tv_distance(counts: np.ndarray, p: np.ndarray) -> float:
    return float(0.5 * np.abs(counts / counts.sum() - p).sum())


def chi2_statistic(counts: np.ndarray, p: np.ndarray):
    """Pearson X² of ``counts`` against the law ``p``, with the bins of
    fewer than 5 expected counts pooled into one. Returns (X², df)."""
    m = counts.sum()
    expected = p * m
    big = expected >= 5.0
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), len(obs) - 1


def chi2_critical(df: int, alpha: float = 1e-4) -> float:
    """Upper-tail χ² critical value."""
    from scipy.stats import chi2

    return float(chi2.ppf(1.0 - alpha, df))


def boltzmann_gates(counts: np.ndarray, problem, temp: float,
                    weights: Optional[np.ndarray] = None) -> dict:
    """The statistical tier's numbers for state ``counts`` at ``temp``:
    ``x2``, ``df`` and ``crit`` (χ², skipped when ``weights`` reweights the
    counts), ``tv`` and ``tv_wrong`` at 2T and T/2. The gates: x2 < 2·crit,
    tv < 0.05, every tv_wrong > 3·tv."""
    if weights is not None:
        counts = counts * weights
    p = boltzmann(problem, temp)
    out = {"tv": tv_distance(counts, p),
           "tv_wrong": [tv_distance(counts, boltzmann(problem, t))
                        for t in (2.0 * temp, 0.5 * temp)]}
    if weights is None:
        out["x2"], out["df"] = chi2_statistic(counts, p)
        out["crit"] = chi2_critical(out["df"])
    return out


def gates_pass(g: dict) -> bool:
    ok = g["tv"] < 0.05 and all(w > 3.0 * g["tv"] for w in g["tv_wrong"])
    return ok and ("x2" not in g or g["x2"] < 2.0 * g["crit"])


def equal_mass_bins(p: np.ndarray, bins: int) -> np.ndarray:
    """(N,) bin of each site: consecutive sites, cut where the cumulative
    mass crosses k/bins."""
    cum = np.cumsum(p) / p.sum()
    return np.minimum((cum * bins - 1e-12).astype(np.int64), bins - 1)


def pick_law_chi2(p: np.ndarray, picks: np.ndarray, bins: int):
    """(X², df, critical value at α=1e-4) of the roulette's picked sites
    against the law p_i/W, the sites in ``bins`` bins of equal mass."""
    which = equal_mass_bins(p, bins)
    mass = np.bincount(which, weights=p, minlength=bins) / p.sum()
    counts = np.bincount(which[picks], minlength=bins).astype(np.float64)
    x2, df = chi2_statistic(counts, mass)
    return x2, df, chi2_critical(df)


def sweep_chain(problem, temp: float, *, mode: str,
                uniformized: bool = False, r: int = 64, chunk: int = 48,
                chunks: int = 130, burn: int = 10, seed: int = 3):
    """A fixed-T chain through the solve's own keyed sweep chunk
    (``ops.keyed_sweep_chunk``, its ``Salt.SWEEP`` streams) on the
    problem's device: kernel A on the card, its plain version on the CPU.
    Returns ``(energies (chunks, R), state indices pooled over the chunk
    boundaries after ``burn``, final state)``, the first two numpy."""
    base = rng.fold_in(rng.key(0), seed)
    words = rng.words(base)
    state = ops.fused_init_state(problem, base, r)
    temps = torch.full((chunk, r), temp, device=problem.device)
    energies, samples = [], []
    for c in range(chunks):
        state = ops.keyed_sweep_chunk(
            problem.couplings, state, words, c, temps, mode=mode,
            uniformized=uniformized, pwl_table=None, block_r=8)
        energies.append(state[2])
        if c >= burn:
            samples.append(state_index(state[1]))
    return (torch.stack(energies).cpu().numpy(), _pooled(samples), state)


def colored_chain(plan, temp: float, *, r: int = 64, chunk: int = 48,
                  chunks: int = 130, burn: int = 10, seed: int = 3):
    """The colored counterpart of :func:`sweep_chain` on a ``ColoredPlan``
    (kernel D on the card): the class schedule of absolute steps, samples
    in the plan's color-sorted order."""
    base = rng.fold_in(rng.key(0), seed)
    words = rng.words(base)
    state = ops.fused_init_state(plan.problem, base, r,
                                 planes=plan.store.planes)
    temps = torch.full((chunk, r), temp, device=plan.problem.device)
    energies, samples = [], []
    for c in range(chunks):
        steps = torch.arange(chunk, device=plan.wstarts.device) + c * chunk
        sched = ops.colored_class_schedule(plan.wstarts, plan.offsets,
                                           plan.sizes, steps)
        state = ops.colored_sweep_chunk(
            plan.store.kernel_operand, state, words, c, temps, sched,
            window=plan.window, coupling=plan.store.fmt, block_r=8)
        energies.append(state[2])
        if c >= burn:
            samples.append(state_index(state[1]))
    return (torch.stack(energies).cpu().numpy(), _pooled(samples), state)


def _pooled(samples) -> np.ndarray:
    if not samples:
        return np.zeros((0,), np.int64)
    return torch.cat(samples).cpu().numpy()


def roulette_picks(store, fields: torch.Tensor, spins: torch.Tensor,
                   energy: torch.Tensor, temp: float, pwl_table, *,
                   keys: int, seed: int = 5):
    """From one state copied to R replicas (``fields``, ``spins`` (R, N),
    ``energy`` (R,)), one RWA step of the keyed sweep on the store's tier
    per chunk key 0..keys-1. Returns ``(picks, p)``: the flipped site of
    every (key, replica), (keys·R,) int64, and the (N,) float64 flip
    probabilities of the state, the law being p/W."""
    r = fields.shape[0]
    base = rng.fold_in(rng.key(0), seed)
    words = rng.words(base)
    temps = torch.full((1, r), temp, device=fields.device)
    state = (fields, spins, energy, energy.clone(), spins.clone(),
             torch.zeros(r, dtype=torch.int32, device=fields.device))
    picks, single = [], []
    for c in range(keys):
        out = ops.keyed_sweep_chunk(store.kernel_operand, state, words, c,
                                    temps, mode="rwa", pwl_table=pwl_table,
                                    coupling=store.fmt)
        changed = out[1] != spins
        single.append(changed.sum(dim=1) == 1)
        picks.append(changed.to(torch.int8).argmax(dim=1))
    if not bool(torch.cat(single).all()):
        raise AssertionError("a plain RWA step must flip exactly one spin "
                             "a replica")
    p = flip_probability(2.0 * spins[0] * fields[0], temp, pwl_table)
    return torch.cat(picks).cpu().numpy(), p.double().cpu().numpy()
