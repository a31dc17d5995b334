"""Dual-mode MCMC spin selection with asynchronous single-spin updates (paper
Alg. 1): the reference engine. Port of ``repro.core.mcmc``.

Mode I — **RSA** (random-scan): select a site uniformly (Eq. 22), accept the
flip with the Glauber probability (Eq. 2/26).

Mode II — **RWA** (roulette-wheel): evaluate all N flip probabilities, select
one index with probability ``p_i / Σ_j p_j`` (Eq. 10/29) and flip it
deterministically. The *uniformized* variant makes a null transition with
probability ``1 − W/N``. A degenerate total weight W (≤ 0 or not finite)
falls back to one random-scan update (Alg. 1 lines 10–14); uniformized, it
is a null transition.

Plain PyTorch on tensors, with no kernel: this engine is the oracle the
sweeps are held against. Where the JAX engine vmaps one chain, every tensor
of a :class:`ChainState` here carries the replicas as explicit leading axes
(one chain: none), and so do the keys. A step's random numbers are a pure
function of its key, so :func:`step_draws` can draw them for a whole chunk
of steps at once; :func:`rsa_step` and :func:`rwa_step` draw their own and
run the same step bodies.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import ising, rng
from .pwl import FlipProbFn, exact_flip_probability


class ChainState(NamedTuple):
    """State of a batch of Markov chains (leading axes B, N spins)."""

    spins: torch.Tensor        # (B..., N) int8 ±1
    fields: torch.Tensor       # (B..., N) f32, u_i = u_i^(J) + h_i
    energy: torch.Tensor       # (B...,) f32, H(s), tracked incrementally
    best_energy: torch.Tensor  # (B...,) f32
    best_spins: torch.Tensor   # (B..., N) int8
    num_flips: torch.Tensor    # (B...,) int32, accepted flips


class StepInfo(NamedTuple):
    site: torch.Tensor         # (B...,) int64, the selected spin
    accepted: torch.Tensor     # (B...,) bool
    temperature: torch.Tensor  # () f32


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """Static configuration of the dual-mode engine."""

    mode: str = "rwa"              # "rsa" | "rwa"
    uniformized: bool = False      # RWA only: the uniformized variant
    flip_prob: FlipProbFn = exact_flip_probability  # exact or PWL

    def __post_init__(self):
        if self.mode not in ("rsa", "rwa"):
            raise ValueError(f"mode must be 'rsa' or 'rwa', got {self.mode!r}")


class Draws(NamedTuple):
    """The random numbers of one step per chain (None where the step's mode
    reads none): the ``Salt.SITE`` index and the ``ACCEPT``, ``ROULETTE``
    and ``UNIFORMIZE`` uniforms of the step key."""

    site: Optional[torch.Tensor]
    accept: Optional[torch.Tensor]
    roulette: Optional[torch.Tensor]
    uniformize: Optional[torch.Tensor]

    def map(self, fn) -> "Draws":
        return Draws(*(None if x is None else fn(x) for x in self))


def step_draws(key: torch.Tensor, n: int, config: MCMCConfig) -> Draws:
    """The draws a step of ``config``'s mode reads from ``key`` (any leading
    axes): RSA a site and an accept uniform; RWA a roulette uniform and
    either the fallback's site and accept uniform or, uniformized, the
    null-transition coin."""
    rsa = config.mode == "rsa"
    random_scan = rsa or not config.uniformized

    def uniform(salt):
        return rng.uniform01(rng.stream(key, salt))

    return Draws(
        site=(rng.uniform_index(rng.stream(key, rng.Salt.SITE), n)
              if random_scan else None),
        accept=uniform(rng.Salt.ACCEPT) if random_scan else None,
        roulette=None if rsa else uniform(rng.Salt.ROULETTE),
        uniformize=(uniform(rng.Salt.UNIFORMIZE)
                    if not random_scan else None))


def _take(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[..., j]`` per chain."""
    return x.gather(-1, j[..., None]).squeeze(-1)


def init_chain(problem: ising.IsingProblem,
               spins: torch.Tensor) -> ChainState:
    """Local-field initialization from scratch (Alg. 1 lines 2–3)."""
    u = ising.local_fields(problem, spins)
    e = ising.energy(problem, spins).to(torch.float32)
    spins = spins.to(ising.SPIN_DTYPE)
    return ChainState(
        spins=spins, fields=u.to(torch.float32), energy=e,
        best_energy=e.clone(), best_spins=spins.clone(),
        num_flips=torch.zeros(e.shape, dtype=torch.int32, device=e.device))


def _apply_flip(problem: ising.IsingProblem, state: ChainState,
                j: torch.Tensor, accept: torch.Tensor,
                delta_e: torch.Tensor) -> ChainState:
    """Asynchronous single-spin update + incremental field maintenance."""
    s_old_j = _take(state.spins, j)   # the pre-flip spin (Alg. 1 line 15/22)
    acc_f = accept.to(torch.float32)
    flipped = torch.where(accept, -s_old_j, s_old_j).to(state.spins.dtype)
    new_spins = state.spins.scatter(-1, j[..., None], flipped[..., None])
    row = problem.couplings[j]        # == column j (J symmetric)
    scale = 2.0 * acc_f * s_old_j.to(torch.float32)
    new_fields = state.fields - scale[..., None] * row
    new_energy = state.energy + acc_f * delta_e
    better = new_energy < state.best_energy
    return ChainState(
        spins=new_spins, fields=new_fields, energy=new_energy,
        best_energy=torch.where(better, new_energy, state.best_energy),
        best_spins=torch.where(better[..., None], new_spins,
                               state.best_spins),
        num_flips=state.num_flips + accept.to(torch.int32))


def _rsa(problem, state: ChainState, draws: Draws, temperature,
         config: MCMCConfig):
    j = draws.site
    u_j = _take(state.fields, j)
    s_j = _take(state.spins, j).to(torch.float32)
    delta_e = 2.0 * s_j * u_j                        # Eq. 24
    p = config.flip_prob(delta_e, temperature)       # Eq. 25
    accept = draws.accept < p                        # Eq. 26
    return _apply_flip(problem, state, j, accept, delta_e), j, accept


def _rwa(problem, state: ChainState, draws: Draws, temperature,
         config: MCMCConfig):
    n = problem.num_spins
    delta_e_all = 2.0 * state.spins.to(torch.float32) * state.fields
    p_all = config.flip_prob(delta_e_all, temperature)
    total = p_all.sum(dim=-1)                        # W, Eq. 28
    degenerate = (total <= 0) | ~torch.isfinite(total)
    # The wheel: r ∈ [0, W); the first j with cumsum(p)[j] > r.
    wheel = torch.cumsum(p_all, dim=-1)
    radius = draws.roulette * torch.where(degenerate, 1.0, total)
    j_rw = torch.searchsorted(wheel, radius[..., None].contiguous(),
                              right=True)[..., 0]
    j_rw = torch.clamp(j_rw, 0, n - 1)
    if config.uniformized:
        # A null transition with probability 1 − W/N; W = 0 is always one.
        accept = ~degenerate & (draws.uniformize * float(n) < total)
        j = j_rw
    else:
        accept_fb = draws.accept < _take(p_all, draws.site)
        j = torch.where(degenerate, draws.site, j_rw)
        accept = torch.where(degenerate, accept_fb, True)
    delta_e = _take(delta_e_all, j)
    return _apply_flip(problem, state, j, accept, delta_e), j, accept


def step_drawn(problem: ising.IsingProblem, state: ChainState, draws: Draws,
               temperature, config: MCMCConfig):
    """One dual-mode step on the draws of :func:`step_draws` (a ``()`` f32
    ``temperature`` on the state's device)."""
    body = _rsa if config.mode == "rsa" else _rwa
    state, j, accept = body(problem, state, draws, temperature, config)
    t = torch.as_tensor(temperature, dtype=torch.float32)
    return state, StepInfo(site=j, accepted=accept, temperature=t)


def _keyed_step(problem, state: ChainState, key: torch.Tensor, temperature,
                config: MCMCConfig):
    draws = step_draws(key, problem.num_spins, config)
    return step_drawn(problem, state,
                      draws.map(lambda x: x.to(state.spins.device)),
                      temperature, config)


def rsa_step(problem: ising.IsingProblem, state: ChainState,
             key: torch.Tensor, temperature,
             config: MCMCConfig) -> tuple[ChainState, StepInfo]:
    """Mode I: random-scan selection + stochastic Glauber accept."""
    return _keyed_step(problem, state, key, temperature,
                       dataclasses.replace(config, mode="rsa"))


def rwa_step(problem: ising.IsingProblem, state: ChainState,
             key: torch.Tensor, temperature,
             config: MCMCConfig) -> tuple[ChainState, StepInfo]:
    """Mode II: roulette-wheel selection + deterministic flip."""
    return _keyed_step(problem, state, key, temperature,
                       dataclasses.replace(config, mode="rwa"))


def step(problem: ising.IsingProblem, state: ChainState, key: torch.Tensor,
         temperature, config: MCMCConfig) -> tuple[ChainState, StepInfo]:
    """One dual-mode Monte Carlo step (the mode is static)."""
    return _keyed_step(problem, state, key, temperature, config)
