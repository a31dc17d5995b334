"""Annealed replica-ensemble solver (paper Alg. 1 + §V). Port of
``repro.core.solver``.

``solve(problem, seed, config, backend=...)`` dispatches through the
backend registry (:mod:`repro_torch.core.backend`): "fused" runs the fused
sweep kernel (:func:`repro_torch.kernels.ops.fused_anneal`), "colored" a
``flip_mode="colored"`` config through the graph-colored sweep
(:func:`repro_torch.kernels.ops.colored_anneal`), "reference" the reference
engine of :mod:`repro_torch.core.mcmc` (plain PyTorch, no kernel: the
oracle), and "auto" resolves one from the config. The port's default is
"fused", the production path; the JAX package's is "reference".

The reference engine is the loop of this module: R chains of
``mcmc.step``, every step keyed by its absolute index (``stream(replica
key, t)``) at the schedule's temperature of that step, so any chunking of
the loop gives the same values (:func:`run_reference_chunk`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import ising, mcmc, rng
from ..device import resolve_device
from .pwl import make_flip_probability, make_pwl_sigmoid
from .schedules import Schedule

#: Untraced chunk length of the monolithic reference loop: bounds the
#: draws made at once; the values do not depend on it.
REFERENCE_CHUNK_STEPS = 256


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver configuration; the same fields and defaults as the JAX one."""

    num_steps: int
    schedule: Schedule
    mode: str = "rwa"               # "rsa" | "rwa"
    uniformized: bool = False
    use_pwl: bool = True            # PWL LUT logistic; False = exact sigmoid
    pwl_segments: int = 64
    pwl_zmax: float = 8.0
    num_replicas: int = 8
    trace_every: int = 0            # 0 disables the energy trace
    coupling_format: str = "auto"
    flip_mode: str = "single"       # "single" | "colored"


class SolveResult(NamedTuple):
    best_energy: torch.Tensor     # (R,) incl. problem offset
    best_spins: torch.Tensor      # (R, N) int8
    final_energy: torch.Tensor    # (R,) incl. problem offset
    num_flips: torch.Tensor       # (R,) int32
    trace_energy: torch.Tensor    # (num_chunks, R) best-so-far, or (0, R)
    rows_fetched: Optional[torch.Tensor] = None  # (R,) int32


def anneal_chunk_plan(config: SolverConfig, chunk_steps: int):
    """(chunk_len, num_chunks, rem_steps): with tracing on, chunks are
    exactly ``trace_every`` steps; otherwise ``chunk_steps`` with a remainder
    chunk, so the total is ``num_steps``."""
    if config.trace_every:
        chunk_len = config.trace_every
        num_chunks = max(config.num_steps // chunk_len, 1)
        rem_steps = 0
    else:
        chunk_len = max(min(chunk_steps, config.num_steps), 1)
        num_chunks = config.num_steps // chunk_len
        rem_steps = config.num_steps - num_chunks * chunk_len
    return chunk_len, num_chunks, rem_steps


def chunk_list(config: SolverConfig, chunk_steps: int):
    """``(chunk_len, [(c, clen), ...])``: the chunks of
    :func:`anneal_chunk_plan`, the remainder chunk last."""
    chunk_len, num_chunks, rem_steps = anneal_chunk_plan(config, chunk_steps)
    chunks = [(c, chunk_len) for c in range(num_chunks)]
    if rem_steps:
        chunks.append((num_chunks, rem_steps))
    return chunk_len, chunks


def _mcmc_config(config: SolverConfig) -> mcmc.MCMCConfig:
    if config.use_pwl:
        fp = make_flip_probability(make_pwl_sigmoid(config.pwl_segments,
                                                    config.pwl_zmax))
    else:
        fp = make_flip_probability(None)
    return mcmc.MCMCConfig(mode=config.mode, uniformized=config.uniformized,
                           flip_prob=fp)


def step_temperatures(schedule: Schedule, count: int) -> torch.Tensor:
    """(count,) f32 temperatures of steps [0, count), on the CPU, each the
    schedule at its own scalar step, as the JAX engine evaluates it inside
    its loop. A linear or constant schedule is IEEE arithmetic, the same in
    a vector call; a geometric or cosine one goes through ``torch.pow`` or
    ``torch.cos``, whose vector call takes some elements down another path
    than a scalar call, so those are evaluated one step at a time and no
    step's value depends on the chunking."""
    steps = torch.arange(count, dtype=torch.int32)
    if schedule.kind in ("linear", "constant"):
        return schedule(steps).to(torch.float32)
    return torch.stack([schedule(t) for t in steps]).to(torch.float32)


def reference_keys(seed, r: int) -> torch.Tensor:
    """The (R, 2) replica keys ``stream(fold_in(key(0), seed), REPLICA, i)``
    of the reference engine, on the CPU (their threefry is hundreds of
    small elementwise ops)."""
    base = rng.fold_in(rng.key(0), int(seed))
    return rng.stream(base, rng.Salt.REPLICA, torch.arange(r))


def reference_init_state(problem: ising.IsingProblem, seed,
                         config: SolverConfig):
    """Replica init of the reference engine: ``(states, replica_keys)`` with
    the ``Salt.REPLICA`` → ``Salt.INIT`` derivation of the JAX ``_run``;
    the states live on the problem's device."""
    replica_keys = reference_keys(seed, config.num_replicas)
    spins = ising.random_spins(rng.stream(replica_keys, rng.Salt.INIT),
                               (problem.num_spins,))
    states = mcmc.init_chain(problem, spins.to(problem.device))
    return states, replica_keys


def run_reference_chunk(problem: ising.IsingProblem,
                        states: mcmc.ChainState,
                        replica_keys: torch.Tensor, c: int, *, clen: int,
                        chunk_len: int, mc: mcmc.MCMCConfig,
                        temps: torch.Tensor) -> mcmc.ChainState:
    """``clen`` sequential reference steps from global step ``c·chunk_len``
    at the (clen,) temperatures ``temps`` (on the states' device). Each
    step is keyed by its absolute index t, ``stream(replica_key, t)``, and
    the chunk's draws are made in one batch from those keys: a pure
    function of (seed, t), so chunked composition equals one long loop."""
    t0 = c * chunk_len
    steps = torch.arange(t0, t0 + clen, dtype=torch.int64)
    keys = rng.stream(replica_keys[None], steps[:, None])   # (clen, R, 2)
    draws = mcmc.step_draws(keys, problem.num_spins, mc).map(
        lambda x: x.to(states.spins.device))
    for i in range(clen):
        states, _ = mcmc.step_drawn(problem, states,
                                    draws.map(lambda x: x[i]), temps[i], mc)
    return states


def reference_result(states: mcmc.ChainState, trace: list, offset: float,
                     config: SolverConfig) -> SolveResult:
    """The ``SolveResult`` of the reference engine's final states and its
    per-chunk best energies (when tracing; a run stopped before its first
    chunk has a (0, R) trace)."""
    if config.trace_every and trace:
        trace_energy = torch.stack([torch.as_tensor(
            row, device=states.energy.device) for row in trace]) + offset
    else:
        trace_energy = torch.zeros((0, config.num_replicas),
                                   dtype=torch.float32,
                                   device=states.energy.device)
    return SolveResult(best_energy=states.best_energy + offset,
                       best_spins=states.best_spins,
                       final_energy=states.energy + offset,
                       num_flips=states.num_flips,
                       trace_energy=trace_energy)


class ChunkRunner:
    """A solve as a chunk plan: ``init() -> state``, ``run_chunk(state, k)
    -> state``, ``trace_row(state)``, ``finalize(state, rows) -> result``.
    :meth:`drive` runs every chunk in order and is the monolithic solve;
    the resilient supervisor runs the same chunks with snapshots between
    them, so the two are one loop and agree bitwise under any chunking."""

    def _plan(self, config: SolverConfig, chunk_steps: int) -> None:
        self.config = config
        self.chunk_len, self.chunks = chunk_list(config, chunk_steps)
        self.total_units = len(self.chunks)
        self.collect_trace = bool(config.trace_every)
        self.num_replicas = config.num_replicas

    def unit_len(self, k: int) -> int:
        return self.chunks[k][1]

    def _rows(self, k: int) -> slice:
        """Chunk k's rows of the per-step tables."""
        at = k * self.chunk_len
        return slice(at, at + self.chunks[k][1])

    def _trace(self, rows: list) -> list:
        """The collected trace rows (host arrays or tensors) as tensors on
        the runner's device."""
        return [torch.as_tensor(row, device=self.device) for row in rows]

    def drive(self) -> SolveResult:
        """Every chunk from the start, without snapshots."""
        state = self.init()
        rows = []
        for k in range(self.total_units):
            state = self.run_chunk(state, k)
            if self.collect_trace:  # traced plans have no remainder chunk
                rows.append(self.trace_row(state))
        return self.finalize(state, rows)


def require_dense(problem: ising.IsingProblem) -> None:
    if problem.couplings is None:
        raise ValueError(
            "backend='reference' needs the dense J; edge-list "
            "(dense-J-free) problems are served by backend='fused'")


class ReferenceRunner(ChunkRunner):
    """The reference engine, chunk at a time. Every step is keyed by its
    absolute index and takes its temperature from one per-step table, so
    any chunking composes to the same values; traced runs use the trace
    cadence, untraced ones ``chunk_steps``."""

    backend = "reference"
    fmt = "dense"

    def __init__(self, problem, seed, config: SolverConfig,
                 chunk_steps: int = REFERENCE_CHUNK_STEPS, device=None):
        require_dense(problem)
        self.device = resolve_device(device)
        self.problem = problem.to(self.device)
        self.seed = int(seed)
        self._plan(config, chunk_steps)
        self.mc = _mcmc_config(config)
        self.temps = step_temperatures(
            config.schedule, sum(n for _, n in self.chunks)).to(self.device)
        # The replica keys are a pure function of the seed: the snapshot
        # carries chain state only, never RNG state.
        self.keys = reference_keys(self.seed, config.num_replicas)

    def init(self):
        return reference_init_state(self.problem, self.seed, self.config)[0]

    def run_chunk(self, states, k: int):
        return run_reference_chunk(
            self.problem, states, self.keys, k, clen=self.unit_len(k),
            chunk_len=self.chunk_len, mc=self.mc, temps=self.temps[
                self._rows(k)])

    def best_energy(self, states) -> float:
        return float(states.best_energy.min()) + float(self.problem.offset)

    def trace_row(self, states):
        return states.best_energy

    def finalize(self, states, rows) -> SolveResult:
        return reference_result(states, self._trace(rows),
                                self.problem.offset, self.config)


def _run(problem: ising.IsingProblem, seed, config: SolverConfig,
         device=None) -> SolveResult:
    """The reference engine's monolithic solve (``backend="reference"``)."""
    return ReferenceRunner(problem, seed, config, device=device).drive()


def solve(problem: ising.IsingProblem, seed, config: SolverConfig,
          backend: str = "fused", *, store=None, device=None) -> SolveResult:
    """Anneal ``problem`` from ``seed`` on a registered ``backend``
    (:func:`repro_torch.core.backend.backend_names`), or "auto" to resolve
    one from the config ("fused" for single-flip configs, "colored" for
    ``flip_mode="colored"``). The default is "fused" (the JAX package's is
    "reference"). ``store`` takes a prebuilt ``core.coupling.CouplingStore``
    so repeated fused solves of one instance skip the resolve → encode (the
    colored backend builds its own, in color-sorted order, and refuses one;
    the reference engine always reads the dense J); ``device`` as in
    :func:`repro_torch.device.resolve_device`."""
    from .backend import get_backend, resolve_backend

    backend = resolve_backend(config, backend)
    return get_backend(backend).run(problem, seed, config, store=store,
                                    device=device)


def solve_many(problem: ising.IsingProblem, seeds, config: SolverConfig,
               backend: str = "fused", *, store=None,
               device=None) -> SolveResult:
    """Independent runs, one per seed, stacked on a new leading axis; a
    prebuilt ``store`` is encoded once and reused by every run."""
    runs = [solve(problem, int(s), config, backend, store=store,
                  device=device) for s in seeds]
    return SolveResult(*(None if field[0] is None else torch.stack(field)
                         for field in zip(*runs)))
