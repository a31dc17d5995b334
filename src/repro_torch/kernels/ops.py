"""Fused annealing driver on the CUDA kernels (port of ``repro.kernels.ops``).

``fused_anneal`` is the production solve: replica init (threefry-exact spins,
u₀ from the local-field kernel, e₀ from ``ising.energy``), then a Python loop
over chunks — the JAX ``scan`` — with one sweep launch per chunk, uniforms
from the chunk's ``Salt.SWEEP`` stream and temperatures from the schedule.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import coupling, ising, rng
from ..core.pwl import pwl_table as _pwl_table
from ..core.solver import SolverConfig, SolveResult
from ..device import resolve_device
from . import local_field as _local_field
from . import sweep as _sweep

#: N at or below which the JAX package's ``gather="auto"`` picks its one-hot
#: MXU gather. On the dense tier every value gives identical results and the
#: port runs the same row-fetch kernel for all of them.
ONEHOT_GATHER_MAX_N = 128


def init_fields(problem: ising.IsingProblem,
                spins0: torch.Tensor) -> torch.Tensor:
    """One-time u₀ = J s + h (the local-field kernel on the card)."""
    return _local_field.local_field_init(spins0, problem.couplings,
                                         problem.fields)


def fused_init_state(problem: ising.IsingProblem, base: torch.Tensor, r: int):
    """Replica init: the ``(u, s, e, best_e, best_s, num_flips)`` state with
    the JAX package's ``Salt.REPLICA`` → ``Salt.INIT`` key derivation."""
    n = problem.num_spins
    keys = rng.stream(rng.stream(base, rng.Salt.REPLICA,
                                 torch.arange(r, device=base.device)),
                      rng.Salt.INIT)
    spins0 = ising.random_spins(keys, (n,)).to(torch.float32)
    u0 = init_fields(problem, spins0)
    e0 = ising.energy(problem, spins0)
    return (u0, spins0, e0, e0.clone(), spins0.clone(),
            torch.zeros(r, dtype=torch.int32, device=spins0.device))


def solver_pwl_table(config: SolverConfig,
                     device=None) -> Optional[torch.Tensor]:
    """The (S+1, 3) LUT for ``config``, or None for the exact sigmoid."""
    if not config.use_pwl:
        return None
    return _pwl_table(config.pwl_segments, config.pwl_zmax, device=device)


def fused_sweep_chunk(couplings: torch.Tensor, state, chunk_key: torch.Tensor,
                      num_steps: int, temps: torch.Tensor, *, mode: str,
                      uniformized: bool = False,
                      pwl_table: Optional[torch.Tensor] = None,
                      gather: str = "dynamic",
                      with_rows_fetched: bool = False):
    """One sweep chunk plus the best-so-far merge. ``state`` is the 6-tuple
    ``(u, s, e, best_e, best_s, num_flips)``; returns it updated, and the
    chunk's rows-fetched count as a second element when asked."""
    u, s, e, be, bs, nf = state
    r = e.shape[0]
    uniforms = rng.uniform01(chunk_key, (num_steps, r, 4))
    u, s, e, ce, cs, cf, rf = _sweep.mcmc_sweep(
        couplings, u, s, e, uniforms, temps, pwl_table, mode=mode,
        uniformized=uniformized, gather=gather)
    better = ce < be
    state = (u, s, e, torch.where(better, ce, be),
             torch.where(better[:, None], cs, bs), nf + cf)
    return (state, rf) if with_rows_fetched else state


def anneal_chunk_plan(config: SolverConfig, chunk_steps: int):
    """(chunk_len, num_chunks, rem_steps): with tracing on, chunks are
    exactly ``trace_every`` steps; otherwise ``chunk_steps`` with a remainder
    sweep, so the total is ``num_steps``."""
    if config.trace_every:
        chunk_len = config.trace_every
        num_chunks = max(config.num_steps // chunk_len, 1)
        rem_steps = 0
    else:
        chunk_len = max(min(chunk_steps, config.num_steps), 1)
        num_chunks = config.num_steps // chunk_len
        rem_steps = config.num_steps - num_chunks * chunk_len
    return chunk_len, num_chunks, rem_steps


def anneal_gather(gather: str, n: int) -> str:
    """Resolve ``gather`` as the JAX package does on the dense tier
    ("auto" → "onehot" for N ≤ 128). All values run the same kernel."""
    if gather not in _sweep.GATHERS:
        raise ValueError(f"gather must be one of {_sweep.GATHERS}, got "
                         f"{gather!r}")
    if gather == "auto":
        return "onehot" if n <= ONEHOT_GATHER_MAX_N else "dynamic"
    return gather


def chunk_temps(config: SolverConfig, c: int, clen: int, chunk_len: int,
                device) -> torch.Tensor:
    """(clen, R) temperatures of global steps [c·chunk_len, +clen). Computed
    on the CPU and copied, so every device anneals on identical values."""
    steps = c * chunk_len + torch.arange(clen, dtype=torch.int32)
    temps = config.schedule(steps).to(torch.float32)
    temps = temps[:, None].expand(clen, config.num_replicas).contiguous()
    return temps.to(device)


def anneal_chunk_step(problem: ising.IsingProblem, state, base: torch.Tensor,
                      c: int, *, clen: int, chunk_len: int,
                      config: SolverConfig, gather: str,
                      pwl_table: Optional[torch.Tensor] = None,
                      with_rows_fetched: bool = False):
    """One annealing chunk: the temps of its steps, its ``Salt.SWEEP``
    stream, and the sweep and merge of :func:`fused_sweep_chunk`."""
    temps = chunk_temps(config, c, clen, chunk_len, problem.device)
    return fused_sweep_chunk(
        problem.couplings, state, rng.stream(base, rng.Salt.SWEEP, c), clen,
        temps, mode=config.mode, uniformized=config.uniformized,
        pwl_table=pwl_table, gather=gather,
        with_rows_fetched=with_rows_fetched)


def fused_anneal(problem: ising.IsingProblem, seed, config: SolverConfig, *,
                 chunk_steps: int = 256, gather: str = "dynamic",
                 device=None) -> SolveResult:
    """Production annealing driver on the fused sweep kernel.

    The same modes, PWL or exact flip probability, uniformized RWA,
    ``num_flips``, ``rows_fetched`` and trace cadence as the JAX
    ``fused_anneal``, seed for seed. ``device`` as in
    :func:`repro_torch.device.resolve_device`; the problem is moved there.
    """
    if config.flip_mode != "single":
        raise NotImplementedError(
            f"flip_mode={config.flip_mode!r} is not ported yet (ROADMAP "
            "queue 1 item 8: colored flips)")
    coupling.resolve_format(config.coupling_format)
    dev = resolve_device(device)
    problem = problem.to(dev)
    n = problem.num_spins
    r = config.num_replicas
    gather = anneal_gather(gather, n)
    base = rng.fold_in(rng.key(0, device=dev), int(seed))
    state = fused_init_state(problem, base, r)
    pwl = solver_pwl_table(config, device=dev)
    chunk_len, num_chunks, rem_steps = anneal_chunk_plan(config, chunk_steps)
    rows = torch.zeros(r, dtype=torch.int32, device=dev)
    trace = []
    plan = [(c, chunk_len) for c in range(num_chunks)]
    if rem_steps:
        plan.append((num_chunks, rem_steps))
    for c, clen in plan:
        state, rf = anneal_chunk_step(problem, state, base, c, clen=clen,
                                      chunk_len=chunk_len, config=config,
                                      gather=gather, pwl_table=pwl,
                                      with_rows_fetched=True)
        rows = rows + rf
        if config.trace_every:  # traced plans have no remainder chunk
            trace.append(state[3])
    _, _, e, be, bs, nf = state
    if config.trace_every:
        trace_energy = (torch.stack(trace) + problem.offset).to(torch.float32)
    else:
        trace_energy = torch.zeros((0, r), dtype=torch.float32, device=dev)
    return SolveResult(best_energy=be + problem.offset,
                       best_spins=bs.to(torch.int8),
                       final_energy=e + problem.offset, num_flips=nf,
                       trace_energy=trace_energy, rows_fetched=rows)
