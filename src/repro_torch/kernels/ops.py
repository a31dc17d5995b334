"""Fused annealing driver on the CUDA kernels (port of ``repro.kernels.ops``).

``fused_anneal`` is the production solve: resolve and encode the coupling
store (``core.coupling.CouplingStore``), replica init (threefry-exact
spins; u₀ from the local-field kernel on a dense J, or from the popcount
kernel on the planes with e₀ from ``ising.energy_from_fields``, so no dense
J is needed), then a Python loop over chunks — the JAX ``scan`` — with one
sweep launch per chunk, uniforms from the chunk's ``Salt.SWEEP`` stream and
temperatures from the schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..core import ising, rng
from ..core.bitplane import BitPlanes, pack_spins
from ..core.coupling import (KERNEL_COUPLING_MODES, PLANE_FORMATS,
                             CouplingStore)
from ..core.pwl import pwl_table as _pwl_table
from ..core.solver import SolverConfig, SolveResult
from ..device import resolve_device
from . import bitplane_field as _bitplane_field
from . import local_field as _local_field
from . import sweep as _sweep

#: N at or below which the JAX package's ``gather="auto"`` picks its one-hot
#: MXU gather. On the dense tier every value gives identical results and the
#: port runs the same row-fetch kernel for all of them.
ONEHOT_GATHER_MAX_N = 128


def bitplane_field_init(planes: BitPlanes,
                        spins: torch.Tensor) -> torch.Tensor:
    """Batched u^(J) from packed planes via the popcount kernel; the spin
    words are packed to the planes' (possibly padded) word count."""
    words = pack_spins(spins, planes.num_words)
    return _bitplane_field.bitplane_field_init(planes.pos, planes.neg, words)


def plane_local_fields(planes: BitPlanes,
                       spins0: torch.Tensor) -> torch.Tensor:
    """u^(J) = J s from the planes (Eq. 14-16): the popcount kernel on the
    card, its plain version on the CPU. For integer J it is the exact
    integer, bit-identical to the dense product."""
    return bitplane_field_init(planes, spins0)


def init_fields(problem: ising.IsingProblem, spins0: torch.Tensor, *,
                planes: Optional[BitPlanes] = None) -> torch.Tensor:
    """One-time u₀ = J s + h: the popcount kernel on ``planes``, else the
    local-field kernel on the dense J."""
    if planes is not None:
        return plane_local_fields(planes, spins0) + problem.fields[None, :]
    return _local_field.local_field_init(spins0, problem.couplings,
                                         problem.fields)


def fused_init_state(problem: ising.IsingProblem, base: torch.Tensor, r: int,
                     *, planes: Optional[BitPlanes] = None):
    """Replica init: the ``(u, s, e, best_e, best_s, num_flips)`` state with
    the JAX package's ``Salt.REPLICA`` → ``Salt.INIT`` key derivation. With
    ``planes`` it is dense-J-free: e₀ comes from ``ising.energy_from_fields``
    on the plane u^(J), the same contractions ``ising.energy`` runs on J s,
    so plane-fed and dense-fed replicas start from bitwise-equal energies."""
    n = problem.num_spins
    keys = rng.stream(rng.stream(base, rng.Salt.REPLICA,
                                 torch.arange(r, device=base.device)),
                      rng.Salt.INIT)
    spins0 = ising.random_spins(keys, (n,)).to(torch.float32)
    if planes is not None:
        u_j = plane_local_fields(planes, spins0)
        u0 = u_j + problem.fields[None, :]
        e0 = ising.energy_from_fields(u_j, spins0, problem.fields)
    else:
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


def fused_sweep_chunk(couplings: Union[torch.Tensor, BitPlanes], state,
                      chunk_key: torch.Tensor, num_steps: int,
                      temps: torch.Tensor, *, mode: str,
                      uniformized: bool = False,
                      pwl_table: Optional[torch.Tensor] = None,
                      gather: str = "dynamic", block_r: int = 8,
                      coupling: Optional[str] = None, coalesce: bool = True,
                      with_rows_fetched: bool = False):
    """One sweep chunk plus the best-so-far merge. ``couplings`` is the dense
    J or a ``BitPlanes``; ``coupling`` names the tier (None: "bitplane" for
    planes, else "dense"). ``state`` is the 6-tuple ``(u, s, e, best_e,
    best_s, num_flips)``; returns it updated, and the chunk's rows-fetched
    count as a second element when asked."""
    u, s, e, be, bs, nf = state
    r = e.shape[0]
    if coupling is None:
        coupling = "bitplane" if isinstance(couplings, BitPlanes) else "dense"
    uniforms = rng.uniform01(chunk_key, (num_steps, r, 4))
    u, s, e, ce, cs, cf, rf = _sweep.mcmc_sweep(
        couplings, u, s, e, uniforms, temps, pwl_table, mode=mode,
        uniformized=uniformized, gather=gather, coupling=coupling,
        block_r=block_r, coalesce=coalesce)
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


def anneal_gather(store: CouplingStore, gather: str, n: int) -> str:
    """Resolve ``gather`` as the JAX package does: plane tiers take the row
    fetch ("onehot" flows through so the sweep raises its dense-only
    error); the dense tier maps "auto" to "onehot" for N ≤ 128. All dense
    values run the same kernel."""
    if gather not in _sweep.GATHERS:
        raise ValueError(f"gather must be one of {_sweep.GATHERS}, got "
                         f"{gather!r}")
    if store.planes is not None:
        return gather if gather == "onehot" else "dynamic"
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


def anneal_chunk_step(store: CouplingStore, state, base: torch.Tensor,
                      c: int, *, clen: int, chunk_len: int,
                      config: SolverConfig, gather: str, block_r: int = 8,
                      pwl_table: Optional[torch.Tensor] = None,
                      with_rows_fetched: bool = False):
    """One annealing chunk: the temps of its steps, its ``Salt.SWEEP``
    stream, and the sweep and merge of :func:`fused_sweep_chunk` on the
    store's tier."""
    temps = chunk_temps(config, c, clen, chunk_len, state[0].device)
    return fused_sweep_chunk(
        store.kernel_operand, state, rng.stream(base, rng.Salt.SWEEP, c),
        clen, temps, mode=config.mode, uniformized=config.uniformized,
        pwl_table=pwl_table, gather=gather, block_r=block_r,
        coupling=store.fmt, with_rows_fetched=with_rows_fetched)


def _store_for(problem: ising.IsingProblem, config: SolverConfig, coupling,
               num_planes: Optional[int],
               store: Optional[CouplingStore]) -> CouplingStore:
    """The store ``fused_anneal`` runs on, with its contract checks."""
    if store is not None:
        if coupling is not None:
            raise ValueError("pass a prebuilt store= or a coupling= override, "
                             "not both")
        store.require_num_spins(problem.num_spins, "fused_anneal")
        if store.dense is not None and store.dense is not problem.couplings:
            raise ValueError(
                "prebuilt dense CouplingStore does not hold this problem's "
                "couplings tensor — the init would run on one J and the sweep "
                "on another; rebuild the store from problem.couplings")
    elif isinstance(coupling, BitPlanes):
        fmt = (config.coupling_format
               if config.coupling_format in PLANE_FORMATS else "bitplane")
        store = CouplingStore.from_planes(coupling, fmt)
    else:
        store = CouplingStore.build(
            problem.coupling_source,
            coupling if coupling is not None else config.coupling_format,
            num_planes=num_planes)
    return store.require(KERNEL_COUPLING_MODES, "fused_anneal")


def fused_anneal(problem: ising.IsingProblem, seed, config: SolverConfig, *,
                 chunk_steps: int = 256, block_r: int = 8,
                 gather: str = "dynamic",
                 coupling: Union[str, BitPlanes, None] = None,
                 num_planes: Optional[int] = None,
                 store: Optional[CouplingStore] = None,
                 device=None) -> SolveResult:
    """Production annealing driver on the fused sweep kernel.

    The same modes, PWL or exact flip probability, uniformized RWA,
    ``num_flips``, ``rows_fetched`` and trace cadence as the JAX
    ``fused_anneal``, seed for seed. ``coupling`` overrides
    ``config.coupling_format`` (a format name, or prebuilt ``BitPlanes``
    whose tier follows a plane ``config.coupling_format``, else
    "bitplane"); ``num_planes`` forces B. ``store`` takes a prebuilt
    ``CouplingStore`` instead (not with ``coupling``); a dense store must
    hold this problem's couplings tensor itself. An edge-list problem is
    encoded in O(nnz) and no (N, N) array is made. ``block_r`` is the
    replica group of the streamed tier's unique-row count. ``device`` as in
    :func:`repro_torch.device.resolve_device`; the problem and store are
    moved there.
    """
    if config.flip_mode != "single":
        raise NotImplementedError(
            f"flip_mode={config.flip_mode!r} is not ported yet (ROADMAP "
            "queue 1 item 8: colored flips)")
    dev = resolve_device(device)
    store = _store_for(problem, config, coupling, num_planes, store)
    problem = problem.to(dev)
    # A dense store holds the problem's own J: keep one copy on the card.
    store = (dataclasses.replace(store, dense=problem.couplings)
             if store.dense is not None else store.to(dev))
    n = problem.num_spins
    r = config.num_replicas
    gather = anneal_gather(store, gather, n)
    base = rng.fold_in(rng.key(0, device=dev), int(seed))
    state = fused_init_state(problem, base, r, planes=store.planes)
    pwl = solver_pwl_table(config, device=dev)
    chunk_len, num_chunks, rem_steps = anneal_chunk_plan(config, chunk_steps)
    rows = torch.zeros(r, dtype=torch.int32, device=dev)
    trace = []
    plan = [(c, chunk_len) for c in range(num_chunks)]
    if rem_steps:
        plan.append((num_chunks, rem_steps))
    for c, clen in plan:
        state, rf = anneal_chunk_step(store, state, base, c, clen=clen,
                                      chunk_len=chunk_len, config=config,
                                      gather=gather, block_r=block_r,
                                      pwl_table=pwl, with_rows_fetched=True)
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
