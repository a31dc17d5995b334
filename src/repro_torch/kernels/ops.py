"""Fused annealing driver on the CUDA kernels (port of ``repro.kernels.ops``).

``fused_anneal`` is the production solve: resolve and encode the coupling
store (``core.coupling.CouplingStore``), replica init (threefry-exact
spins; u₀ from the local-field kernel on a dense J, or from the popcount
kernel on the planes with e₀ from ``ising.energy_from_fields``, so no dense
J is needed), then a Python loop over chunks — the JAX ``scan`` — with one
sweep launch per chunk: the kernel draws the chunk's ``Salt.SWEEP``
uniforms itself from the base key's two words (computed on the CPU once
per solve), and reads its temperatures as a row slice of the solve's
(num_steps, R) table, computed on the CPU and copied to the card once.
The loop is :class:`FusedRunner`'s: the monolithic solve runs every chunk
of it, the resilient supervisor the same chunks with snapshots between.

``colored_anneal`` is the graph-colored solve (``flip_mode="colored"``):
the same init and chunk loop on the color-sorted problem of a
:class:`ColoredPlan`, one keyed ``colored_sweep`` launch per chunk (the
kernel draws its accept uniforms; the temperatures and the class schedule
are row slices of tables made once per solve), results mapped back to the
original vertex order; its loop is :class:`ColoredRunner`'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core import ising, rng
from ..core.bitplane import BitPlanes, pack_spins
from ..core.coupling import (KERNEL_COUPLING_MODES, PLANE_FORMATS,
                             CouplingStore)
from ..core.pwl import pwl_table as _pwl_table
from ..core.solver import (ChunkRunner, SolverConfig,  # noqa: F401
                           SolveResult, anneal_chunk_plan, chunk_list)
from ..device import resolve_device
from ..graphs.coloring import Coloring, greedy_coloring
from . import bitplane_field as _bitplane_field
from . import local_field as _local_field
from . import sweep as _sweep
from .common import default_lane, fit_block

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
    # The R replica keys on the CPU: each of their threefry's few hundred
    # elementwise ops would be a launch of its own on the card.
    keys = rng.stream(rng.stream(base.cpu(), rng.Salt.REPLICA,
                                 torch.arange(r)), rng.Salt.INIT)
    spins0 = ising.random_spins(keys.to(problem.fields.device),
                                (n,)).to(torch.float32)
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


def _merge(state, out, with_rows_fetched: bool):
    """The best-so-far merge of a chunk's sweep outputs into ``state``."""
    _, _, _, be, bs, nf = state
    u, s, e, ce, cs, cf, rf = out
    better = ce < be
    state = (u, s, e, torch.where(better, ce, be),
             torch.where(better[:, None], cs, bs), nf + cf)
    return (state, rf) if with_rows_fetched else state


def keyed_sweep_chunk(couplings: Union[torch.Tensor, BitPlanes], state,
                      base_words, chunk: int, temps: torch.Tensor, *,
                      mode: str, uniformized: bool = False,
                      pwl_table: Optional[torch.Tensor] = None,
                      gather: str = "dynamic", block_r: int = 8,
                      coupling: Optional[str] = None, coalesce: bool = True,
                      with_rows_fetched: bool = False,
                      fold: Optional[int] = None):
    """One sweep chunk plus the best-so-far merge: the JAX
    ``fused_sweep_chunk`` on the uniforms of ``stream(base, Salt.SWEEP,
    chunk)`` (``stream(base, SWEEP, fold, chunk)`` with a device ``fold``),
    which the card's sweep draws itself from the base key's two words
    (``base_words``, Python ints); T = ``temps.shape[0]``.
    ``couplings`` is the dense J or a ``BitPlanes``; ``coupling`` names the
    tier (None: "bitplane" for planes, else "dense"). ``state`` is the
    6-tuple ``(u, s, e, best_e, best_s, num_flips)``; returns it updated,
    and the chunk's rows-fetched count as a second element when asked."""
    if coupling is None:
        coupling = "bitplane" if isinstance(couplings, BitPlanes) else "dense"
    u, s, e = state[:3]
    out = _sweep.mcmc_sweep_keyed(
        couplings, u, s, e, base_words, chunk, temps, pwl_table, mode=mode,
        uniformized=uniformized, gather=gather, coupling=coupling,
        block_r=block_r, coalesce=coalesce, fold=fold)
    return _merge(state, out, with_rows_fetched)


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


def _chunk_schedule(config: SolverConfig, c: int, clen: int,
                    chunk_len: int) -> torch.Tensor:
    """(clen,) f32 temperatures of global steps [c·chunk_len, +clen), on the
    CPU. One call per chunk: ``torch.pow`` takes a vector's tail through
    the scalar ``pow``, so a geometric temperature depends on where it
    falls in the call, and only the chunk's own call gives its values."""
    steps = c * chunk_len + torch.arange(clen, dtype=torch.int32)
    return config.schedule(steps).to(torch.float32)


def chunk_temps(config: SolverConfig, c: int, clen: int, chunk_len: int,
                device) -> torch.Tensor:
    """(clen, R) temperatures of global steps [c·chunk_len, +clen). Computed
    on the CPU and copied, so every device anneals on identical values."""
    temps = _chunk_schedule(config, c, clen, chunk_len)
    temps = temps[:, None].expand(clen, config.num_replicas).contiguous()
    return temps.to(device)


def anneal_temps(config: SolverConfig, chunk_len: int, chunks,
                 device) -> torch.Tensor:
    """(steps, R) temperatures of every chunk of a solve, made on the CPU
    and copied once; chunk c's rows ``[c·chunk_len, +clen)`` equal
    :func:`chunk_temps` bitwise (the table is built from the same per-chunk
    calls)."""
    temps = torch.cat([_chunk_schedule(config, c, clen, chunk_len)
                       for c, clen in chunks])
    temps = temps[:, None].expand(temps.shape[0], config.num_replicas)
    return temps.contiguous().to(device)


def anneal_chunk_step(store: CouplingStore, state, base_words, c: int,
                      temps: torch.Tensor, *, config: SolverConfig,
                      gather: str, block_r: int = 8,
                      pwl_table: Optional[torch.Tensor] = None,
                      with_rows_fetched: bool = False):
    """One annealing chunk on the store's tier: the sweep of
    :func:`keyed_sweep_chunk` on chunk c's ``Salt.SWEEP`` stream and its
    rows ``temps`` of the solve's table, and the merge."""
    return keyed_sweep_chunk(
        store.kernel_operand, state, base_words, c, temps, mode=config.mode,
        uniformized=config.uniformized, pwl_table=pwl_table, gather=gather,
        block_r=block_r, coupling=store.fmt,
        with_rows_fetched=with_rows_fetched)


def _store_for(problem: ising.IsingProblem, config, coupling,
               num_planes: Optional[int], store: Optional[CouplingStore],
               caller: str) -> CouplingStore:
    """The store ``caller`` runs on, with its contract checks."""
    if store is not None:
        if coupling is not None:
            raise ValueError("pass a prebuilt store= or a coupling= override, "
                             "not both")
        store.require_num_spins(problem.num_spins, caller)
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
    return store.require(KERNEL_COUPLING_MODES, caller)


def fused_operands(problem: ising.IsingProblem, config,
                   device: torch.device, *,
                   coupling: Union[str, BitPlanes, None] = None,
                   num_planes: Optional[int] = None,
                   store: Optional[CouplingStore] = None,
                   caller: str = "fused_anneal"):
    """``(problem, store)`` on ``device``: the store ``caller`` runs on
    (built from ``config.coupling_format``, or a checked prebuilt one) and
    the problem it solves. A dense store holds the problem's own J, so the
    card keeps one copy."""
    store = _store_for(problem, config, coupling, num_planes, store, caller)
    problem = problem.to(device)
    store = (dataclasses.replace(store, dense=problem.couplings)
             if store.dense is not None else store.to(device))
    return problem, store


class FusedRunner(ChunkRunner):
    """The fused solve as a chunk plan (:class:`~repro_torch.core.solver.
    ChunkRunner`): the store, the replica init and the solve's temperature
    table are made once, and chunk k is one :func:`anneal_chunk_step`. The
    state is the sweep's 6-tuple ``(u, s, e, best_e, best_s, num_flips)``
    plus the (R,) rows-fetched count, so a resumed run reports the whole
    run's rows. The arguments are :func:`fused_anneal`'s."""

    backend = "fused"

    def __init__(self, problem: ising.IsingProblem, seed,
                 config: SolverConfig, *, chunk_steps: int = 256,
                 block_r: int = 8, gather: str = "dynamic",
                 coupling: Union[str, BitPlanes, None] = None,
                 num_planes: Optional[int] = None,
                 store: Optional[CouplingStore] = None, device=None):
        if config.flip_mode != "single":
            raise ValueError(
                f"fused_anneal runs single-flip sweeps (flip_mode="
                f"{config.flip_mode!r}); colored block updates are served "
                "by colored_anneal / the 'colored' backend")
        self.device = resolve_device(device)
        self.problem, self.store = fused_operands(
            problem, config, self.device, coupling=coupling,
            num_planes=num_planes, store=store)
        self.fmt = self.store.fmt
        self._plan(config, chunk_steps)
        self.gather = anneal_gather(self.store, gather,
                                    self.problem.num_spins)
        self.block_r = block_r
        self.base = rng.fold_in(rng.key(0), int(seed))  # on the CPU
        self.words = rng.words(self.base)
        self.pwl = solver_pwl_table(config, device=self.device)
        self.temps = anneal_temps(config, self.chunk_len, self.chunks,
                                  self.device)

    def init(self):
        state = fused_init_state(self.problem, self.base, self.num_replicas,
                                 planes=self.store.planes)
        return state + (torch.zeros(self.num_replicas, dtype=torch.int32,
                                    device=self.device),)

    def run_chunk(self, state, k: int):
        out, rf = anneal_chunk_step(
            self.store, state[:6], self.words, k, self.temps[self._rows(k)],
            config=self.config, gather=self.gather, block_r=self.block_r,
            pwl_table=self.pwl, with_rows_fetched=True)
        return out + (state[6] + rf,)

    def best_energy(self, state) -> float:
        return float(state[3].min()) + float(self.problem.offset)

    def trace_row(self, state):
        return state[3]

    def finalize(self, state, rows) -> SolveResult:
        return _result(state[:6], state[6], self._trace(rows),
                       self.problem.offset, self.config)


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
    moved there. Runs every chunk of :class:`FusedRunner`.
    """
    return FusedRunner(problem, seed, config, chunk_steps=chunk_steps,
                       block_r=block_r, gather=gather, coupling=coupling,
                       num_planes=num_planes, store=store,
                       device=device).drive()


def _result(state, rows: torch.Tensor, trace: list, offset: float,
            config: SolverConfig) -> SolveResult:
    """The ``SolveResult`` of a chunk loop's final state and best-energy
    trace (one entry per chunk when tracing; a run stopped before its first
    chunk has a (0, R) trace)."""
    _, _, e, be, bs, nf = state
    if config.trace_every and trace:
        trace_energy = (torch.stack(trace) + offset).to(torch.float32)
    else:
        trace_energy = torch.zeros((0, config.num_replicas),
                                   dtype=torch.float32, device=e.device)
    return SolveResult(best_energy=be + offset, best_spins=bs.to(torch.int8),
                       final_energy=e + offset, num_flips=nf,
                       trace_energy=trace_energy, rows_fetched=rows)


class ColoredPlan:
    """Host-side execution plan for the colored sweep: the coloring, the
    color-permuted problem and its coupling store, and the static window
    math the kernel schedule is built from. Built once per (problem,
    format) by :func:`colored_plan`; the permuted spin order is
    ``coloring.perm`` and results map back through ``coloring.inverse_perm``.

    Window math: with ``lane = common.default_lane(n)`` the static class
    window is ``S = min(n, roundup(max_class_size + lane - 1, lane))`` and
    class c starts its window at ``w_c = min((offsets[c] // lane)·lane,
    n - S)``. Coverage: ``w_c ≤ offsets[c]`` (floor) and ``w_c + S ≥
    offsets[c] - (lane-1) + (size_c + lane - 1) = offsets[c] + size_c``, so
    every class fits its lane-aligned window.

    An edge-list problem is permuted as an edge list (O(nnz), no dense J);
    a dense problem's J is permuted on its device. ``wstarts``, ``offsets``
    and ``sizes`` are (χ,) int32 tensors.
    """

    def __init__(self, coloring: Coloring, problem: ising.IsingProblem,
                 fmt: Optional[str] = "auto",
                 num_planes: Optional[int] = None):
        n = problem.num_spins
        if coloring.num_spins != n:
            raise ValueError(f"coloring is for N={coloring.num_spins}, the "
                             f"problem has N={n}")
        self.coloring = coloring
        perm = coloring.perm
        inv = coloring.inverse_perm
        if problem.edges is not None:
            edges = problem.edges
            pedges = ising.EdgeList.create(inv[edges.rows], inv[edges.cols],
                                           edges.weights, n)
            h = problem.fields.detach().cpu().numpy()[perm]
            self.problem = ising.IsingProblem.create_sparse(
                pedges, h=h, offset=problem.offset, device=problem.device)
        else:
            p = torch.from_numpy(perm.astype(np.int64)).to(problem.device)
            self.problem = ising.IsingProblem(
                problem.couplings[p][:, p], problem.fields[p],
                problem.offset)
        self.store = CouplingStore.build(self.problem.coupling_source, fmt,
                                         num_planes=num_planes)
        self.store.require(KERNEL_COUPLING_MODES, "colored_anneal")
        lane = default_lane(n)
        max_class = coloring.max_class_size
        self.window = min(n, -(-(max_class + lane - 1) // lane) * lane)
        offs = coloring.offsets[:-1]
        w = np.minimum((offs // lane) * lane, n - self.window)
        self.wstarts = torch.from_numpy(w.astype(np.int32))
        self.offsets = torch.from_numpy(offs.astype(np.int32))
        self.sizes = torch.from_numpy(coloring.class_sizes.astype(np.int32))

    def to(self, device) -> "ColoredPlan":
        """The plan with its problem, store and schedule arrays on
        ``device`` (a dense store keeps one J: the problem's)."""
        plan = ColoredPlan.__new__(ColoredPlan)
        plan.coloring = self.coloring
        plan.window = self.window
        plan.problem = self.problem.to(device)
        plan.store = (dataclasses.replace(self.store,
                                          dense=plan.problem.couplings)
                      if self.store.dense is not None
                      else self.store.to(device))
        plan.wstarts = self.wstarts.to(device)
        plan.offsets = self.offsets.to(device)
        plan.sizes = self.sizes.to(device)
        return plan


def colored_plan(problem: ising.IsingProblem, fmt: Optional[str] = "auto",
                 num_planes: Optional[int] = None) -> ColoredPlan:
    """Coloring + permutation + store for a colored solve of ``problem``.

    The greedy coloring runs on the conflict graph of
    ``problem.coupling_source`` (memoized per edge-list digest), the problem
    and its coupling store are rebuilt in color-sorted spin order (classes
    contiguous — the kernel schedules one contiguous window per step), and
    the lane-aligned window schedule is precomputed. Dense-J-free for
    edge-list problems end to end.
    """
    return ColoredPlan(greedy_coloring(problem.coupling_source), problem, fmt,
                       num_planes=num_planes)


def colored_class_schedule(wstarts: torch.Tensor, offsets: torch.Tensor,
                           sizes: torch.Tensor,
                           steps: torch.Tensor) -> torch.Tensor:
    """(T, 3) int32 kernel schedule for absolute step indices ``steps``:
    round-robin over the χ color classes keyed on the *global* step, so a
    chunked trajectory visits the identical class sequence as one
    monolithic run."""
    cls = (steps.to(torch.int64) % wstarts.shape[0]).to(wstarts.device)
    return torch.stack([wstarts[cls], offsets[cls], sizes[cls]],
                       dim=1).to(torch.int32).contiguous()


def colored_tables(plan: ColoredPlan, config: SolverConfig, chunk_len: int,
                   chunks, device):
    """The colored solve's (steps, R) temperatures and (steps, 3) class
    schedule, made once per solve; chunk c takes rows ``[c·chunk_len,
    +clen)`` of both (``plan`` on ``device``)."""
    temps = anneal_temps(config, chunk_len, chunks, device)
    sched = colored_class_schedule(
        plan.wstarts, plan.offsets, plan.sizes,
        torch.arange(temps.shape[0], device=plan.wstarts.device))
    return temps, sched


def colored_sweep_chunk(couplings, state, base_words, chunk: int,
                        temps: torch.Tensor, sched: torch.Tensor, *,
                        window: int, pwl_table: Optional[torch.Tensor] = None,
                        block_r: int = 8, coupling: str = "dense",
                        with_rows_fetched: bool = False):
    """One colored sweep chunk plus the best-so-far merge — the colored
    counterpart of :func:`keyed_sweep_chunk`, with the same 6-tuple state
    and per-chunk ``Salt.SWEEP`` stream: the JAX ``colored_sweep_chunk`` on
    the ``(T, R, window)`` accept uniforms of ``stream(base, Salt.SWEEP,
    chunk)``, which the card's sweep draws itself from the base key's two
    words (``base_words``, Python ints); T = ``temps.shape[0]`` and
    ``sched`` is the (T, 3) class schedule."""
    u, s, e = state[:3]
    out = _sweep.colored_sweep_keyed(
        couplings, u, s, e, base_words, chunk, temps, sched, pwl_table,
        window=window, coupling=coupling, block_r=block_r)
    return _merge(state, out, with_rows_fetched)


def colored_chunk_step(plan: ColoredPlan, state, base_words, c: int,
                       temps: torch.Tensor, sched: torch.Tensor, *,
                       block_r: int = 8,
                       pwl_table: Optional[torch.Tensor] = None,
                       with_rows_fetched: bool = False):
    """One annealing chunk of the colored trajectory on the plan's store
    (on the state's device): the sweep of :func:`colored_sweep_chunk` on
    chunk c's ``Salt.SWEEP`` stream, its rows ``temps`` and ``sched`` of
    the solve's tables, and the merge."""
    return colored_sweep_chunk(
        plan.store.kernel_operand, state, base_words, c, temps, sched,
        window=plan.window, pwl_table=pwl_table, block_r=block_r,
        coupling=plan.store.fmt, with_rows_fetched=with_rows_fetched)


def unpermute_spins(plan: ColoredPlan, spins: torch.Tensor) -> torch.Tensor:
    """Map (..., N) permuted-order spins back to original vertex order
    (``s_orig[..., i] = s_perm[..., inverse_perm[i]]``)."""
    inv = torch.from_numpy(plan.coloring.inverse_perm.astype(np.int64))
    return spins[..., inv.to(spins.device)]


class ColoredRunner(ChunkRunner):
    """The colored solve as a chunk plan: the plan on the device, the
    replica init and the solve's temperature and class-schedule tables are
    made once, and chunk k is one :func:`colored_chunk_step`. The state
    lives in the plan's color-sorted spin order (the permutation is a pure
    function of the problem, so a resumed run rebuilds the same layout),
    with the rows-fetched count as its seventh element; ``finalize`` maps
    the best spins back to vertex order. The arguments are
    :func:`colored_anneal`'s."""

    backend = "colored"

    def __init__(self, problem: ising.IsingProblem, seed,
                 config: SolverConfig, *, chunk_steps: int = 256,
                 block_r: int = 8, coupling: Optional[str] = None,
                 num_planes: Optional[int] = None,
                 plan: Optional[ColoredPlan] = None, device=None):
        if config.flip_mode != "colored":
            raise ValueError(
                f"colored_anneal serves flip_mode='colored' configs, got "
                f"{config.flip_mode!r} — use fused_anneal / solve()")
        self.device = resolve_device(device)
        if plan is None:
            plan = colored_plan(
                problem, coupling if coupling is not None
                else config.coupling_format, num_planes=num_planes)
        elif coupling is not None:
            raise ValueError("pass a prebuilt plan= or a coupling= "
                             "override, not both")
        elif plan.coloring.num_spins != problem.num_spins:
            raise ValueError(f"prebuilt ColoredPlan is for N="
                             f"{plan.coloring.num_spins} but the problem "
                             f"has N={problem.num_spins}")
        self.problem = problem
        self.plan = plan.to(self.device)
        self.fmt = self.plan.store.fmt
        self._plan(config, chunk_steps)
        self.block_r = fit_block(config.num_replicas, block_r)
        self.base = rng.fold_in(rng.key(0), int(seed))  # on the CPU
        self.words = rng.words(self.base)
        self.pwl = solver_pwl_table(config, device=self.device)
        # The solve's (steps, R) temperatures and (steps, 3) class
        # schedule, made once; each chunk takes a row slice of both.
        self.temps, self.sched = colored_tables(
            self.plan, config, self.chunk_len, self.chunks, self.device)

    def init(self):
        state = fused_init_state(self.plan.problem, self.base,
                                 self.num_replicas,
                                 planes=self.plan.store.planes)
        return state + (torch.zeros(self.num_replicas, dtype=torch.int32,
                                    device=self.device),)

    def run_chunk(self, state, k: int):
        rows = self._rows(k)
        out, rf = colored_chunk_step(
            self.plan, state[:6], self.words, k, self.temps[rows],
            self.sched[rows], block_r=self.block_r, pwl_table=self.pwl,
            with_rows_fetched=True)
        return out + (state[6] + rf,)

    def best_energy(self, state) -> float:
        return float(state[3].min()) + float(self.problem.offset)

    def trace_row(self, state):
        return state[3]

    def finalize(self, state, rows) -> SolveResult:
        result = _result(state[:6], state[6], self._trace(rows),
                         self.plan.problem.offset, self.config)
        return result._replace(best_spins=unpermute_spins(
            self.plan, result.best_spins))


def colored_anneal(problem: ising.IsingProblem, seed, config: SolverConfig,
                   *, chunk_steps: int = 256, block_r: int = 8,
                   coupling: Optional[str] = None,
                   num_planes: Optional[int] = None,
                   plan: Optional[ColoredPlan] = None,
                   device=None) -> SolveResult:
    """Graph-colored annealing (``SolverConfig(flip_mode="colored")``).

    Flips one conflict-graph color class per step — every class member takes
    an independent heat-bath flip off the live local fields, exact block
    Gibbs because same-color spins share no coupling — so sparse instances
    do O(N/χ) flips per kernel step instead of 1. The selection-mode knobs
    (``config.mode``/``uniformized``) do not enter colored semantics; PWL vs
    exact flip probability, the schedule, trace cadence, ``num_flips`` and
    ``rows_fetched`` behave as in :func:`fused_anneal`, seed for seed with
    the JAX ``colored_anneal``.

    ``plan`` takes a prebuilt :func:`colored_plan` so repeated solves of one
    instance skip the coloring + permutation + store encode; ``coupling``
    overrides ``config.coupling_format`` when no plan is passed. ``block_r``
    is the replica group of ``rows_fetched`` (at most 8 on the card).
    Results are reported in the original vertex order. ``device`` as in
    :func:`repro_torch.device.resolve_device`. Runs every chunk of
    :class:`ColoredRunner`.
    """
    return ColoredRunner(problem, seed, config, chunk_steps=chunk_steps,
                         block_r=block_r, coupling=coupling,
                         num_planes=num_planes, plan=plan,
                         device=device).drive()
