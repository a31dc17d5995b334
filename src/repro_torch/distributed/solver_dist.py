"""Replica-parallel Snowball with elitist exchange. Port of
``repro.distributed.solver_dist``.

Replicas (independent chains, the TTS trials) are split over every rank of
the mesh, ``replicas_per_device`` each; J is whole on every rank (dense, or
the planes). Every ``exchange_every`` chunks the best configuration of the
whole mesh is sent to every rank (a min of the best energies, then a
one-hot vote and count summed in int32) and each rank restarts its worst
replicas from it. Ranks draw disjoint streams: the fused chunk runs
**kernel A** on ``stream(base, SWEEP, rank index, chunk)`` (the sweep's
device fold), the init is **kernel B** on a dense J or **kernel C** on the
planes, and the "reference" backend runs ``core.mcmc`` on the replicas'
own keys. Every rank calls the same entry point (SPMD) and gets the whole
``SolveResult``, put together on every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import ising, mcmc, rng
from ..core.solver import (ChunkRunner, SolveResult, SolverConfig,
                           _mcmc_config, require_dense, run_reference_chunk,
                           step_temperatures)
from ..device import resolve_device
from ..kernels import common, ops
from . import mesh as M


@dataclasses.dataclass(frozen=True)
class DistSolverConfig:
    base: SolverConfig
    replicas_per_device: int = 1
    exchange_every: int = 0      # chunks between best-exchange; 0 = never
    restart_fraction: float = 0.25  # worst fraction restarted at exchange
    backend: str = "reference"   # "reference" | "fused" per-chunk engine


def elitist_exchange(states: mcmc.ChainState, chain_init, mesh, *,
                     restart_fraction: float) -> mcmc.ChainState:
    """The best configuration of the whole mesh (a min of the best
    energies; every rank holding it votes its first such replica's spins,
    the vote and the voter count summed in int32) restarts this rank's
    worst replicas (by current energy, stable order); a vote the ties
    cancel leaves them where they are."""
    dims = mesh.mesh_dim_names
    r_local, n = states.best_spins.shape
    global_best = M.all_reduce(states.best_energy.min().reshape(1), mesh,
                               dims, "min")[0]
    is_best = states.best_energy == global_best
    any_best = is_best.any()
    first = states.best_spins[is_best.to(torch.int32).argmax()]
    vote = torch.cat([
        torch.where(any_best, first.to(torch.int32),
                    torch.zeros(n, dtype=torch.int32, device=first.device)),
        any_best.to(torch.int32).reshape(1)])
    M.all_reduce(vote, mesh, dims)
    best_spins = torch.sign(vote[:n]).to(states.spins.dtype)
    usable = (best_spins != 0).any() & (vote[n] > 0)
    order = torch.argsort(states.energy, stable=True)
    k_restart = max(int(r_local * restart_fraction), 1)
    for j in order[-k_restart:].tolist():
        spins = torch.where(usable, best_spins, states.spins[j])
        st = chain_init(spins[None])
        improved = st.energy[0] < states.best_energy[j]
        sp, fu, en, be, bs = (x.clone() for x in states[:5])
        sp[j], fu[j], en[j] = st.spins[0], st.fields[0], st.energy[0]
        be[j] = torch.minimum(states.best_energy[j], st.energy[0])
        bs[j] = torch.where(improved, st.spins[0], states.best_spins[j])
        states = mcmc.ChainState(sp, fu, en, be, bs, states.num_flips)
    return states


class DistRunner(M.MeshRunner, ChunkRunner):
    """``solve_distributed`` as a chunk plan: chunks of ``trace_every``
    steps (64 untraced), ``max(num_steps // chunk, 1)`` of them, the
    exchange after every ``exchange_every``-th. The state is this rank's
    ``mcmc.ChainState`` of R/D replicas as a tuple (the fused backend keeps
    its spins in f32, the kernel's layout); the trace is always on."""

    backend = "distributed"

    def __init__(self, problem: ising.IsingProblem, seed,
                 config: DistSolverConfig, mesh, *, device=None):
        if config.backend not in ("reference", "fused"):
            raise ValueError(f"backend must be 'reference' or 'fused', got "
                             f"{config.backend!r}")
        self.device = resolve_device(device)
        M.check_mesh_device(mesh, self.device)
        self.mesh = mesh
        self.dist_config = config
        base_cfg = config.base
        self.config = base_cfg
        dims = mesh.mesh_dim_names
        self.r_local = config.replicas_per_device
        self.num_replicas = self.r_local * M.mesh_size(mesh, dims)
        self.idx = M.flat_shard_index(mesh, dims)
        self.chunk_len = base_cfg.trace_every or 64
        self.total_units = max(base_cfg.num_steps // self.chunk_len, 1)
        self.collect_trace = True
        self.offset = float(problem.offset)
        steps = self.total_units * self.chunk_len
        base = rng.fold_in(rng.key(0), int(seed))  # on the CPU
        self.words = rng.words(base)
        self.keys = rng.stream(base, rng.Salt.REPLICA, self.idx * self.r_local
                               + torch.arange(self.r_local))
        if config.backend == "fused":
            self.problem, self.store = ops.fused_operands(
                problem, base_cfg, self.device, caller="solve_distributed")
            self.fmt = self.store.fmt
            self.pwl = ops.solver_pwl_table(base_cfg, device=self.device)
            self.block_r = common.fit_block(self.r_local, 8)
            temps = torch.cat([ops._chunk_schedule(base_cfg, c,
                                                   self.chunk_len,
                                                   self.chunk_len)
                               for c in range(self.total_units)])
        else:
            require_dense(problem)
            self.problem, self.store = problem.to(self.device), None
            self.fmt = "dense"
            self.mc = _mcmc_config(base_cfg)
            temps = step_temperatures(base_cfg.schedule, steps)
        self.temps = temps.to(self.device)

    def unit_len(self, k: int) -> int:
        return self.chunk_len

    def _rows(self, k: int) -> slice:
        return slice(k * self.chunk_len, (k + 1) * self.chunk_len)

    def chain_init(self, spins: torch.Tensor) -> mcmc.ChainState:
        """Chains from scratch at ``spins`` (k, N): ``mcmc.init_chain`` for
        the reference engine; for the fused one u from kernel B on a dense
        J or kernel C on the planes (e from ``ising.energy``, or from
        ``energy_from_fields`` on the plane u^(J)), spins in f32."""
        if self.store is None:
            return mcmc.init_chain(self.problem, spins)
        s = spins.to(torch.float32)
        h = self.problem.fields
        if self.store.planes is not None:
            u_j = ops.plane_local_fields(self.store.planes, s)
            u, e = u_j + h[None, :], ising.energy_from_fields(u_j, s, h)
        else:
            u, e = ops.init_fields(self.problem, s), ising.energy(
                self.problem, s)
        return mcmc.ChainState(
            spins=s, fields=u, energy=e, best_energy=e.clone(),
            best_spins=s.clone(),
            num_flips=torch.zeros(s.shape[0], dtype=torch.int32,
                                  device=s.device))

    def init(self):
        spins = ising.random_spins(rng.stream(self.keys, rng.Salt.INIT),
                                   (self.problem.num_spins,))
        return tuple(self.chain_init(spins.to(self.device)))

    def run_chunk(self, state, k: int):
        states = mcmc.ChainState(*state)
        temps = self.temps[self._rows(k)]
        if self.store is not None:
            sp, fu, en, be, bs, nf = states
            u, s, e, be, bs, nf = ops.keyed_sweep_chunk(
                self.store.kernel_operand, (fu, sp, en, be, bs, nf),
                self.words, k, temps[:, None].expand(-1, self.r_local)
                .contiguous(), mode=self.config.mode,
                uniformized=self.config.uniformized, pwl_table=self.pwl,
                block_r=self.block_r, coupling=self.fmt, fold=self.idx)
            states = mcmc.ChainState(s, u, e, be, bs, nf)
        else:
            states = run_reference_chunk(
                self.problem, states, self.keys, k, clen=self.chunk_len,
                chunk_len=self.chunk_len, mc=self.mc, temps=temps)
        every = self.dist_config.exchange_every
        if every and (k + 1) % every == 0:
            states = elitist_exchange(
                states, self.chain_init, self.mesh,
                restart_fraction=self.dist_config.restart_fraction)
        return tuple(states)

    def _replica_vector(self, x: torch.Tensor) -> torch.Tensor:
        at = slice(self.idx * self.r_local, (self.idx + 1) * self.r_local)
        return M.assemble(x, (self.num_replicas,) + tuple(x.shape[1:]),
                          (at,), self.mesh, self.mesh.mesh_dim_names)

    def best_energy(self, state) -> float:
        return float(self.trace_row(state).min()) + self.offset

    def trace_row(self, state):
        return self._replica_vector(state[3])

    def snapshot_state(self, state) -> tuple:
        """The whole state, every rank's replicas, on every rank (spins as
        int32 for the sum)."""
        return tuple(self._replica_vector(x.to(torch.int32)).to(x.dtype)
                     if x.dtype == torch.int8 else self._replica_vector(x)
                     for x in state)

    def local_state(self, state) -> tuple:
        at = slice(self.idx * self.r_local, (self.idx + 1) * self.r_local)
        return tuple(x[at].contiguous() for x in state)

    def finalize(self, state, rows) -> SolveResult:
        sp, fu, en, be, bs, nf = self.snapshot_state(state)
        trace = (torch.stack(self._trace(rows)) if rows else
                 torch.zeros((0, self.num_replicas), dtype=torch.float32,
                             device=self.device))
        return SolveResult(best_energy=be + self.offset,
                           best_spins=bs.to(ising.SPIN_DTYPE),
                           final_energy=en + self.offset, num_flips=nf,
                           trace_energy=trace + self.offset)


def solve_distributed(problem: ising.IsingProblem, seed,
                      config: DistSolverConfig, mesh, *,
                      device=None) -> SolveResult:
    """Replica-parallel annealing over every dim of ``mesh`` (a
    ``DeviceMesh``; SPMD: every rank calls it alike and gets the whole
    result, R = replicas_per_device × ranks replicas in rank order).
    ``device`` as in :func:`repro_torch.device.resolve_device`; it must
    match the mesh's device type."""
    return DistRunner(problem, seed, config, mesh, device=device).drive()
