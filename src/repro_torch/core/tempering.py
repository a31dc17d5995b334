"""Parallel tempering (replica-exchange MCMC), the annealing alternative the
paper discusses and deliberately avoids (§IV-A). Port of
``repro.core.tempering``.

R replicas sit on a geometric temperature ladder and run the dual-mode
single-flip chains; every ``swap_every`` steps adjacent rungs exchange
configurations with the Metropolis probability

    P_swap = min(1, exp((1/T_i − 1/T_j)(E_i − E_j))),

even pairs first, then odd pairs. ``backend="fused"`` runs each
between-swap phase as one launch of the sweep kernel (``csrc/sweep.cu``)
with the ladder as its per-replica ``(T, R)`` temperature table;
``backend="reference"`` runs the plain PyTorch chains of ``core.mcmc``.

The swap is plain PyTorch on the device, with no copy to the host inside
the loop: its uniforms, ``uniform01(stream(base, UNIFORMIZE, round,
parity), (R−1,))``, depend only on the seed and the round, so a solve
draws them once as a ``(rounds, 2, R−1)`` table (an inactive pair's entry
is 2, which no probability exceeds); the energies, the accept masks, the
permutation and the accept counter stay tensors. On the card the merge
and the swap of a round are one CUDA-graph replay. The fused loop is
:class:`TemperingRunner`'s: ``solve_tempering`` runs every round of it,
the resilient supervisor the same rounds with snapshots between.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import ising, mcmc, rng
from ..device import resolve_device
from .pwl import make_flip_probability, make_pwl_sigmoid, pwl_table
from .solver import ChunkRunner, reference_init_state, run_reference_chunk

#: The uniform an inactive pair reads: above every probability, so the
#: pair never swaps.
INACTIVE_UNIFORM = 2.0


@dataclasses.dataclass(frozen=True)
class TemperingConfig:
    """The JAX ``TemperingConfig``: the same fields and defaults."""

    num_steps: int
    t_min: float
    t_max: float
    num_replicas: int = 8        # temperature-ladder rungs
    swap_every: int = 10
    mode: str = "rsa"            # kernel for within-chain moves
    use_pwl: bool = True
    backend: str = "reference"   # "reference" | "fused"
    coupling_format: str = "auto"  # fused-backend J store
    #: Tempering runs single-spin chains (the swap-acceptance argument of
    #: §IV-A is about one-flip chains); "colored" is refused.
    flip_mode: str = "single"

    @property
    def ladder(self) -> np.ndarray:
        return np.geomspace(self.t_max, self.t_min, self.num_replicas)


class TemperingResult(NamedTuple):
    best_energy: torch.Tensor      # (R,) incl. problem offset
    best_spins: torch.Tensor       # (R, N) int8
    final_energy: torch.Tensor     # (R,)
    swap_acceptance: torch.Tensor  # () mean accepted swap fraction
    num_flips: torch.Tensor        # (R,) int32


def tempering_round_count(config: TemperingConfig) -> int:
    """Swap rounds per run: the unit count of the tempering trajectory
    (each round is a ``swap_every``-step sweep and a swap phase)."""
    return max(config.num_steps // config.swap_every, 1)


def ladder_temps(config: TemperingConfig, device=None) -> torch.Tensor:
    """The (R,) f32 ladder, hottest rung first (the f64 ``ladder`` rounded
    to f32, as ``jnp.asarray(ladder, float32)`` does)."""
    return torch.from_numpy(config.ladder.astype(np.float32)).to(device)


def swap_dbeta(temps: torch.Tensor) -> torch.Tensor:
    """(R−1,) f32 ``1/T_i − 1/T_{i+1}`` of the adjacent pairs."""
    beta = 1.0 / temps
    return beta[:-1] - beta[1:]


def swap_uniforms(base: torch.Tensor, rounds: torch.Tensor,
                  r: int) -> torch.Tensor:
    """(len(rounds), 2, R−1) f32 swap uniforms of the given rounds: entry
    ``[k, p]`` is ``uniform01(stream(base, UNIFORMIZE, rounds[k], p),
    (R−1,))``, the draw of round k's parity-p phase."""
    keys = rng.stream(base, rng.Salt.UNIFORMIZE, rounds.to(torch.int64))
    keys = rng.fold_in(keys[:, None, :], torch.arange(2))
    return rng.uniform01(keys, (r - 1,))


def swap_table(base: torch.Tensor, rounds: int, r: int) -> torch.Tensor:
    """The solve's (rounds, 2, R−1) swap uniforms with every inactive
    pair's entry (pair i in the phase of the other parity) set to
    :data:`INACTIVE_UNIFORM`. Made on the CPU; a solve copies it once."""
    return _mask_inactive(swap_uniforms(base, torch.arange(rounds), r))


def _mask_inactive(u: torch.Tensor) -> torch.Tensor:
    """``u`` (..., 2, R−1) with pair i's entry in phase p set to
    :data:`INACTIVE_UNIFORM` where i's parity is not p."""
    parity = torch.arange(u.shape[-1]) % 2
    active = parity[None, :] == torch.arange(2)[:, None]     # (2, R−1)
    return torch.where(active, u, INACTIVE_UNIFORM)


def swap_permutation(energy: torch.Tensor, uniforms: torch.Tensor,
                     dbeta: torch.Tensor):
    """The Metropolis exchange of one round on the device: ``energy`` (R,),
    ``uniforms`` the round's (2, R−1) row of :func:`swap_table`. The even
    phase accepts pair i where ``u < min(exp(clip(Δβ·ΔE, −80, 80)), 1)``;
    the odd phase reads the energies the even one left. Returns the (R,)
    composed permutation (``x[perm]`` is the swapped state) and the (R−1,)
    int64 accept counts of the round (0, 1 or, never, 2 per pair)."""
    r = energy.shape[0]
    perm = None
    accepted = None
    e = energy
    for parity in (0, 1):
        if perm is not None:
            e = energy[perm]
        p = torch.clamp(torch.exp(torch.clamp(dbeta * (e[:-1] - e[1:]),
                                              -80.0, 80.0)), max=1.0)
        a = (uniforms[parity] < p).to(torch.int64)
        # Accepted pairs are disjoint: i takes i+1's state and i+1 takes i's.
        step = torch.arange(r, device=energy.device)
        step[:-1] += a
        step[1:] -= a
        perm = step if perm is None else perm[step]
        accepted = a if accepted is None else accepted + a
    return perm, accepted


def swap_round(state, energy: torch.Tensor, uniforms: torch.Tensor,
               dbeta: torch.Tensor):
    """The swap phase on any tuple of tensors with a leading replica axis:
    ``(state permuted, accepted swaps)``, the count a () int32 tensor."""
    perm, accepted = swap_permutation(energy, uniforms, dbeta)
    return (tuple(x[perm] for x in state),
            accepted.sum().to(torch.int32))


def _swap_phase(state, energy_of, temps: torch.Tensor, base: torch.Tensor,
                round_idx: int, r: int):
    """The JAX signature of the swap: ``state`` a tuple of tensors with a
    leading replica axis, ``energy_of(state)`` its (R,) energies, ``temps``
    the (R,) ladder. Draws round ``round_idx``'s uniforms itself. Returns
    ``(state, (accepted, attempted))`` as the JAX function does."""
    dev = temps.device
    uniforms = _mask_inactive(
        swap_uniforms(base, torch.tensor([round_idx]), r)[0]).to(dev)
    state, accepted = swap_round(state, energy_of(state), uniforms,
                                 swap_dbeta(temps))
    return state, (accepted, torch.tensor(r - 1, dtype=torch.int32,
                                          device=dev))


def _flip_probability(config: TemperingConfig):
    return make_flip_probability(make_pwl_sigmoid() if config.use_pwl
                                 else None)


def _check_single_flip(config: TemperingConfig) -> None:
    if config.flip_mode != "single":
        raise ValueError(
            f"tempering runs single-flip chains only (flip_mode="
            f"{config.flip_mode!r}); colored block updates are served by "
            "solve(..., backend='colored') on a SolverConfig")


def _solve_tempering_reference(problem: ising.IsingProblem, seed,
                               config: TemperingConfig,
                               device=None) -> TemperingResult:
    """The reference chains (``core.mcmc``, plain PyTorch, no kernel): each
    replica's step t keyed by ``stream(replica key, t)`` at its rung's
    temperature, a swap phase every ``swap_every`` steps."""
    dev = resolve_device(device)
    problem = problem.to(dev)
    r = config.num_replicas
    mc = mcmc.MCMCConfig(mode=config.mode,
                         flip_prob=_flip_probability(config))
    ladder = ladder_temps(config)
    temps = ladder[None].expand(config.swap_every, r).contiguous().to(dev)
    if config.mode == "rwa":
        # An RWA step weighs all N spins of a chain at that chain's T.
        temps = temps[..., None]
    dbeta = swap_dbeta(ladder).to(dev)
    base = rng.fold_in(rng.key(0), int(seed))
    rounds = tempering_round_count(config)
    table = swap_table(base, rounds, r).to(dev)
    states, keys = reference_init_state(problem, seed, config)
    acc = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(rounds):
        states = run_reference_chunk(
            problem, states, keys, k, clen=config.swap_every,
            chunk_len=config.swap_every, mc=mc, temps=temps)
        swapped, a = swap_round(tuple(states), states.energy, table[k],
                                dbeta)
        states = mcmc.ChainState(*swapped)
        acc = acc + a
    tot = torch.tensor(rounds * (r - 1), dtype=torch.int32, device=dev)
    return TemperingResult(
        best_energy=states.best_energy + problem.offset,
        best_spins=states.best_spins,
        final_energy=states.energy + problem.offset,
        swap_acceptance=acc.to(torch.float32) / torch.clamp(tot, min=1),
        num_flips=states.num_flips)


def _round_sweep(store, state, base_words, round_idx: int,
                 config: TemperingConfig, temps: torch.Tensor,
                 pwl_table: Optional[torch.Tensor], out=None):
    """The round's sweep: ``swap_every`` keyed steps on round ``round_idx``'s
    ``Salt.SWEEP`` stream at the ladder ``temps`` ((swap_every, R), a
    column per replica), from the state's u, s, e. Returns the sweep's
    seven outputs (written into ``out`` when given, on the card)."""
    from ..kernels import sweep
    from ..kernels.common import fit_block

    u, s, e = state[:3]
    return sweep.mcmc_sweep_keyed(
        store.kernel_operand, u, s, e, base_words, round_idx, temps,
        pwl_table, mode=config.mode, coupling=store.fmt,
        block_r=fit_block(config.num_replicas, 8), coalesce=False, out=out)


def merge_and_swap(state, swept, uniforms: torch.Tensor,
                   dbeta: torch.Tensor):
    """The rest of a round: the best merge of the sweep's outputs ``swept``
    into the 8-tuple ``state``, then the swap on the round's ``uniforms``
    row. Returns the new 8-tuple; every operation is queued on the state's
    device and nothing is read back."""
    from ..kernels import ops

    r = state[2].shape[0]
    merged = ops._merge(state[:6], swept, False)
    merged, accepted = swap_round(merged, merged[2], uniforms, dbeta)
    return merged + (state[6] + accepted, state[7] + (r - 1))


def fused_tempering_round(state, base_words, round_idx: int,
                          config: TemperingConfig, store, *,
                          temps: torch.Tensor, dbeta: torch.Tensor,
                          uniforms: torch.Tensor,
                          pwl_table: Optional[torch.Tensor]):
    """One tempering round on the sweep kernel, op by op: the sweep, the
    merge and the swap. ``state`` is the 8-tuple ``(u, s, e, best_e,
    best_s, num_flips, accepted, attempted)``."""
    swept = _round_sweep(store, state, base_words, round_idx, config, temps,
                         pwl_table)
    return merge_and_swap(state, swept, uniforms, dbeta)


class _RoundGraph:
    """A round's merge and swap captured once in a CUDA graph over static
    buffers (the card only): the sweep writes its seven outputs into
    ``swept``, the round's uniform row is copied into ``uniforms``, and one
    replay runs the ~37 small launches of :func:`merge_and_swap`, leaving
    the new state in ``state``. The host then pays three launches a round
    instead of ~38; the operations, and so the values, are the op-by-op
    round's."""

    def __init__(self, r: int, n: int, dbeta: torch.Tensor):
        dev = dbeta.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = (zeros(r, n), zeros(r, n), zeros(r), zeros(r),
                      zeros(r, n), zeros(r, dtype=torch.int32),
                      zeros(dtype=torch.int32), zeros(dtype=torch.int32))
        self.swept = (zeros(r, n), zeros(r, n), zeros(r), zeros(r),
                      zeros(r, n), zeros(r, dtype=torch.int32),
                      zeros(r, dtype=torch.int32))
        self.uniforms = zeros(2, r - 1)
        self.dbeta = dbeta
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()      # a warm-up outside the capture
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.cuda.graph(self.graph):
                self._body()

    def _body(self) -> None:
        new = merge_and_swap(self.state, self.swept, self.uniforms,
                             self.dbeta)
        for dst, src in zip(self.state, new):
            dst.copy_(src)

    def load(self, state) -> None:
        """Copy a state that is not already the graph's into its buffers."""
        if any(a is not b for a, b in zip(state, self.state)):
            for dst, src in zip(self.state, state):
                dst.copy_(src)


class TemperingRunner(ChunkRunner):
    """``solve_tempering(backend="fused")``, one swap round per unit. The
    store, the replica init, the ladder table and the swap uniforms are
    made once; the state is the sweep's 6-tuple ``(u, s, e, best_e,
    best_s, num_flips)`` plus the () int32 accepted and attempted swap
    counts, so the acceptance survives a resume. On the card a round is
    the sweep plus one replay of a :class:`_RoundGraph`, and the state a
    round returns is the graph's buffers, valid until the next round (a
    snapshot copies it to the host first); on the CPU it runs op by op."""

    backend = "tempering"

    def __init__(self, problem: ising.IsingProblem, seed,
                 config: TemperingConfig, *, store=None, device=None):
        from ..kernels import ops

        if config.backend != "fused":
            raise ValueError(
                "the chunked tempering runner serves the fused backend only "
                "(the reference chains run the plain PyTorch engine); set "
                "TemperingConfig(backend='fused')")
        _check_single_flip(config)
        self.device = resolve_device(device)
        self.problem, self.store = ops.fused_operands(
            problem, config, self.device, store=store,
            caller="solve_tempering")
        self.fmt = self.store.fmt
        self.config = config
        r = config.num_replicas
        self.num_replicas = r
        self.total_units = tempering_round_count(config)
        self.collect_trace = False
        self.base = rng.fold_in(rng.key(0), int(seed))   # on the CPU
        self.words = rng.words(self.base)
        self.pwl = (pwl_table(device=self.device) if config.use_pwl
                    else None)
        ladder = ladder_temps(config)
        self.temps = ladder[None].expand(config.swap_every, r).contiguous().to(
            self.device)
        self.dbeta = swap_dbeta(ladder).to(self.device)
        self.uniforms = swap_table(self.base, self.total_units, r).to(
            self.device)
        self._graph = None

    def unit_len(self, k: int) -> int:
        return self.config.swap_every

    def init(self):
        from ..kernels import ops

        state = ops.fused_init_state(self.problem, self.base,
                                     self.num_replicas,
                                     planes=self.store.planes)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return state + (zero, zero.clone())

    def run_chunk(self, state, k: int):
        if self.device.type != "cuda":
            return fused_tempering_round(
                state, self.words, k, self.config, self.store,
                temps=self.temps, dbeta=self.dbeta,
                uniforms=self.uniforms[k], pwl_table=self.pwl)
        if self._graph is None:
            self._graph = _RoundGraph(self.num_replicas,
                                      self.problem.num_spins, self.dbeta)
        g = self._graph
        g.load(state)
        _round_sweep(self.store, g.state, self.words, k, self.config,
                     self.temps, self.pwl, out=g.swept)
        g.uniforms.copy_(self.uniforms[k])
        g.graph.replay()
        return g.state

    def best_energy(self, state) -> float:
        return float(state[3].min()) + float(self.problem.offset)

    def trace_row(self, state):
        return state[3]

    def finalize(self, state, rows) -> TemperingResult:
        _, _, e, be, bs, nf, acc, tot = state
        off = self.problem.offset
        return TemperingResult(
            best_energy=be + off, best_spins=bs.to(ising.SPIN_DTYPE),
            final_energy=e + off,
            swap_acceptance=acc.to(torch.float32) / torch.clamp(tot, min=1),
            num_flips=nf.clone())


def solve_tempering(problem: ising.IsingProblem, seed,
                    config: TemperingConfig, *, store=None,
                    device=None) -> TemperingResult:
    """Parallel tempering of ``problem`` from ``seed``. The fused backend
    resolves ``config.coupling_format`` into a ``CouplingStore`` (an edge
    list is encoded in O(nnz), no dense J), or takes a prebuilt ``store``
    so repeated ladders of one instance skip the encode, and runs every
    round of :class:`TemperingRunner`; the reference backend reads the
    dense J. ``device`` as in :func:`repro_torch.device.resolve_device`."""
    _check_single_flip(config)
    if config.backend == "fused":
        return TemperingRunner(problem, seed, config, store=store,
                               device=device).drive()
    if store is not None:
        raise ValueError("a prebuilt CouplingStore serves the fused backend "
                         "only; backend='reference' always consumes the "
                         "dense J")
    if config.backend != "reference":
        raise ValueError(
            f"backend must be 'reference' or 'fused', got {config.backend!r}")
    if problem.couplings is None:
        raise ValueError(
            "backend='reference' tempering needs the dense J; edge-list "
            "(dense-J-free) problems are served by the fused backend")
    return _solve_tempering_reference(problem, seed, config, device)
