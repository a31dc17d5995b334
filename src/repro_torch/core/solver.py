"""Annealed replica-ensemble solver (paper Alg. 1 + §V). Port of
``repro.core.solver``.

``solve(problem, seed, config, backend="fused")`` runs R independent
replicas of the dual-mode MCMC engine through the fused sweep kernel
(:func:`repro_torch.kernels.ops.fused_anneal`); ``backend="colored"`` runs
a ``flip_mode="colored"`` config through the graph-colored sweep
(:func:`repro_torch.kernels.ops.colored_anneal`). The other backends of the
JAX registry are later slices and raise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import ising
from .schedules import Schedule

#: Backends of the JAX registry and the ROADMAP item that ports each.
_LATER_BACKENDS = {
    "reference": "queue 1 item 6 (reference engine and statistical tier)",
    "tempering": "queue 1 item 9 (tempering)",
    "sharded": "queue 1 item 12 (multi-GPU)",
    "sharded_2d": "queue 1 item 12 (multi-GPU)",
    "distributed": "queue 1 item 12 (multi-GPU)",
    "auto": "queue 1 item 7 (registry and resilience)",
}


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


def solve(problem: ising.IsingProblem, seed, config: SolverConfig,
          backend: str = "fused", *, store=None, device=None) -> SolveResult:
    """Anneal ``problem`` from ``seed`` with ``backend="fused"`` (single-flip
    configs) or ``"colored"`` (``flip_mode="colored"`` configs). ``store``
    takes a prebuilt ``core.coupling.CouplingStore`` so repeated fused
    solves of one instance skip the resolve → encode (the colored backend
    builds its own, in color-sorted order, and refuses one); ``device`` as
    in :func:`repro_torch.device.resolve_device`."""
    if backend == "colored":
        _check_colored(config, store)
        from ..kernels.ops import colored_anneal

        return colored_anneal(problem, seed, config, device=device)
    if backend != "fused":
        where = _LATER_BACKENDS.get(backend)
        if where is None:
            raise ValueError(f"unknown backend {backend!r}")
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet (ROADMAP {where})")
    from ..kernels.ops import fused_anneal

    return fused_anneal(problem, seed, config, store=store, device=device)


def _check_colored(config: SolverConfig, store) -> None:
    """The guards of the JAX ``ColoredBackend``."""
    if config.flip_mode != "colored":
        raise ValueError(
            f"backend 'colored' serves flip_mode='colored' configs, got "
            f"{config.flip_mode!r}")
    if store is not None:
        raise ValueError(
            "backend='colored' rebuilds its store in color-sorted spin "
            "order; a prebuilt CouplingStore (original order) cannot be "
            "reused — memoize the ops.colored_plan instead")


def solve_many(problem: ising.IsingProblem, seeds, config: SolverConfig,
               backend: str = "fused", *, store=None,
               device=None) -> SolveResult:
    """Independent runs, one per seed, stacked on a new leading axis; a
    prebuilt ``store`` is encoded once and reused by every run."""
    runs = [solve(problem, int(s), config, backend, store=store,
                  device=device) for s in seeds]
    return SolveResult(*(torch.stack(field) for field in zip(*runs)))
