"""The synchronous multi-tenant solver service. Port of
``repro.serve.service``.

:class:`SolverService` is built only on the ``core.backend`` registry, so
every registered execution path is servable:

* **Admission** (:meth:`SolverService.submit`): a bounded pending queue,
  instance-size and step-budget caps, and capability checks against the
  registry (an edge-list problem aimed at a path without edge-list support
  is refused at submit, as is a mesh path on a service without a mesh).
  Per-request :class:`~repro_torch.core.resilience.BudgetConfig` budgets
  run under ``run_resilient`` and return the best-so-far with its
  ``stop_reason``.
* **Caching**: a shared :class:`~repro_torch.serve.cache.LRUStoreCache`
  holds each instance's coupling store on the service's device, so a
  repeat solve encodes nothing and copies no J to the card; a
  :class:`~repro_torch.serve.cache.WarmStartCache` answers a request whose
  ``target_energy`` was already reached without any launch
  (``stop_reason="cached_target"``).
* **Batching** (:meth:`SolverService.drain`): pending requests are
  shape-bucketed and planned by
  :func:`~repro_torch.serve.batching.plan_batches`. Same-instance requests
  stack into the replica axis of one fused launch, seed-pinned requests
  take the ``solve_many`` lane (each lane equal to its solo solve), the
  rest launch singly. ``ServeConfig(batching=False)`` launches once per
  request.

The service runs on one device (``device=``, default the card), or with
``mesh=`` (a ``DeviceMesh`` of that device type) also serves the mesh paths
("sharded", "sharded_2d", "distributed") SPMD: every rank constructs the
service and submits the same requests in the same order, and every rank's
drain returns the same results. The API is synchronous: ``submit`` then
``drain``, or the one-shot ``solve``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import ising
from ..core.backend import get_backend
from ..core.resilience import BudgetConfig, run_resilient
from ..core.solver import SolveResult, SolverConfig, solve_many
from ..device import DeviceLike, resolve_device
from .batching import bucket_spins, pad_problem, plan_batches
from .cache import LRUStoreCache, WarmStartCache, problem_digest


class AdmissionError(RuntimeError):
    """The request was refused at the door (queue full, instance or budget
    over the service caps, or a capability mismatch); nothing was
    enqueued."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service policy knobs."""
    max_pending: int = 256          # admission queue bound
    max_spins: int = 16384          # largest admissible instance
    max_steps: int = 1_000_000      # largest admissible per-request num_steps
    store_cache_entries: int = 16
    warm_cache_entries: int = 256
    pad_spins: bool = True          # bucket N (see batching.SPIN_BUCKETS)
    batching: bool = True           # False = one launch per request
    max_stack_replicas: int = 256   # replica-axis cap per stacked launch


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One tenant request. ``seed=None`` lets the service pick (and makes
    the request stackable); a pinned seed makes the result equal to
    ``solve(padded problem, seed, config)`` alone, batched or not.
    ``budget`` routes the run through the resilient supervisor."""
    problem: ising.IsingProblem
    config: SolverConfig
    seed: Optional[int] = None
    budget: Optional[BudgetConfig] = None
    backend: str = "fused"


class ServeResult(NamedTuple):
    request_id: int
    result: SolveResult        # replica-sliced back to the request's shape
    stop_reason: str           # "completed" | budget reasons | "cached_target"
    batched: str               # "stack" | "vmap" | "single" | "budgeted" | "cached"
    store_hit: bool            # coupling store came from the cache (0 encodes)
    warm_hit: bool             # answered or bettered by the warm-start cache
    wall_seconds: float        # admission -> result assembly


@dataclasses.dataclass
class _Admitted:
    id: int
    request: SolveRequest
    problem: ising.IsingProblem     # padded to the spin bucket
    orig_n: int
    problem_key: str                # warm-start key (padded problem content)
    config: SolverConfig
    seed: Optional[int]
    t_submit: float

    # plan_batches reads .problem_key / .config / .seed from its items.


class SolverService:
    """See the module docstring. All state (queue, caches, counters) is
    host-side and single-threaded; the stores live on ``device``."""

    def __init__(self, config: ServeConfig = ServeConfig(), *,
                 device: DeviceLike = None, mesh=None):
        self.config = config
        self.device = resolve_device(device)
        if mesh is not None:
            from ..distributed.mesh import check_mesh_device
            check_mesh_device(mesh, self.device)
        self.mesh = mesh
        self.stores = LRUStoreCache(config.store_cache_entries, self.device)
        self.warm = WarmStartCache(config.warm_cache_entries)
        self._pending: list = []
        self._next_id = 0
        self.stats = {"admitted": 0, "rejected": 0, "completed": 0,
                      "launches": 0, "stacked_requests": 0,
                      "vmapped_requests": 0, "single_requests": 0,
                      "budgeted_requests": 0, "cached_answers": 0}

    # ---------------------------------------------------------------- admit

    def submit(self, request: SolveRequest) -> int:
        """Admission-check and enqueue; returns the ticket id that
        :meth:`drain` answers. Raises :class:`AdmissionError` on refusal
        (``ValueError`` for an unknown backend name)."""
        cfg = self.config
        if len(self._pending) >= cfg.max_pending:
            self._reject(f"pending queue is full ({cfg.max_pending})")
        n = request.problem.num_spins
        if n > cfg.max_spins:
            self._reject(f"instance N={n} over the service cap "
                         f"{cfg.max_spins}")
        if request.config.num_steps > cfg.max_steps:
            self._reject(f"num_steps={request.config.num_steps} over the "
                         f"service cap {cfg.max_steps}; lower it or pass a "
                         f"BudgetConfig(max_steps=...) under the cap")
        caps = get_backend(request.backend).capabilities  # unknown raises
        if caps.needs_mesh and self.mesh is None:
            self._reject(f"backend {request.backend!r} needs a mesh; "
                         "construct SolverService(mesh=...)")
        if request.problem.couplings is None and not caps.edge_list:
            self._reject(f"backend {request.backend!r} cannot serve "
                         "edge-list (dense-J-free) problems")
        problem = request.problem
        if cfg.pad_spins:
            problem = pad_problem(problem, bucket_spins(n))
        admitted = _Admitted(
            id=self._next_id, request=request, problem=problem, orig_n=n,
            problem_key=problem_digest(problem), config=request.config,
            seed=request.seed, t_submit=time.perf_counter())
        self._next_id += 1
        self._pending.append(admitted)
        self.stats["admitted"] += 1
        return admitted.id

    def _reject(self, why: str):
        self.stats["rejected"] += 1
        raise AdmissionError(why)

    # ---------------------------------------------------------------- drain

    def drain(self) -> dict:
        """Run every pending request and return ``{ticket id:
        ServeResult}``, batched by :func:`plan_batches` unless
        ``ServeConfig(batching=False)``."""
        pending, self._pending = self._pending, []
        out: dict = {}
        plain = []
        for a in pending:
            if self._answer_from_warm_cache(a, out):
                continue
            if a.request.budget is not None:
                self._run_budgeted(a, out)
            elif a.request.backend != "fused" or not self.config.batching:
                self._run_single(a, out)
            else:
                plain.append(a)
        for plan in plan_batches(
                plain, max_stack_replicas=self.config.max_stack_replicas):
            self._run_plan(plan, out)
        self.stats["completed"] += len(out)
        return out

    def solve(self, problem: ising.IsingProblem, config: SolverConfig, *,
              seed: Optional[int] = None,
              budget: Optional[BudgetConfig] = None,
              backend: str = "fused") -> ServeResult:
        """One-shot synchronous request: submit, drain, unwrap."""
        ticket = self.submit(SolveRequest(problem=problem, config=config,
                                          seed=seed, budget=budget,
                                          backend=backend))
        return self.drain()[ticket]

    # ------------------------------------------------------------- execution

    def _store_for(self, a: _Admitted):
        """(store, hit) through the LRU cache when the backend takes one;
        the request's problem is rebound to the device."""
        caps = get_backend(a.request.backend).capabilities
        if not caps.supports_store:
            return None, False
        store, hit = self.stores.get_or_build(
            a.problem, getattr(a.config, "coupling_format", "auto"))
        fields = a.problem.fields.to(self.device)
        if store.dense is not None:
            # The cache key hashes the exact J bytes, so the cached device
            # J equals this request's: the problem takes it (the fused
            # path checks that a dense store holds the problem's own J),
            # and the request's own J is never copied to the card.
            a.problem = dataclasses.replace(a.problem, couplings=store.dense,
                                            fields=fields)
        else:
            a.problem = dataclasses.replace(a.problem, fields=fields)
        return store, hit

    def _effective_seed(self, a: _Admitted) -> int:
        # Service-assigned seeds are the ticket id: deterministic for a
        # given submission order, distinct across requests.
        return a.seed if a.seed is not None else a.id

    def _answer_from_warm_cache(self, a: _Admitted, out: dict) -> bool:
        budget = a.request.budget
        if budget is None or budget.target_energy is None:
            return False
        record = self.warm.lookup(a.problem_key)
        if record is None or record.energy > budget.target_energy:
            return False
        n, dev = a.orig_n, self.device
        energy = torch.tensor([record.energy], dtype=torch.float32,
                              device=dev)
        result = SolveResult(
            best_energy=energy,
            best_spins=torch.as_tensor(record.spins[None, :n],
                                       device=dev).to(ising.SPIN_DTYPE),
            final_energy=energy.clone(),
            num_flips=torch.zeros(1, dtype=torch.int32, device=dev),
            trace_energy=torch.zeros((0, 1), dtype=torch.float32,
                                     device=dev))
        self.stats["cached_answers"] += 1
        out[a.id] = ServeResult(
            request_id=a.id, result=result, stop_reason="cached_target",
            batched="cached", store_hit=True, warm_hit=True,
            wall_seconds=time.perf_counter() - a.t_submit)
        return True

    def _run_budgeted(self, a: _Admitted, out: dict):
        store, hit = self._store_for(a)
        rr = run_resilient(a.problem, self._effective_seed(a), a.config,
                           backend=a.request.backend, mesh=self.mesh,
                           budget=a.request.budget, store=store,
                           device=self.device)
        self.stats["launches"] += 1
        self.stats["budgeted_requests"] += 1
        self._finish(a, rr.result, _best_on_host(rr.result), out,
                     kind="budgeted", store_hit=hit,
                     stop_reason=rr.stop_reason)

    def _run_single(self, a: _Admitted, out: dict):
        store, hit = self._store_for(a)
        result = get_backend(a.request.backend).run(
            a.problem, self._effective_seed(a), a.config, mesh=self.mesh,
            store=store, device=self.device)
        self.stats["launches"] += 1
        self.stats["single_requests"] += 1
        self._finish(a, result, _best_on_host(result), out, kind="single",
                     store_hit=hit)

    def _run_plan(self, plan, out: dict):
        first = plan.requests[0]
        if plan.kind == "single":
            self._run_single(first, out)
            return
        store, hit = self._store_for(first)
        self.stats["launches"] += 1
        if plan.kind == "vmap":
            seeds = [a.seed for a in plan.requests]
            batched = solve_many(first.problem, seeds, plan.config,
                                 backend="fused", store=store,
                                 device=self.device)
            energies, spins = _best_on_host(batched)   # one read per plan
            for i, a in enumerate(plan.requests):
                lane = SolveResult(*(None if f is None else f[i]
                                     for f in batched))
                self.stats["vmapped_requests"] += 1
                self._finish(a, lane, (energies[i], spins[i]), out,
                             kind="vmap", store_hit=hit)
            return
        if plan.kind != "stack":
            raise ValueError(f"unknown plan kind {plan.kind!r}")
        result = get_backend(first.request.backend).run(
            first.problem, first.id, plan.config, mesh=self.mesh,
            store=store, device=self.device)
        energies, spins = _best_on_host(result)        # one read per plan
        for a, (off, r) in zip(plan.requests, plan.spans):
            span = slice(off, off + r)
            sliced = SolveResult(
                best_energy=result.best_energy[span],
                best_spins=result.best_spins[span],
                final_energy=result.final_energy[span],
                num_flips=result.num_flips[span],
                trace_energy=result.trace_energy[:, span])
            self.stats["stacked_requests"] += 1
            self._finish(a, sliced, (energies[span], spins[span]), out,
                         kind="stack", store_hit=hit)

    def _finish(self, a: _Admitted, result, host_best, out: dict, *,
                kind: str, store_hit: bool, stop_reason: str = "completed"):
        """Fold the result into the warm-start cache (from ``host_best``,
        the request's best energies and spins already on the host) and
        record it, its spins cut back to the unpadded N."""
        energies, spins = host_best
        record = self.warm.observe(a.problem_key, _Best(energies, spins))
        n = a.orig_n
        if result.best_spins.shape[-1] != n:
            result = result._replace(best_spins=result.best_spins[..., :n])
        out[a.id] = ServeResult(
            request_id=a.id, result=result, stop_reason=stop_reason,
            batched=kind, store_hit=store_hit,
            warm_hit=record.energy < float(np.min(energies)),
            wall_seconds=time.perf_counter() - a.t_submit)


class _Best(NamedTuple):
    best_energy: np.ndarray
    best_spins: np.ndarray


def _best_on_host(result) -> tuple:
    """``(best_energy, best_spins)`` of a result as host arrays: the one
    device-to-host read a plan makes for the warm-start cache."""
    return (result.best_energy.detach().cpu().numpy(),
            result.best_spins.detach().cpu().numpy())
