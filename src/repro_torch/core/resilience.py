"""Resilient solve supervisor: crash-safe checkpoint/resume, budgets and the
coupling-tier ladder. Port of ``repro.core.resilience``.

:func:`run_resilient` drives any registered backend's chunk runner
(``core.backend``: reference, fused, colored, tempering) one chunk at a
time:

* **Checkpoint/resume, bitwise.** Every chunk's random numbers are a pure
  function of (seed, chunk index), so a restarted run rebuilds the chunk
  plan from ``(config, chunk_steps)``, restores the newest snapshot
  (``checkpoint.manager``: temp dir + rename + sha256) onto the runner's
  device and replays the remaining chunks: bitwise the uninterrupted run.
* **Corruption.** A snapshot that fails its checksum or cannot be read is
  skipped, newest-first, and a fresh start follows when none survives. A
  ``run_dir`` holding another (problem, seed, config)'s snapshots is
  refused.
* **Budgets.** :class:`BudgetConfig` bounds the run by a deadline, a step
  count or a target energy, checked between chunks; a stop returns the
  best-so-far with its ``stop_reason``. ``KeyboardInterrupt`` stops the
  same way.
* **Tier ladder.** With ``coupling_format="auto"``, an allocation failure
  while building a store or running a chunk retries on the next device
  tier (dense → ``bitplane`` → ``bitplane_hbm``, then with a ``mesh`` the
  row-sharded ``bitplane_sharded`` / ``bitplane_sharded_2d``) from the last
  snapshot.
  The tiers run bitwise the same trajectory, so the result is unchanged;
  every downgrade is recorded on the result and in later snapshots. The
  ladder never moves to the CPU or to a plain version, acts on allocation
  failures only (a kernel build or launch error propagates), and drops
  every reference to the failed tier before it rebuilds.

* **Meshes.** With ``mesh=`` (a ``DeviceMesh``; SPMD: every rank calls
  alike) the runner's state is each rank's part. The mesh's rank 0 writes
  each snapshot, once per run directory, of the state put together on
  every rank; every rank resumes its part of the same snapshot, after a
  barrier, and the ranks take each stop decision together. The mesh is
  part of the run signature: a snapshot resumes under the same mesh.

Fault injection for tests rides on :func:`inject_faults`, a hook fired at
the supervisor's seams ("store_build", "chunk_start", "checkpoint_saved").
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import re
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import ising
from .backend import current_fmt as _current_fmt
from .backend import fallback_enabled as _fallback_enabled
from .backend import get_backend, resolve_backend
from .coupling import CouplingStore, _integral
from ..checkpoint import manager as ckpt
from ..checkpoint.manager import SnapshotCorruptError

STOP_COMPLETED = "completed"
STOP_DEADLINE = "deadline"
STOP_MAX_STEPS = "max_steps"
STOP_TARGET = "target"
STOP_INTERRUPTED = "interrupted"
STOP_REASONS = (STOP_COMPLETED, STOP_DEADLINE, STOP_MAX_STEPS, STOP_TARGET,
                STOP_INTERRUPTED)


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """Between-chunk run bounds; each returns the best-so-far, never an
    exception. ``target_energy`` is compared with the ensemble-best energy
    including the problem offset."""
    deadline_seconds: Optional[float] = None
    max_steps: Optional[int] = None
    target_energy: Optional[float] = None


class ResilientResult(NamedTuple):
    result: object              # SolveResult (best-so-far)
    stop_reason: str            # one of STOP_REASONS
    steps_done: int             # steps advanced, resumed ones included
    chunks_done: int
    total_chunks: int
    resumed_from_chunk: Optional[int]   # the snapshot resumed from, or None
    downgrades: tuple           # ((from_fmt, to_fmt, at_chunk), ...)
    wall_seconds: float


# --------------------------------------------------------------------------
# Fault injection (tests): a hook at the supervisor's seams.

_fault_hook: Optional[Callable] = None


@contextlib.contextmanager
def inject_faults(hook: Callable[[str, dict], None]):
    """Install ``hook(site, info)`` for the block. Sites: "store_build"
    (before a tier's runner build; ``info["fmt"]``), "chunk_start" (before
    each chunk; ``info["chunk"]``), "checkpoint_saved" (after each
    snapshot). What the hook raises propagates into the supervisor."""
    global _fault_hook
    prev = _fault_hook
    _fault_hook = hook
    try:
        yield
    finally:
        _fault_hook = prev


def _fault(site: str, **info):
    if _fault_hook is not None:
        _fault_hook(site, info)


# --------------------------------------------------------------------------
# Allocation failures and the tier ladder.

_ALLOC_MESSAGE = re.compile(
    r"resource_exhausted|out of memory|failed to allocate|\boom\b")


def is_allocation_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a memory-allocation failure, the one class of
    error the tier ladder can fix: ``torch.cuda.OutOfMemoryError``, a host
    ``MemoryError``, or an error whose message says so (an allocator's
    "out of memory", XLA's RESOURCE_EXHAUSTED)."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    return bool(_ALLOC_MESSAGE.search(str(exc).lower()))


def next_tier(fmt: str, problem: ising.IsingProblem,
              mesh=None) -> Optional[str]:
    """The device tier to retry at after ``fmt`` failed to allocate, or None
    where the ladder ends: dense → bitplane (integral J only) →
    bitplane_hbm → with a mesh whose rows split N in whole roulette lanes,
    bitplane_sharded (bitplane_sharded_2d on a mesh of replica groups)."""
    if fmt == "dense":
        if problem.couplings is not None and not _integral(problem.couplings):
            return None             # a fractional J has no plane tier
        return "bitplane"
    if fmt == "bitplane":
        return "bitplane_hbm"
    if fmt == "bitplane_hbm" and mesh is not None:
        from ..kernels.common import default_lane
        num_rows = int(mesh.shape[-1])
        n = problem.num_spins
        if n % num_rows or (n // num_rows) % default_lane(n):
            return None             # an unshardable problem: the ladder ends
        return ("bitplane_sharded_2d" if mesh.ndim > 1
                else "bitplane_sharded")
    return None


# --------------------------------------------------------------------------
# Run identity: a snapshot resumed must belong to this run.

def problem_fingerprint(problem: ising.IsingProblem) -> str:
    """Content hash of the problem (couplings or edges, fields, offset)."""
    h = hashlib.sha256()
    if problem.couplings is not None:
        J = np.ascontiguousarray(problem.couplings.detach().cpu().numpy())
        h.update(b"dense")
        h.update(repr(J.shape).encode())
        h.update(J.tobytes())
    else:
        h.update(b"edges")
        h.update(problem.edges._digest)
    fields = np.ascontiguousarray(problem.fields.detach().cpu().numpy())
    h.update(fields.tobytes())
    h.update(np.float64(problem.offset).tobytes())
    return h.hexdigest()


def run_signature(problem: ising.IsingProblem, seed, config, *, backend: str,
                  chunk_steps: int, fingerprint: Optional[str] = None,
                  mesh=None) -> str:
    """Hash of what the chunk plan and the random streams depend on. The
    config is a frozen dataclass of plain values (its ``Schedule`` too), so
    its repr is the same in every process. ``fingerprint`` passes in the
    problem's :func:`problem_fingerprint` where the caller has it (a dense
    J is copied to the host and hashed for it). A mesh enters by its dims'
    names and sizes."""
    if fingerprint is None:
        fingerprint = problem_fingerprint(problem)
    mesh_desc = (None if mesh is None else tuple(
        zip(mesh.mesh_dim_names, (int(d) for d in mesh.shape))))
    parts = "|".join([
        f"seed={int(seed)}", f"backend={backend}",
        f"chunk_steps={int(chunk_steps)}", f"config={config!r}",
        f"mesh={mesh_desc!r}", f"problem={fingerprint}",
    ])
    return hashlib.sha256(parts.encode()).hexdigest()


# --------------------------------------------------------------------------
# Snapshots.

def _trace_template(runner, chunks: int):
    rows = chunks if runner.collect_trace else 0
    return np.zeros((rows, runner.num_replicas), np.float32)


def _save_snapshot(mgr: ckpt.CheckpointManager, runner, state, rows,
                   chunks_done: int, steps_done: int, signature: str,
                   fingerprint: str, downgrades):
    """Write the state at a chunk boundary. ``mgr.save`` copies every
    tensor to the host (a blocking copy from the card) before it writes.
    A runner on a mesh puts its state together on every rank (collectives)
    and only the mesh's rank 0 writes it."""
    if hasattr(runner, "snapshot_state"):
        state = runner.snapshot_state(state)
        if not runner.writes_snapshots:
            return
    trace = (np.stack(rows).astype(np.float32) if rows
             else _trace_template(runner, 0))
    mgr.save(chunks_done, {"state": state, "trace": trace},
             extra={"signature": signature, "fingerprint": fingerprint,
                    "chunks_done": chunks_done, "steps_done": steps_done,
                    "fmt": runner.fmt, "backend": runner.backend,
                    "downgrades": [list(d) for d in downgrades]})


def _try_resume(run_dir: str, runner, signature: str, fingerprint: str,
                emit):
    """Newest-first walk over the snapshots in ``run_dir``: a mismatched
    run is refused, a corrupt snapshot skipped with an event. Returns
    ``(state, rows, chunks_done, steps_done, downgrades)``, the state on the
    runner's device, or ``(None, [], 0, 0, [])`` to start fresh."""
    for step in reversed(ckpt.snapshot_steps(run_dir)):
        try:
            manifest = ckpt.read_manifest(run_dir, step)
        except SnapshotCorruptError as e:
            emit("snapshot_corrupt", {"step": step, "error": str(e)})
            continue
        extra = manifest.get("extra", {})
        if extra.get("fingerprint") not in (None, fingerprint):
            raise ValueError(
                f"run_dir {run_dir!r} holds snapshots of a different "
                f"problem (fingerprint mismatch at step_{step}) — refusing "
                f"to resume; point --run-dir at a fresh directory")
        if extra.get("signature") not in (None, signature):
            raise ValueError(
                f"run_dir {run_dir!r} holds snapshots of a different run "
                f"configuration (signature mismatch at step_{step}) — the "
                f"chunk plan would diverge; refusing to resume")
        template = {"state": runner.init(),
                    "trace": _trace_template(runner, step)}
        try:
            tree = ckpt.restore(run_dir, step, template)
        except SnapshotCorruptError as e:
            emit("snapshot_corrupt", {"step": step, "error": str(e)})
            continue
        rows = list(np.asarray(tree["trace"]))
        downgrades = [tuple(d) for d in extra.get("downgrades", [])]
        emit("resume", {"chunk": step, "fmt": extra.get("fmt")})
        state = tree["state"]
        if hasattr(runner, "local_state"):
            state = runner.local_state(state)
        return (state, rows, int(extra.get("chunks_done", step)),
                int(extra.get("steps_done", 0)), downgrades)
    return None, [], 0, 0, []


def _check_budget(budget: BudgetConfig, runner, state, steps_done: int,
                  t_start: float) -> Optional[str]:
    reason = _own_budget(budget, runner, state, steps_done, t_start)
    if hasattr(runner, "agree"):
        # The ranks of a mesh stop together: a deadline can pass on one
        # rank's clock before another's.
        code = runner.agree(0 if reason is None
                            else 1 + STOP_REASONS.index(reason))
        reason = None if code == 0 else STOP_REASONS[code - 1]
    return reason


def _own_budget(budget: BudgetConfig, runner, state, steps_done: int,
                t_start: float) -> Optional[str]:
    if budget.target_energy is not None:
        if runner.best_energy(state) <= budget.target_energy:
            return STOP_TARGET
    if budget.max_steps is not None and steps_done >= budget.max_steps:
        return STOP_MAX_STEPS
    if (budget.deadline_seconds is not None
            and time.monotonic() - t_start >= budget.deadline_seconds):
        return STOP_DEADLINE
    return None


# --------------------------------------------------------------------------
# The supervisor.

def run_resilient(problem: ising.IsingProblem, seed, config,
                  run_dir: Optional[str] = None, *, backend: str = "auto",
                  budget: Optional[BudgetConfig] = None,
                  chunk_steps: int = 256, checkpoint_every: int = 1,
                  keep: int = 3, resume: bool = True,
                  on_event: Optional[Callable] = None,
                  store: Optional[CouplingStore] = None,
                  device=None, mesh=None) -> ResilientResult:
    """Run a registered backend chunk by chunk with snapshots, budgets and
    the tier ladder: bitwise the monolithic solve it wraps.

    ``backend`` names a ``core.backend.BACKENDS`` entry, or "auto"
    ("fused" for single-flip configs, or "sharded" with a ``mesh``;
    "colored" for colored ones; "tempering" for a ``TemperingConfig``,
    whose units are swap rounds; "distributed" for a ``DistSolverConfig``).
    ``mesh`` (a ``DeviceMesh``) runs the mesh paths SPMD: every rank calls
    alike with the same ``run_dir``; the mesh's rank 0 writes the
    snapshots.
    ``run_dir=None`` disables snapshots (budgets and interrupts still
    work); with a directory, a snapshot is written every
    ``checkpoint_every`` chunks and at the last (the newest ``keep``
    stay), and ``resume=True`` continues from the newest valid one.
    ``chunk_steps`` is the untraced chunk length (with ``trace_every`` the
    chunks are the trace cadence); it is part of the run signature, since
    the fused streams are keyed per chunk. ``on_event(kind, info)``
    observes "build" (a runner built: its tier, host seconds and the
    runner itself, e.g. the colored plan), "resume", "chunk", "snapshot",
    "snapshot_corrupt", "tier_downgrade" and "stop". ``device`` as in
    :func:`repro_torch.device.resolve_device`.
    """
    t_start = time.monotonic()
    backend = resolve_backend(config, backend, mesh)
    budget = budget or BudgetConfig()
    emit = on_event or (lambda kind, info: None)
    # Snapshots are written on a thread while the next chunks run; the
    # state's copy to the host is made before each write starts. Only a
    # run with snapshots needs the run's identity (for a dense J, a copy
    # to the host and a sha256 of it).
    mgr = signature = fingerprint = None
    if run_dir is not None:
        mgr = ckpt.CheckpointManager(run_dir, keep=keep, async_save=True)
        fingerprint = problem_fingerprint(problem)
        signature = run_signature(problem, seed, config, backend=backend,
                                  chunk_steps=chunk_steps,
                                  fingerprint=fingerprint, mesh=mesh)
    downgrades: list = []
    fmt: Optional[str] = None
    resumed_from: Optional[int] = None

    def downgrade_or_raise(exc: BaseException, at_chunk: int) -> None:
        nonlocal fmt
        if not (_fallback_enabled(config, backend)
                and is_allocation_failure(exc)):
            raise exc
        cur = _current_fmt(problem, config, backend, fmt)
        nxt = next_tier(cur, problem, mesh)
        if nxt is None:
            raise exc
        downgrades.append((cur, nxt, at_chunk))
        emit("tier_downgrade", {"from": cur, "to": nxt, "chunk": at_chunk,
                                "error": str(exc)})
        fmt = nxt

    def build(at_chunk: int):
        """The runner on the current tier, stepping down the ladder on
        allocation failures. The failed attempt's exception (and with its
        traceback, the frames holding that tier's tensors) is released
        before the next build starts."""
        while True:
            try:
                _fault("store_build",
                       fmt=_current_fmt(problem, config, backend, fmt),
                       backend=backend)
                t0 = time.perf_counter()
                built = get_backend(backend).runner(
                    problem, seed, config, mesh=mesh,
                    chunk_steps=chunk_steps, fmt=fmt, store=store,
                    device=device)
                emit("build", {"fmt": built.fmt, "chunk": at_chunk,
                               "seconds": time.perf_counter() - t0,
                               "runner": built})
                return built
            except Exception as e:   # noqa: BLE001 — allocation triage
                downgrade_or_raise(e, at_chunk)
            _release_device_memory()

    runner = build(0)
    try:
        while True:   # the tier-retry loop around the chunk drive
            state, rows, k, steps_done = None, [], 0, 0
            try:
                if mgr is not None:
                    mgr.wait()     # a pending write lands before a resume
                if mgr is not None and hasattr(runner, "agree"):
                    # Rank 0's writes of an earlier run have landed before
                    # any rank reads the directory.
                    runner.agree(0)
                if mgr is not None and resume:
                    state, rows, k, steps_done, prior = _try_resume(
                        run_dir, runner, signature, fingerprint, emit)
                    if state is not None:
                        resumed_from = k
                        # Downgrades recorded before a crash survive it.
                        downgrades = prior + [d for d in downgrades
                                              if d not in prior]
                if state is None:
                    state = runner.init()
                total = runner.total_units
                stop_reason = STOP_COMPLETED
                try:
                    while k < total:
                        reason = _check_budget(budget, runner, state,
                                               steps_done, t_start)
                        if reason is not None:
                            stop_reason = reason
                            break
                        _fault("chunk_start", chunk=k, fmt=runner.fmt)
                        state = runner.run_chunk(state, k)
                        steps_done += runner.unit_len(k)
                        if runner.collect_trace:
                            rows.append(runner.trace_row(state).cpu().numpy())
                        k += 1
                        emit("chunk", {"chunk": k, "total": total})
                        if mgr is not None and (k % checkpoint_every == 0
                                                or k == total):
                            _save_snapshot(mgr, runner, state, rows, k,
                                           steps_done, signature, fingerprint,
                                           downgrades)
                            emit("snapshot", {"chunk": k})
                            _fault("checkpoint_saved", chunk=k)
                except KeyboardInterrupt:
                    stop_reason = STOP_INTERRUPTED
                if (stop_reason != STOP_COMPLETED and mgr is not None
                        and k > 0):
                    # A stop between snapshots: keep the frontier, so a
                    # later run continues instead of replaying.
                    _save_snapshot(mgr, runner, state, rows, k, steps_done,
                                   signature, fingerprint, downgrades)
                break
            except Exception as e:   # noqa: BLE001 — allocation triage
                downgrade_or_raise(e, k)
            # Drop the failed tier's runner and state before the rebuild.
            runner = state = None
            _release_device_memory()
            runner = build(k)
    finally:
        if mgr is not None:
            mgr.wait()   # the last write lands, or its error surfaces

    result = runner.finalize(state, rows)
    emit("stop", {"reason": stop_reason, "chunks_done": k,
                  "steps_done": steps_done})
    return ResilientResult(result=result, stop_reason=stop_reason,
                           steps_done=steps_done, chunks_done=k,
                           total_chunks=runner.total_units,
                           resumed_from_chunk=resumed_from,
                           downgrades=tuple(downgrades),
                           wall_seconds=time.monotonic() - t_start)


def _release_device_memory() -> None:
    """Free what the failed attempt held (a traceback's frames can sit in a
    reference cycle until a collection) and return the caching allocator's
    free blocks to the card, so the next tier's build sees that memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
