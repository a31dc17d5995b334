"""Shape-bucketed request batching for the serving layer. Port of
``repro.serve.batching``.

* **Spin bucketing.** :func:`bucket_spins` rounds N up to a bucket
  boundary and :func:`pad_problem` embeds the instance into the bucket with
  isolated zero-coupling, zero-field spins. Padded spins add exactly zero
  energy, so every reported energy is exact for the original instance; the
  trajectories are those of the padded instance (the spin selector sees
  N_pad sites). The JAX package pads so that instances share a compiled
  program; a CUDA kernel never recompiles, but the port pads all the same,
  so a served request's result equals the JAX service's.
* **Replica stacking.** Requests on the same problem (same content hash,
  same config but for ``num_replicas``) stack into the replica axis of one
  fused launch, with each request's replica span sliced back out.
  :func:`bucket_replicas` pads the launch's width to a power of two (the
  surplus replicas run and are dropped). Replica streams are keyed by their
  position in the launch, so a stacked result depends on the batch; a
  request that pins a seed takes the "vmap" lane instead.
* **The "vmap" lane.** Seed-pinned requests with identical configs batch
  through ``solve_many``: each lane equals the request solved alone. The
  JAX package vmaps the seeds into one launch; the port's ``solve_many``
  runs one solve per seed.

:func:`plan_batches` is pure planning (grouping, stacking and lane
assignment, no execution); ``serve.service.SolverService`` runs the plans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..core import ising

#: N buckets: fine-grained where small instances live, then powers of two
#: out to the streamed sizes.
SPIN_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 4096, 8192,
                16384)


def bucket_spins(n: int, buckets: Sequence[int] = SPIN_BUCKETS) -> int:
    """The smallest bucket boundary >= n (past the table: the next multiple
    of the last bucket)."""
    if n <= 0:
        raise ValueError(f"num_spins must be positive, got {n}")
    for b in buckets:
        if n <= b:
            return b
    last = buckets[-1]
    return ((n + last - 1) // last) * last


def bucket_replicas(r: int) -> int:
    """Replica-axis bucket: the next power of two (>= 1)."""
    if r <= 0:
        raise ValueError(f"num_replicas must be positive, got {r}")
    return 1 << (r - 1).bit_length()


def pad_problem(problem: ising.IsingProblem,
                n_pad: int) -> ising.IsingProblem:
    """Embed the instance into ``n_pad`` spins with isolated zero-coupling,
    zero-field padding spins, on the problem's own device: energies stay
    exact for the original spins. A dense J is padded as an f32 tensor; an
    edge-list problem grows ``num_spins`` only (the edge set is untouched,
    no dense J is made)."""
    n = problem.num_spins
    if n_pad < n:
        raise ValueError(f"cannot pad N={n} down to {n_pad}")
    if n_pad == n:
        return problem
    dev = problem.device
    fields = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    fields[:n] = problem.fields
    if problem.couplings is None:
        e = problem.edges
        edges = ising.EdgeList.create(e.rows, e.cols, e.weights,
                                      num_spins=n_pad)
        return ising.IsingProblem(couplings=None, fields=fields,
                                  offset=float(problem.offset), edges=edges)
    J = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=dev)
    J[:n, :n] = problem.couplings
    return ising.IsingProblem(couplings=J, fields=fields,
                              offset=float(problem.offset))


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One planned launch. ``kind`` is "stack" (one fused launch, requests
    side by side on the replica axis; ``spans`` holds each request's
    ``(offset, num_replicas)``), "vmap" (``solve_many`` over the requests'
    pinned seeds) or "single" (one request, one launch)."""
    kind: str
    requests: tuple            # the admitted requests, plan order
    config: object             # the launch SolverConfig
    spans: Optional[tuple] = None       # stack: ((offset, r), ...) per request
    launch_replicas: int = 0            # stack: bucketed replica-axis width


def _group_key(req) -> tuple:
    # Stack-compatibility: same problem content, same config but for the
    # replica-axis width (which stacking itself sets). Every other config
    # field splits the group, ``flip_mode`` too: a colored and a single-flip
    # request run different kernels and never share a launch.
    return (req.problem_key,
            dataclasses.replace(req.config, num_replicas=1))


def plan_batches(requests: Sequence, *,
                 max_stack_replicas: int = 256) -> list:
    """Group admitted requests into launch plans. Within one (problem,
    config but for replicas) group, seed-pinned requests with identical
    configs form "vmap" lanes (two or more; a lone one launches single), and
    seed-free requests stack into the replica axis up to
    ``max_stack_replicas`` a launch. Plans keep the request order within a
    group, and groups come in first-seen order."""
    groups: dict = {}
    for req in requests:
        groups.setdefault(_group_key(req), []).append(req)
    plans = []
    for reqs in groups.values():
        pinned = [r for r in reqs if r.seed is not None]
        free = [r for r in reqs if r.seed is None]
        by_cfg: dict = {}
        for r in pinned:
            by_cfg.setdefault(r.config, []).append(r)
        for cfg, lane in by_cfg.items():
            kind = "vmap" if len(lane) >= 2 else "single"
            plans.append(BatchPlan(kind=kind, requests=tuple(lane),
                                   config=cfg))
        while free:
            # Greedy fill up to the cap; a lone oversized request still
            # launches (singly) rather than starving.
            take = [free.pop(0)]
            total = take[0].config.num_replicas
            while free and (total + free[0].config.num_replicas
                            <= max_stack_replicas):
                r = free.pop(0)
                take.append(r)
                total += r.config.num_replicas
            if len(take) == 1:
                plans.append(BatchPlan(kind="single", requests=tuple(take),
                                       config=take[0].config))
                continue
            spans, off = [], 0
            for r in take:
                spans.append((off, r.config.num_replicas))
                off += r.config.num_replicas
            width = bucket_replicas(off)
            cfg = dataclasses.replace(take[0].config, num_replicas=width)
            plans.append(BatchPlan(kind="stack", requests=tuple(take),
                                   config=cfg, spans=tuple(spans),
                                   launch_replicas=width))
    return plans
