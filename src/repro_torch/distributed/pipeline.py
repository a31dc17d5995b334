"""GPipe-style pipeline parallelism over a mesh dim (port of
``repro.distributed.pipeline``).

:func:`pipeline_apply` runs a stage function over P pipeline stages, one a
rank along the mesh dim ``dim``, with M microbatches on the classic GPipe
schedule: M + P − 1 ticks, the activations hopping stage to stage between
ticks. SPMD: every rank of the dim calls it with its own stage's
parameters. The hop is one exact exchange a tick over
``distributed.mesh``'s counted ``all_reduce`` (each rank writes its output
into the next stage's slot of a zero buffer, and the buffers are summed as
integers; gloo has no ``all_gather`` or point-to-point on CUDA tensors),
and at the end the last stage's outputs are broadcast to every rank. The
bubble fraction is (P − 1)/(M + P − 1) (:func:`bubble_fraction`).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import mesh as M

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float64: torch.int64}


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _exchange(y: torch.Tensor, stage: int, p: int, mesh, dim: str):
    """Every stage's ``y`` moved to the next stage (stage i to i + 1, the
    last to the first): this rank's inbox, bit for bit."""
    slots = y.new_zeros((p,) + tuple(y.shape))
    slots[(stage + 1) % p] = y
    bits = _BITS.get(slots.dtype)
    if bits is None:
        return M.all_reduce(slots, mesh, (dim,))[stage]
    # 16-bit words travel widened to int32 (exact: one rank's word and
    # zeros), since gloo sums no int16.
    words = slots.view(bits)
    wide = M.all_reduce(words.to(torch.int32) if bits == torch.int16
                        else words, mesh, (dim,))
    return wide[stage].to(bits).view(slots.dtype)


def pipeline_apply(stage_fn: Callable, stage_params,
                   x_microbatches: torch.Tensor, mesh, dim: str):
    """``stage_fn(params, x) -> y`` of x's shape (residual-stream stages),
    this rank's stage along ``dim`` holding ``stage_params``.
    ``x_microbatches`` (M, mb, ...) is read on stage 0 (a replicated tensor
    does). Returns (M, mb, ...), the last stage's outputs, on every rank."""
    p = M.dim_size(mesh, dim)
    stage = mesh.get_local_rank(dim)
    m = x_microbatches.shape[0]
    inbox = torch.zeros_like(x_microbatches[0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(m + p - 1):
        x_in = x_microbatches[min(t, m - 1)] if stage == 0 else inbox
        u = t - stage                # this stage's microbatch at tick t
        y = stage_fn(stage_params, x_in) if 0 <= u < m else x_in
        if stage == p - 1 and 0 <= u < m:
            outputs[u] = y
        if p > 1:
            inbox = _exchange(y, stage, p, mesh, dim)
    if p > 1:
        M.broadcast(outputs, mesh, dim, src=p - 1)
    return outputs
