"""Int8 gradient all-reduce with error feedback (port of
``repro.distributed.compress``).

Data-parallel gradient exchange dominates the collective term of small
models at a large data-parallel degree. Quantizing the summand to int8
(one absmax scale per tensor, shared by every rank) cuts the all-reduce's
bytes 4× against f32; the quantization residual stays on the rank as
*error feedback* and is added to the next step's gradient before it is
quantized (Seide et al.; EF-SGD).

Each leaf takes three steps, over ``distributed.mesh``'s counted
collectives on the mesh dims ``dims``:

1. one MAX ``all_reduce`` of the local absmax of ``g + ef`` (the scale);
2. the int8 codes, rounded half to even as ``jnp.round`` (``torch.round``),
   summed exactly as int32 by one SUM ``all_reduce``;
3. the residual ``g + ef − code·scale`` kept as the new error feedback,
   rounded once (XLA fuses it into one multiply-add).

With the same per-rank gradients the result is bitwise the JAX function's
under ``shard_map`` on the CPU. Every rank calls it with its own gradients (SPMD);
JAX's ``shmap.axis_size`` is :func:`~.mesh.mesh_size` here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import mesh as M


#: 1/127 rounded to f32.
_INV_127 = torch.tensor(1.0, dtype=torch.float32) / 127.0


class CompressionState(NamedTuple):
    error_feedback: dict  # like the gradients, f32


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _zip(a, b, fn):
    if isinstance(a, dict):
        return {k: _zip(a[k], b[k], fn) for k in a}
    return fn(a, b)


def init_compression(params) -> CompressionState:
    """Zero error feedback in f32, a tensor per leaf of ``params``."""
    return CompressionState(error_feedback=_map(
        params, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)))


def compressed_psum_grads(grads, state: CompressionState, mesh, dims,
                          mean: bool = True):
    """``grads`` (this rank's, a dict tree of tensors) summed over the
    ranks of ``dims`` as int8 codes with one shared scale a leaf, the mean
    when ``mean``. Returns ``(reduced grads (f32), new state)``."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    n = M.mesh_size(mesh, dims)

    def one(g, ef):
        g32 = g.float() + ef
        # One shared scale, so that every rank quantizes alike; then the
        # codes are summed exactly in int32 (the wire carries 1-byte codes
        # and one scalar, 4x less than f32).
        # XLA folds the division by 127 into a multiply by its f32
        # reciprocal.
        scale = M.all_reduce(g32.abs().amax().reshape(1), mesh, dims,
                             "max")[0] * _INV_127.to(g32.device)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(g32 / safe), -127, 127).to(torch.int8)
        total = M.all_reduce(q.to(torch.int32), mesh, dims)
        reduced = total.float() * safe
        if mean:
            reduced = reduced / n
        # The residual as XLA computes it on the CPU, one fused
        # multiply-add rounded once (q·safe is exact in f64, and the
        # difference too, the two being close).
        new_ef = (g32.double() - q.double() * safe.double()).float()
        return reduced, new_ef

    out = _zip(grads, state.error_feedback, one)
    return (_map(out, lambda t: t[0]),
            CompressionState(error_feedback=_map(out, lambda t: t[1])))


def compression_ratio(grads) -> float:
    """Bytes of an f32 all-reduce over those of the int8 codes and one f32
    scale a tensor."""
    leaves = []
    _map(grads, leaves.append)
    fp32 = sum(g.numel() * 4 for g in leaves)
    int8 = sum(g.numel() * 1 + 4 for g in leaves)
    return fp32 / int8
