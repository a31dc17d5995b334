"""Flash-attention forward, GQA-native and causal-aware: the CUDA kernels
and their plain version (port of ``repro.kernels.flash_attention``).

A CPU tensor goes to the plain version (``ref.flash_attention``). A CUDA
tensor launches ``csrc/flash_attention.cu`` or raises: bfloat16 inputs its
tensor-core entry (``flash_attention_forward_bf16``, counted by
``tc_counter``), float32 inputs its CUDA-core entry
(``flash_attention_forward_f32``, counted by ``f32_counter``).

:func:`flash_attention` is differentiable: an autograd Function whose
backward recomputes the attention through ``layers.chunked_attention``
from the saved q, k and v and differentiates that, as the JAX package's
``_flash_bwd`` does, so its gradients are bitwise those of autograd
through the chunked path. Under activation checkpointing the forward runs
again in the recompute, so a training step launches the kernel twice a
layer and microbatch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..device import meta_allowed
from ..roofline import op_cost
from . import _build, ref
from ._launch import LaunchCounter

tc_counter = LaunchCounter("flash_attention_bf16")
f32_counter = LaunchCounter("flash_attention_f32")

#: The kernel entry and its launch count for each input dtype (q, k and v
#: alike).
ENTRIES = {torch.bfloat16: ("flash_attention_forward_bf16", tc_counter),
           torch.float32: ("flash_attention_forward_f32", f32_counter)}

#: Head dims the kernels take: multiples of 16 up to 256.
MAX_HEAD_DIM = 256


@functools.cache
def _fn(entry: str):
    fn = getattr(_build.load("flash_attention"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), Hq % Hkv == 0. Returns
    (B, Hq, Sq, D) in q's dtype.

    ``block_q`` and ``block_k`` are the JAX kernel's tiles; they are checked
    as there (each sequence a multiple of its tile, clipped to the
    sequence) and otherwise unused: the CUDA kernel tiles by itself and
    masks ragged edges. On the card q, k and v must be contiguous, all
    float32 or all bfloat16, each starting on a 16-byte boundary, with D a
    multiple of 16 up to 256.
    """
    _check_shapes(q, k, v)
    sq, skv = q.shape[2], k.shape[2]
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"seq ({sq},{skv}) not divisible by ({block_q},{block_k})")
    if q.device.type not in ("cpu", "cuda") and not (q.is_meta
                                                     and meta_allowed()):
        raise ValueError(f"flash_attention takes CPU or CUDA tensors (meta "
                         f"ones in a dry run), got {q.device}")
    with op_cost.kernel("flash_attention", flops(q, k, causal),
                        sum(op_cost.tensor_bytes(t) for t in (q, k, v, q))):
        return _Flash.apply(q, k, v, bool(causal), float(scale), block_q,
                            block_k)


def flops(q: torch.Tensor, k: torch.Tensor, causal: bool) -> float:
    """The kernel's work: 4·B·Hq·D·S(S+1)/2 causal (the QKᵀ and PV
    products over the lower triangle), 4·B·Hq·D·Sq·Skv otherwise."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    pairs = sq * (sq + 1) / 2 if causal and sq == skv else sq * skv
    return 4.0 * b * hq * d * pairs


def _forward(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card; on the meta
    device (a dry run, ``device.meta_device``) the output's shape."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    d = q.shape[3]
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 up "
                         f"to {MAX_HEAD_DIM}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return _launch(q, k, v, causal, scale, stream)


class _Flash(torch.autograd.Function):
    """Forward: :func:`_forward`. Backward: autograd through
    ``chunked_attention(q, k, v, causal, q_chunk=block_q,
    kv_chunk=block_k, scale)`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, block_q, block_k)
        return _forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        # Imported here: the models package calls into this module.
        from ..models.layers import chunked_attention

        causal, scale, block_q, block_k = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = chunked_attention(*inputs, causal=causal, q_chunk=block_q,
                                    kv_chunk=block_k, scale=scale)
        dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None, None, None, None


def _launch(q, k, v, causal: bool, scale: float, stream: int) -> torch.Tensor:
    """Launch the entry for q's dtype on ``stream`` and count it."""
    entry, counter = ENTRIES[q.dtype]
    b, hq, sq, d = q.shape
    out = torch.empty_like(q)
    rc = _fn(entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, hq, k.shape[1], sq, k.shape[2], d, float(scale),
                    int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    counter.count += 1
    return out
