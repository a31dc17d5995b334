"""Flash attention, GQA-native and causal-aware, forward and backward: the
CUDA kernels and their plain versions (port of
``repro.kernels.flash_attention``).

A CPU tensor goes to the plain versions (``ref.flash_attention``,
``ref.flash_attention_bwd``). A CUDA tensor launches the kernels or
raises. Both directions route by dtype and head dim (:func:`fwd_route`,
:func:`bwd_route`): bfloat16 at D = 64 and 128 (``WGMMA_HEAD_DIMS``) to the
Hopper sources on wgmma and TMA, the forward
``csrc/flash_attention_wgmma.cu`` (``flash_attention_forward_bf16_wgmma``,
counted by ``fwd_wgmma_counter``) and the backward
``csrc/flash_attention_bwd_wgmma.cu``
(``flash_attention_backward_bf16_wgmma``, ``bwd_wgmma_counter``);
bfloat16 at every other D to the mma.sync entries,
``csrc/flash_attention.cu``'s ``flash_attention_forward_bf16``
(``tc_counter``) and ``csrc/flash_attention_bwd.cu``'s
``flash_attention_backward_bf16`` (``bwd_tc_counter``); float32 to their
CUDA-core entries ``flash_attention_forward_f32`` (``f32_counter``) and
``flash_attention_backward_f32`` (``bwd_f32_counter``). One count a call
of the entry (the backward's launches its three passes); a refused launch
raises with the entry's name and counts nothing.

:func:`flash_attention` is differentiable: an autograd Function whose
forward also saves the rows' log-sum-exp and whose backward is the
backward kernel (FlashAttention-2's, deterministic). The JAX package's
``_flash_bwd`` differentiates its chunked path instead; the two compute
the same gradients. Under activation checkpointing the forward runs again
in the recompute, so a training step launches the forward twice a layer
and microbatch and the backward once.
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
fwd_wgmma_counter = LaunchCounter("flash_attention_bf16_wgmma")
bwd_tc_counter = LaunchCounter("flash_attention_bwd_bf16")
bwd_f32_counter = LaunchCounter("flash_attention_bwd_f32")
bwd_wgmma_counter = LaunchCounter("flash_attention_bwd_bf16_wgmma")

#: The kernel entry and its launch count for each input dtype (q, k and v
#: alike), outside ``WGMMA_HEAD_DIMS``.
ENTRIES = {torch.bfloat16: ("flash_attention_forward_bf16", tc_counter),
           torch.float32: ("flash_attention_forward_f32", f32_counter)}
#: The same for the backward.
BWD_ENTRIES = {
    torch.bfloat16: ("flash_attention_backward_bf16", bwd_tc_counter),
    torch.float32: ("flash_attention_backward_f32", bwd_f32_counter)}
#: The Hopper forward and backward (wgmma, a TMA-fed ring, warp
#: specialisation) and the bfloat16 head dims they take; every other
#: (dtype, D) keeps ENTRIES and BWD_ENTRIES.
WGMMA_FWD = ("flash_attention_forward_bf16_wgmma", fwd_wgmma_counter)
WGMMA_BWD = ("flash_attention_backward_bf16_wgmma", bwd_wgmma_counter)
WGMMA_HEAD_DIMS = (64, 128)
#: Every forward entry's counter.
FWD_COUNTERS = (fwd_wgmma_counter, tc_counter, f32_counter)
#: The source (``_build.SOURCES`` key) of each forward entry.
LIBRARIES = {"flash_attention_forward_bf16": "flash_attention",
             "flash_attention_forward_f32": "flash_attention",
             WGMMA_FWD[0]: "flash_attention_wgmma"}
#: The source (``_build.SOURCES`` key) of each backward entry.
BWD_LIBRARIES = {"flash_attention_backward_bf16": "flash_attention_bwd",
                 "flash_attention_backward_f32": "flash_attention_bwd",
                 WGMMA_BWD[0]: "flash_attention_bwd_wgmma"}

#: Head dims the kernels take: multiples of 16 up to 256.
MAX_HEAD_DIM = 256


@functools.cache
def _fn(entry: str):
    """A forward entry: q, k, v, out, lse (or None) and the shape."""
    fn = getattr(_build.load(LIBRARIES[entry]), entry)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn(entry: str):
    """A backward entry: q, k, v, out, lse, dout, dq, dk, dv, the Δ
    scratch and the shape."""
    fn = getattr(_build.load(BWD_LIBRARIES[entry]), entry)
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
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
        return _Flash.apply(q, k, v, bool(causal), float(scale))


def flops(q: torch.Tensor, k: torch.Tensor, causal: bool) -> float:
    """The kernel's work: 4·B·Hq·D·S(S+1)/2 causal (the QKᵀ and PV
    products over the lower triangle), 4·B·Hq·D·Sq·Skv otherwise."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    pairs = sq * (sq + 1) / 2 if causal and sq == skv else sq * skv
    return 4.0 * b * hq * d * pairs


def bwd_cost(q: torch.Tensor, k: torch.Tensor, causal: bool) -> tuple:
    """The backward's (flops, bytes): the five products over the kept pairs
    (2.5 × :func:`flops`); q, k, v, out, dout, dq, dk and dv in the inputs'
    dtype, and lse and Δ in f32."""
    rows = q.numel() // q.shape[3]
    nbytes = (4 * op_cost.tensor_bytes(q) + 4 * op_cost.tensor_bytes(k)
              + 2 * 4 * rows)
    return 2.5 * flops(q, k, causal), nbytes


def _forward(q, k, v, causal: bool, scale: float, with_lse: bool = False):
    """The plain version on the CPU, the kernel on the card; on the meta
    device (a dry run, ``device.meta_device``) the output's shape. Returns
    out, or (out, lse) ``with_lse``."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, scale, with_lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        return (out, torch.empty(q.shape[:3], dtype=torch.float32,
                                 device=q.device)) if with_lse else out
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
        return _launch(q, k, v, causal, scale, stream, with_lse)


def _backward(q, k, v, out, lse, dout, causal: bool, scale: float):
    """(dq, dk, dv): the plain backward on the CPU, the kernel on the card;
    on the meta device empty gradients of the inputs' shapes."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dout.dtype != q.dtype:
        raise ValueError(f"the output gradient is {dout.dtype}, q {q.dtype}")
    dout = dout.contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return _launch_bwd(q, k, v, out, lse, dout, causal, scale, stream)


class _Flash(torch.autograd.Function):
    """Forward: :func:`_forward`, which also returns the rows' log-sum-exp
    when a gradient is wanted; it saves q, k, v, out and lse. Backward:
    :func:`_backward` from them, counted by the cost counter at its entry
    (:func:`bwd_cost`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.args = (causal, scale)
        if not any(ctx.needs_input_grad[:3]):
            return _forward(q, k, v, causal, scale)
        out, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale = ctx.args
        with op_cost.kernel("flash_attention_bwd", *bwd_cost(q, k, causal)):
            dq, dk, dv = _backward(q, k, v, out, lse, grad, causal, scale)
        return dq, dk, dv, None, None


def fwd_route(dtype: torch.dtype, d: int, mma_sync: bool = False) -> tuple:
    """The forward entry and its counter for q's dtype and head dim D:
    bfloat16 at D in ``WGMMA_HEAD_DIMS`` the wgmma entry, everything else
    ``ENTRIES[dtype]``. ``mma_sync`` sends bfloat16 at those D to the
    mma.sync entry instead (for timing the two side by side only)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and not mma_sync:
        return WGMMA_FWD
    return ENTRIES[dtype]


def _launch(q, k, v, causal: bool, scale: float, stream: int,
            with_lse: bool = False, *, mma_sync: bool = False):
    """Launch the entry of :func:`fwd_route` on ``stream`` and count it
    once; with ``with_lse`` it also writes the rows' log-sum-exp. A refused
    launch raises."""
    entry, counter = fwd_route(q.dtype, q.shape[3], mma_sync)
    b, hq, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = _fn(entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, hq,
                    k.shape[1], sq, k.shape[2], d, float(scale),
                    int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    counter.count += 1
    return (out, lse) if with_lse else out


def bwd_route(dtype: torch.dtype, d: int, mma_sync: bool = False) -> tuple:
    """The backward entry and its counter for q's dtype and head dim D:
    bfloat16 at D in ``WGMMA_HEAD_DIMS`` the wgmma entry, everything else
    ``BWD_ENTRIES[dtype]``. ``mma_sync`` sends bfloat16 at those D to the
    mma.sync entry instead (for timing the two side by side only)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and not mma_sync:
        return WGMMA_BWD
    return BWD_ENTRIES[dtype]


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, scale: float,
                stream: int, *, mma_sync: bool = False):
    """Launch the backward entry of :func:`bwd_route` on ``stream`` (its
    three passes) and count it once; a refused launch raises."""
    entry, counter = bwd_route(q.dtype, q.shape[3], mma_sync)
    b, hq, sq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = _bwd_fn(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b, hq, k.shape[1], sq, k.shape[2], d,
        float(scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    counter.count += 1
    return dq, dk, dv
