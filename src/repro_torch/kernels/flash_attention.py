"""Flash-attention forward, GQA-native and causal-aware: the CUDA kernel and
its plain version (port of ``repro.kernels.flash_attention``).

A CPU tensor goes to the plain version (``ref.flash_attention``); a CUDA
tensor launches ``csrc/flash_attention.cu`` or raises. The backward (the JAX
package recomputes it through ``chunked_attention``) waits for the training
slice.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from ._launch import LaunchCounter

counter = LaunchCounter("flash_attention")

#: Input dtypes the kernel takes (q, k and v alike).
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Head dims the kernel takes: multiples of 16 up to 256.
MAX_HEAD_DIM = 256


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
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
    float32 or all bfloat16, with D a multiple of 16 up to 256.
    """
    _check_shapes(q, k, v)
    sq, skv = q.shape[2], k.shape[2]
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"seq ({sq},{skv}) not divisible by ({block_q},{block_k})")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 up "
                         f"to {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, hq, hkv, sq, skv, d, float(scale), int(bool(causal)),
                   DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    counter.count += 1
    return out
