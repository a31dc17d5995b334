"""Local-field init from packed signed bit-planes: the CUDA kernel and its
plain version (port of ``repro.kernels.bitplane_field``).

A CPU tensor goes to the plain version (``ref.bitplane_field_init``); a CUDA
tensor launches ``csrc/bitplane_field.cu`` or raises. The kernel takes any
number of words W, planes B (up to 30) and replicas R: it uses no shared
memory, reads the planes once for every 32 replicas, and loads 16 bytes at a
time where W is a multiple of 4 and every operand is 16-byte aligned, 4
bytes otherwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from ._launch import LaunchCounter, check_operands

counter = LaunchCounter("bitplane_field_init")


@functools.cache
def _fn():
    fn = _build.load("bitplane_field").snowball_bitplane_field_init
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bitplane_field_init(pos: torch.Tensor, neg: torch.Tensor,
                        spin_words: torch.Tensor) -> torch.Tensor:
    """u^(J)[r, i] from packed planes (Eq. 14-16). pos/neg (B, N, W) and
    spin_words (R, W) int32-held uint32 words; returns (R, N) f32."""
    if spin_words.device.type == "cpu":
        return ref.bitplane_field_init(pos, neg, spin_words)
    num_planes, n, w = pos.shape
    r = spin_words.shape[0]
    dev = spin_words.device
    check_operands(dev, (("pos", pos, (num_planes, n, w)),
                         ("neg", neg, (num_planes, n, w)),
                         ("spin_words", spin_words, (r, w))),
                   dtype=torch.int32)
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(pos.data_ptr(), neg.data_ptr(), spin_words.data_ptr(),
                   out.data_ptr(), num_planes, n, w, r, stream)
    if rc != 0:
        raise RuntimeError(f"bitplane_field_init launch failed: CUDA error {rc}")
    counter.count += 1
    return out
