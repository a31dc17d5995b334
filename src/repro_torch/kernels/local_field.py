"""Batched local-field init ``u = s Jᵀ + h``: the CUDA kernel and its plain
version (port of ``repro.kernels.local_field``).

A CPU tensor goes to the plain version (``ref.local_field_init``); a CUDA
tensor launches ``csrc/local_field.cu`` or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref
from ._launch import LaunchCounter, check_operands

counter = LaunchCounter("local_field_init")


@functools.cache
def _fn():
    fn = _build.load("local_field").snowball_local_field_init
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def local_field_init(spins: torch.Tensor, couplings: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """u[r] = J s[r] + h. spins (R, N), couplings (N, N), bias (N,); (R, N)
    f32. On the card all three must be contiguous f32 on one device."""
    if spins.device.type == "cpu":
        return ref.local_field_init(spins, couplings, bias)
    r, n = spins.shape
    check_operands(spins.device, (("spins", spins, (r, n)),
                                  ("couplings", couplings, (n, n)),
                                  ("bias", bias, (n,))))
    out = torch.empty((r, n), dtype=torch.float32, device=spins.device)
    with torch.cuda.device(spins.device):
        stream = torch.cuda.current_stream(spins.device).cuda_stream
        rc = _fn()(spins.data_ptr(), couplings.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), r, n, stream)
    if rc != 0:
        raise RuntimeError(f"local_field_init launch failed: CUDA error {rc}")
    counter.count += 1
    return out


def order_error_bound(spins: torch.Tensor, couplings: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """(R, N) float64 bound on |u − u_exact| for the kernel's summation
    order. Each product J_ik·s_rk is rounded once, then passes through at
    most ⌈N/32⌉ + 4 adds in its lane, 5 shuffle adds and the add of h:
    n = ⌈N/32⌉ + 11 roundings, so |u − u_exact| ≤ γ_n·(Σ_k |J_ik s_rk| +
    |h_i|) with γ_n = n·2⁻²⁴ / (1 − n·2⁻²⁴) (recursive summation's bound).
    For integer J and h with sums below 2²⁴ every sum is exact instead."""
    n = math.ceil(couplings.shape[0] / 32) + 11
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    mag = (torch.abs(spins.double()) @ torch.abs(couplings.double()).T
           + torch.abs(bias.double()))
    return gamma * mag
