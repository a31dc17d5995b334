"""Fused dense dual-mode MCMC sweep: the CUDA kernel and its plain version
(port of ``repro.kernels.sweep.mcmc_sweep`` on the dense tier).

A CPU tensor goes to the plain version (``ref.mcmc_sweep``); a CUDA tensor
launches ``csrc/sweep.cu`` or raises. The kernel keeps one replica's u, s
and best_s in one thread block's shared memory, which sets the port's dense
ceiling: see :func:`dense_max_n`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, common, ref
from ._launch import LaunchCounter, check_operands

counter = LaunchCounter("mcmc_sweep")

#: Dynamic shared memory one block may use on Hopper (227 KB, after
#: ``cudaFuncSetAttribute``).
MAX_SHARED_BYTES = 232_448

GATHERS = ("dynamic", "onehot", "auto")


def shared_bytes(n: int, lane: int, segs: int, rwa: bool) -> int:
    """Shared memory of one sweep block: u, s and best_s (3·N f32), the PWL
    intercepts and slopes (2·S), and for RWA the N/lane block sums plus one
    128-wide lane buffer. Mirrors ``snowball_sweep_smem_bytes``."""
    floats = 3 * n + 2 * segs + ((n // lane) + common.MAX_LANE if rwa else 0)
    return 4 * floats


def dense_max_n(rwa: bool = True, segs: int = 64) -> int:
    """Largest N whose sweep state fits one block's shared memory, with the
    default lane. About 19.3k spins (RSA) — the port's dense ceiling in place
    of the TPU's VMEM wall at N=2000."""
    n = (MAX_SHARED_BYTES // 4 - 2 * segs) // 3
    while shared_bytes(n, common.default_lane(n), segs, rwa) > MAX_SHARED_BYTES:
        n -= 1
    return n


@functools.cache
def _fn():
    lib = _build.load("sweep")
    fn = lib.snowball_sweep_dense
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] + [p] * 7 + [i] * 6 + [p]
    fn.restype = ctypes.c_int
    return fn


def mcmc_sweep(couplings: torch.Tensor, fields0: torch.Tensor,
               spins0: torch.Tensor, energy0: torch.Tensor,
               uniforms: torch.Tensor, temps: torch.Tensor,
               pwl_table: Optional[torch.Tensor] = None, *, mode: str = "rsa",
               uniformized: bool = False, gather: str = "dynamic",
               lane: Optional[int] = None):
    """T fused MCMC steps for R replicas on a dense J.

    couplings (N, N); fields0/spins0 (R, N); energy0 (R,); uniforms (T, R, 4)
    in [0,1) (site, accept, roulette, uniformize); temps (T, R);
    ``pwl_table`` optional (S+1, 3) (None = exact sigmoid). ``gather`` takes
    the JAX package's values; on the dense tier they give identical results,
    and all of them run the same row-fetch kernel. Returns ``(fields, spins,
    energy, best_energy, best_spins, num_flips, rows_fetched)``.
    """
    if mode not in ("rsa", "rwa"):
        raise ValueError(f"mode must be 'rsa' or 'rwa', got {mode!r}")
    if gather not in GATHERS:
        raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
    r, n = fields0.shape
    t = uniforms.shape[0]
    lane = common.default_lane(n) if lane is None else lane
    if n % lane or lane > common.MAX_LANE:
        raise ValueError(f"N={n} not divisible by lane={lane} (or lane > "
                         f"{common.MAX_LANE})")
    if fields0.device.type == "cpu":
        return ref.mcmc_sweep(couplings, fields0, spins0, energy0, uniforms,
                              temps, pwl_table, mode=mode,
                              uniformized=uniformized, lane=lane)
    rwa = mode == "rwa"
    dev = fields0.device
    checks = (("couplings", couplings, (n, n)), ("fields0", fields0, (r, n)),
              ("spins0", spins0, (r, n)), ("energy0", energy0, (r,)),
              ("uniforms", uniforms, (t, r, 4)), ("temps", temps, (t, r)))
    if pwl_table is not None:
        checks += (("pwl_table", pwl_table, (pwl_table.shape[0], 3)),)
    check_operands(dev, checks)
    if pwl_table is not None:
        # icpt[S], slopes[S], z_lo, z_hi, inv_step, computed on the card
        # with the plain version's arithmetic (no host round trip).
        c = common.pwl_coefficients(pwl_table)
        segs = c.icpt.shape[0]
        packed = torch.cat([c.icpt, c.slopes,
                            torch.stack([c.z_lo, c.z_hi, c.inv_step])])
        pwl_args = (packed.data_ptr(), segs)
    else:
        segs = 0
        pwl_args = (None, 0)
    need = shared_bytes(n, lane, segs, rwa)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"N={n} needs {need} bytes of shared memory per replica block; "
            f"the dense sweep's ceiling is {MAX_SHARED_BYTES} "
            f"(N ≤ {dense_max_n(rwa, segs)} here). Larger N waits for the "
            "bit-plane tiers (ROADMAP queue 2 items 4-5)")
    u = torch.empty((r, n), dtype=torch.float32, device=dev)
    s = torch.empty((r, n), dtype=torch.float32, device=dev)
    bs = torch.empty((r, n), dtype=torch.float32, device=dev)
    e = torch.empty((r,), dtype=torch.float32, device=dev)
    be = torch.empty((r,), dtype=torch.float32, device=dev)
    nf = torch.empty((r,), dtype=torch.int32, device=dev)
    rf = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(couplings.data_ptr(), fields0.data_ptr(),
                   spins0.data_ptr(), energy0.data_ptr(), uniforms.data_ptr(),
                   temps.data_ptr(), *pwl_args, u.data_ptr(), s.data_ptr(),
                   e.data_ptr(), be.data_ptr(), bs.data_ptr(), nf.data_ptr(),
                   rf.data_ptr(), r, n, t, int(rwa),
                   int(uniformized and rwa), lane, stream)
    if rc != 0:
        raise RuntimeError(f"mcmc_sweep launch failed: CUDA error {rc}")
    counter.count += 1
    return u, s, e, be, bs, nf, rf
