"""The sweeps on a dense J or packed planes: the CUDA kernels and their plain
versions. Port of ``repro.kernels.sweep``'s ``mcmc_sweep`` (the fused
dual-mode single-flip sweep) and ``colored_sweep`` (graph-colored block
Gibbs), each with ``coupling="dense"|"bitplane"|"bitplane_hbm"``.

A CPU tensor goes to the plain version (``ref.mcmc_sweep``,
``ref.colored_sweep``); a CUDA tensor launches ``csrc/sweep.cu`` or
``csrc/colored_sweep.cu``, or raises. Both kernels keep one replica's u, s
and best_s in one thread block's shared memory, which sets the port's N
ceiling on every tier: see :func:`dense_max_n`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core import coupling as coupling_store
from ..core.bitplane import BitPlanes
from . import _build, common, ref
from ._launch import LaunchCounter, check_operands

counter = LaunchCounter("mcmc_sweep")
colored_counter = LaunchCounter("colored_sweep")

#: Static shared memory the kernel keeps for itself (the step's scalars and
#: the coalesced tier's 64-step site log), with room to spare.
STATIC_SHARED_BYTES = 1024

#: Dynamic shared memory one block may use on Hopper: the 227 KB a block
#: may hold (after ``cudaFuncSetAttribute``) less the static part.
MAX_SHARED_BYTES = coupling_store.SHARED_MEMORY_BYTES - STATIC_SHARED_BYTES

#: Largest thread-block cluster the coalesced tier forms (the portable size).
MAX_CLUSTER = 8

GATHERS = ("dynamic", "onehot", "auto")


def shared_bytes(n: int, lane: int, segs: int, rwa: bool) -> int:
    """Shared memory of one sweep block: u, s and best_s (3·N f32), the PWL
    intercepts and slopes (2·S), and for RWA the N/lane block sums plus one
    128-wide lane buffer. Mirrors ``snowball_sweep_smem_bytes``."""
    floats = 3 * n + 2 * segs + ((n // lane) + common.MAX_LANE if rwa else 0)
    return 4 * floats


def dense_max_n(rwa: bool = True, segs: int = 64) -> int:
    """Largest N whose sweep state fits one block's shared memory, with the
    default lane. About 19.3k spins (RSA) — the port's ceiling on every
    tier, in place of the TPU's VMEM wall at N=2000."""
    n = (MAX_SHARED_BYTES // 4 - 2 * segs) // 3
    while shared_bytes(n, common.default_lane(n), segs, rwa) > MAX_SHARED_BYTES:
        n -= 1
    return n


def colored_shared_bytes(n: int, window: int, segs: int) -> int:
    """Shared memory of one colored block: u, s and best_s (3·N f32), the
    PWL intercepts and slopes (2·S f32), the accept mask (⌈window/32⌉
    words) and the accepted-slot list (window × 2 bytes). Mirrors
    ``snowball_colored_smem_bytes``."""
    return 4 * (3 * n + 2 * segs) + 4 * (-(-window // 32)) + 2 * window


@functools.cache
def _fns():
    lib = _build.load("sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    dense = lib.snowball_sweep_dense
    dense.argtypes = [p] * 7 + [i] + [p] * 7 + [i] * 6 + [p]
    dense.restype = ctypes.c_int
    planes = lib.snowball_sweep_planes
    planes.argtypes = [p, p, i, i] + [p] * 6 + [i] + [p] * 7 + [i] * 7 + [p]
    planes.restype = ctypes.c_int
    return dense, planes


def mcmc_sweep(couplings, fields0: torch.Tensor,
               spins0: torch.Tensor, energy0: torch.Tensor,
               uniforms: torch.Tensor, temps: torch.Tensor,
               pwl_table: Optional[torch.Tensor] = None, *, mode: str = "rsa",
               uniformized: bool = False, gather: str = "dynamic",
               coupling: str = "dense", block_r: int = 8,
               lane: Optional[int] = None, coalesce: bool = True):
    """T fused MCMC steps for R replicas.

    couplings: (N, N) f32 with ``coupling="dense"``, or a ``BitPlanes`` of
    an integer J with ``coupling="bitplane"|"bitplane_hbm"``. fields0/spins0
    (R, N); energy0 (R,); uniforms (T, R, 4) in [0,1) (site, accept,
    roulette, uniformize); temps (T, R); ``pwl_table`` optional (S+1, 3)
    (None = exact sigmoid). ``gather`` takes the JAX package's values: on the
    dense tier they give identical results and run the same row-fetch
    kernel; the plane tiers reject "onehot". ``coalesce`` (the streamed tier
    only) counts ``rows_fetched`` as each step's unique rows per group of
    ``fit_block(R, block_r)`` replicas, charged to the lowest replica
    selecting each; the trajectory does not depend on it. Returns
    ``(fields, spins, energy, best_energy, best_spins, num_flips,
    rows_fetched)``.
    """
    if mode not in ("rsa", "rwa"):
        raise ValueError(f"mode must be 'rsa' or 'rwa', got {mode!r}")
    if gather not in GATHERS:
        raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
    r, n = fields0.shape
    t = uniforms.shape[0]
    coupling_store.validate_kernel_operand(coupling, couplings, n, gather)
    lane = common.default_lane(n) if lane is None else lane
    if n % lane or lane > common.MAX_LANE:
        raise ValueError(f"N={n} not divisible by lane={lane} (or lane > "
                         f"{common.MAX_LANE})")
    coalesce = coalesce and coupling_store.FORMATS[coupling].coalescable
    if fields0.device.type == "cpu":
        return ref.mcmc_sweep(couplings, fields0, spins0, energy0, uniforms,
                              temps, pwl_table, mode=mode,
                              uniformized=uniformized, lane=lane,
                              coupling=coupling, block_r=block_r,
                              coalesce=coalesce)
    rwa = mode == "rwa"
    dev = fields0.device
    checks = (("fields0", fields0, (r, n)),
              ("spins0", spins0, (r, n)), ("energy0", energy0, (r,)),
              ("uniforms", uniforms, (t, r, 4)), ("temps", temps, (t, r)))
    if pwl_table is not None:
        checks += (("pwl_table", pwl_table, (pwl_table.shape[0], 3)),)
    check_operands(dev, checks)
    if isinstance(couplings, BitPlanes):
        shape = (couplings.num_planes, n, couplings.num_words)
        check_operands(dev, (("planes.pos", couplings.pos, shape),
                             ("planes.neg", couplings.neg, shape)),
                       dtype=torch.int32)
    else:
        check_operands(dev, (("couplings", couplings, (n, n)),))
    cluster = common.fit_block(r, block_r) if coalesce else 0
    if cluster > MAX_CLUSTER:
        raise ValueError(
            f"coalesced rows_fetched groups block_r={block_r} replicas in one "
            f"thread-block cluster; the card's portable limit is "
            f"{MAX_CLUSTER} (pass block_r <= {MAX_CLUSTER})")
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
            f"the sweep's ceiling is {MAX_SHARED_BYTES} "
            f"(N ≤ {dense_max_n(rwa, segs)} here). Lifting that ceiling is "
            "ROADMAP queue 2 item 8")
    u = torch.empty((r, n), dtype=torch.float32, device=dev)
    s = torch.empty((r, n), dtype=torch.float32, device=dev)
    bs = torch.empty((r, n), dtype=torch.float32, device=dev)
    e = torch.empty((r,), dtype=torch.float32, device=dev)
    be = torch.empty((r,), dtype=torch.float32, device=dev)
    nf = torch.empty((r,), dtype=torch.int32, device=dev)
    rf = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        state = (fields0.data_ptr(), spins0.data_ptr(), energy0.data_ptr(),
                 uniforms.data_ptr(), temps.data_ptr(), *pwl_args,
                 u.data_ptr(), s.data_ptr(), e.data_ptr(), be.data_ptr(),
                 bs.data_ptr(), nf.data_ptr(), rf.data_ptr(), r, n, t,
                 int(rwa), int(uniformized and rwa), lane)
        dense_fn, planes_fn = _fns()
        if isinstance(couplings, BitPlanes):
            rc = planes_fn(couplings.pos.data_ptr(), couplings.neg.data_ptr(),
                           couplings.num_planes, couplings.num_words, *state,
                           cluster, stream)
        else:
            rc = dense_fn(couplings.data_ptr(), *state, stream)
    if rc != 0:
        raise RuntimeError(f"mcmc_sweep launch failed: CUDA error {rc}")
    counter.count += 1
    return u, s, e, be, bs, nf, rf


@functools.cache
def _colored_fn():
    lib = _build.load("colored_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.snowball_colored_sweep
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 7 + [i] + [p] * 8 + [i] * 5
                   + [p])
    fn.restype = ctypes.c_int
    return fn


def colored_sweep(couplings, fields0: torch.Tensor, spins0: torch.Tensor,
                  energy0: torch.Tensor, uniforms: torch.Tensor,
                  temps: torch.Tensor, sched: torch.Tensor,
                  pwl_table: Optional[torch.Tensor] = None, *,
                  coupling: str = "dense", block_r: int = 8):
    """T graph-colored block-update steps for R replicas.

    The colored counterpart of :func:`mcmc_sweep`, with the same store
    contract and 7 outputs; each step updates the whole scheduled color
    class instead of selecting one spin, so the kernel takes no selection
    mode. Spins are in color-sorted order (``kernels.ops.colored_anneal``
    owns the permutation). ``uniforms`` (T, R, S) with S the static class
    window; ``sched`` (T, 3) int32 rows of ``(window_start, class_offset,
    class_size)``, the window start clamped into [0, N − S]. ``rows_fetched``
    counts each slot that any replica of a ``fit_block(R, block_r)`` group
    accepted once, charged to the group's lowest-index accepting replica —
    on every tier. On the card a group is one thread-block cluster, so
    ``block_r`` is at most 8.
    """
    r, n = fields0.shape
    if uniforms.dim() != 3:
        raise ValueError(f"uniforms must be (T, R, S), got shape "
                         f"{tuple(uniforms.shape)}")
    t, _, win = uniforms.shape
    coupling_store.validate_kernel_operand(coupling, couplings, n)
    for name, x, shape in (("spins0", spins0, (r, n)),
                           ("energy0", energy0, (r,)),
                           ("uniforms", uniforms, (t, r, win)),
                           ("temps", temps, (t, r)), ("sched", sched, (t, 3))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
    if not 1 <= win <= n:
        raise ValueError(f"class window S={win} must lie in [1, N={n}]")
    if fields0.device.type == "cpu":
        return ref.colored_sweep(couplings, fields0, spins0, energy0,
                                 uniforms, temps, sched, pwl_table,
                                 block_r=block_r)
    dev = fields0.device
    checks = (("fields0", fields0, (r, n)), ("spins0", spins0, (r, n)),
              ("energy0", energy0, (r,)), ("uniforms", uniforms, (t, r, win)),
              ("temps", temps, (t, r)))
    if pwl_table is not None:
        checks += (("pwl_table", pwl_table, (pwl_table.shape[0], 3)),)
    check_operands(dev, checks)
    check_operands(dev, (("sched", sched, (t, 3)),), dtype=torch.int32)
    if isinstance(couplings, BitPlanes):
        shape = (couplings.num_planes, n, couplings.num_words)
        check_operands(dev, (("planes.pos", couplings.pos, shape),
                             ("planes.neg", couplings.neg, shape)),
                       dtype=torch.int32)
        store = (None, couplings.pos.data_ptr(), couplings.neg.data_ptr(),
                 couplings.num_planes, couplings.num_words)
    else:
        check_operands(dev, (("couplings", couplings, (n, n)),))
        store = (couplings.data_ptr(), None, None, 0, 0)
    cluster = common.fit_block(r, block_r)
    if cluster > MAX_CLUSTER:
        raise ValueError(
            f"colored rows_fetched groups block_r={block_r} replicas in one "
            f"thread-block cluster; the card's portable limit is "
            f"{MAX_CLUSTER} (pass block_r <= {MAX_CLUSTER})")
    if pwl_table is not None:
        c = common.pwl_coefficients(pwl_table)
        segs = c.icpt.shape[0]
        packed = torch.cat([c.icpt, c.slopes,
                            torch.stack([c.z_lo, c.z_hi, c.inv_step])])
        pwl_args = (packed.data_ptr(), segs)
    else:
        segs = 0
        pwl_args = (None, 0)
    need = colored_shared_bytes(n, win, segs)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"N={n} with a class window of S={win} needs {need} bytes of "
            f"shared memory per replica block; the colored sweep's ceiling "
            f"is {MAX_SHARED_BYTES}. Lifting that ceiling is ROADMAP queue 2 "
            "item 8")
    u = torch.empty((r, n), dtype=torch.float32, device=dev)
    s = torch.empty((r, n), dtype=torch.float32, device=dev)
    bs = torch.empty((r, n), dtype=torch.float32, device=dev)
    e = torch.empty((r,), dtype=torch.float32, device=dev)
    be = torch.empty((r,), dtype=torch.float32, device=dev)
    nf = torch.empty((r,), dtype=torch.int32, device=dev)
    rf = torch.empty((r,), dtype=torch.int32, device=dev)
    masks = torch.empty((max(t, 1), r, -(-win // 32)), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _colored_fn()(
            *store, fields0.data_ptr(), spins0.data_ptr(), energy0.data_ptr(),
            uniforms.data_ptr(), temps.data_ptr(), sched.data_ptr(),
            *pwl_args, u.data_ptr(), s.data_ptr(), e.data_ptr(),
            be.data_ptr(), bs.data_ptr(), nf.data_ptr(), rf.data_ptr(),
            masks.data_ptr(), r, n, t, win, cluster, stream)
    if rc != 0:
        raise RuntimeError(f"colored_sweep launch failed: CUDA error {rc}")
    colored_counter.count += 1
    return u, s, e, be, bs, nf, rf
