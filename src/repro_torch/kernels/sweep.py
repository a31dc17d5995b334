"""The sweeps on a dense J or packed planes: the CUDA kernels and their plain
versions. Port of ``repro.kernels.sweep``'s ``mcmc_sweep`` (the fused
dual-mode single-flip sweep) and ``colored_sweep`` (graph-colored block
Gibbs), each with ``coupling="dense"|"bitplane"|"bitplane_hbm"``.

A CPU tensor goes to the plain version (``ref.mcmc_sweep``,
``ref.colored_sweep``); a CUDA tensor launches the source :func:`route`
names, ``csrc/sweep_rsa.cu`` (RSA, counted by ``rsa_hopper_counter``) or
``csrc/sweep_rwa.cu`` (RWA, counted by ``rwa_hopper_counter``), or
``csrc/sweep.cu`` (the earlier kernel, for either mode only when forced, to
time it), or ``csrc/colored_sweep_hopper.cu`` (kernel D, counted by
``colored_hopper_counter``; ``csrc/colored_sweep.cu``, the earlier colored
kernel, only when forced), or raises. ``mcmc_sweep`` and
``colored_sweep`` take their uniforms as a tensor, as the JAX kernels do;
``mcmc_sweep_keyed`` and ``colored_sweep_keyed``, the solves' entries, take
the base key's two words and the chunk index and let the kernel draw the
same uniforms itself. The single-flip kernels run each replica on a
thread-block cluster of :func:`cluster_width` blocks that split N
(:func:`max_n` is its ceiling); the colored kernel runs each replica on a
cluster of :func:`colored_width` blocks that split N (:func:`colored_max_n`
is its ceiling).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Sequence

import torch

from ..core import coupling as coupling_store
from ..core import rng
from ..core.bitplane import BitPlanes
from . import _build, common, ref
from ._launch import LaunchCounter, check_operands

#: Every launch of kernel A, on either source.
counter = LaunchCounter("mcmc_sweep")
#: Kernel A's launches on ``csrc/sweep_rwa.cu``, the RWA route.
rwa_hopper_counter = LaunchCounter("mcmc_sweep_rwa_hopper")
#: Kernel A's launches on ``csrc/sweep_rsa.cu``, the RSA route.
rsa_hopper_counter = LaunchCounter("mcmc_sweep_rsa_hopper")
#: Every launch of kernel D, on either source.
colored_counter = LaunchCounter("colored_sweep")
#: Kernel D's launches on ``csrc/colored_sweep_hopper.cu``, its route.
colored_hopper_counter = LaunchCounter("colored_sweep_hopper")
uniforms_counter = LaunchCounter("sweep_uniforms")

#: Static shared memory the kernels keep for themselves (the step's
#: mailboxes and scalars), with room to spare.
STATIC_SHARED_BYTES = 1024

#: Dynamic shared memory one block may use on Hopper: the 227 KB a block
#: may hold (after ``cudaFuncSetAttribute``) less the static part.
MAX_SHARED_BYTES = coupling_store.SHARED_MEMORY_BYTES - STATIC_SHARED_BYTES

#: Largest thread-block cluster of ``csrc/sweep.cu`` (the earlier route, for
#: either mode when forced), the portable size: its widest split of a
#: replica's spins.
MAX_CLUSTER = coupling_store.SWEEP_MAX_BLOCKS

#: Cluster widths of ``csrc/sweep_rwa.cu`` (RWA): powers of two up to 16,
#: the non-portable size.
RWA_CLUSTERS = (1, 2, 4, 8, 16)
#: Leaves of 128 sites one block of the RWA kernel holds at most.
RWA_MAX_RANK_LEAVES = 128
#: The RWA width rule's aim: the narrowest cluster whose blocks hold at
#: most this many leaves (``cluster_width``).
RWA_BLOCK_LEAVES = 4
#: Steps of a staged window (both sources): 4 uniforms and a temperature.
WINDOW_FLOATS = 5 * common.SWEEP_WINDOW

#: Cluster widths of ``csrc/sweep_rsa.cu`` (RSA): any width up to 16, the
#: non-portable size.
RSA_CLUSTERS = tuple(range(1, 17))
#: A block of the RSA kernel holds a slice of a multiple of this many sites
#: (four 32-bit plane words).
RSA_SLAB = 128
#: Row slots of the RSA kernel's ring: as many as the shared memory left
#: over holds, between these.
RSA_MIN_RING, RSA_MAX_RING = 2, 4
#: Decision slots of the RSA kernel: two staged windows' steps.
RSA_DEC_SLOTS = 2 * common.SWEEP_WINDOW
#: The RSA width rule's aim (``cluster_width``): the widest cluster up to
#: this many blocks.
RSA_BLOCK_AIM = 8

GATHERS = ("dynamic", "onehot", "auto")


def route(mode: str, pr16: bool = False) -> str:
    """The source kernel A's launch takes: ``"sweep_rsa"`` for RSA,
    ``"sweep_rwa"`` for RWA, or ``"sweep"`` (the earlier kernel) for either
    mode forced there by ``pr16`` (timing both designs in one run, never
    the solve)."""
    if pr16:
        return "sweep"
    return "sweep_rwa" if mode == "rwa" else "sweep_rsa"


def rsa_slice(n: int, width: int) -> int:
    """Sites of a block's slice in the RSA kernel's ``width``-block
    cluster: the multiple of :data:`RSA_SLAB` at or above ⌈N/width⌉ (sites
    past N are phantoms). Mirrors ``slice_sites``."""
    per = -(-n // width)
    return RSA_SLAB * -(-per // RSA_SLAB)


def _rsa_bytes(sites: int, num_planes: int, segs: int, ring: int) -> int:
    """The RSA kernel's ``layout(S, B, segs, K).total``."""
    row = 4 * sites if num_planes == 0 else num_planes * sites // 4
    return (6 * sites + ring * row + _align16(8 * segs)
            + 3 * 4 * 2 * common.SWEEP_WINDOW + 24 * RSA_DEC_SLOTS
            + 8 * RSA_MAX_RING + 16)


def rsa_ring(n: int, segs: int, width: int, num_planes: int = 0) -> int:
    """Row slots of the RSA kernel's ring at ``width``: as many as the
    budget (:data:`MAX_SHARED_BYTES`) leaves room for, at most
    :data:`RSA_MAX_RING`; 0 where not even :data:`RSA_MIN_RING` fit.
    Mirrors ``ring_slots``."""
    sites = rsa_slice(n, width)
    base = _rsa_bytes(sites, num_planes, segs, 0)
    row = _rsa_bytes(sites, num_planes, segs, 1) - base
    if base + RSA_MIN_RING * row > MAX_SHARED_BYTES:
        return 0
    return min((MAX_SHARED_BYTES - base) // row, RSA_MAX_RING)


def rsa_shared_bytes(n: int, segs: int, width: int,
                     num_planes: int = 0) -> int:
    """Shared memory of one block of the RSA kernel's ``width``-block
    cluster: u (f32), s and best_s (int8) of its :func:`rsa_slice` sites,
    the ring of :func:`rsa_ring` row slots (each the block's part of a row:
    S f32 on a dense J, ``num_planes`` = 0, or 2B runs of S/32 plane
    words), the PWL table, two staged windows (a site, an accept uniform
    and a temperature a step), :data:`RSA_DEC_SLOTS` decision slots and the
    mbarriers; where not even two slots fit, the size at two. Mirrors
    ``snowball_sweep_rsa_smem_bytes``."""
    ring = rsa_ring(n, segs, width, num_planes) or RSA_MIN_RING
    return _rsa_bytes(rsa_slice(n, width), num_planes, segs, ring)


def rwa_shared_bytes(n: int, segs: int, width: int) -> int:
    """Shared memory of one block of the RWA kernel's ``width``-block
    cluster: u and the flip probabilities (f32) and s and best_s (int8) of
    its ``tree_leaves(N) / width`` leaves of 128 sites, the PWL table, two
    staged windows and the leaf sums. Mirrors
    ``snowball_sweep_rwa_smem_bytes``."""
    leaves = max(1, common.tree_leaves(n) // width)
    sites = leaves * common.MAX_LANE
    return (10 * sites + _align16(8 * segs) + 2 * 4 * WINDOW_FLOATS
            + _align16(4 * leaves))


def shared_bytes(n: int, lane: int, segs: int, rwa: bool,
                 width: int = 1, pr16: bool = False,
                 num_planes: int = 0) -> int:
    """Shared memory of one block of a ``width``-block sweep cluster. RWA
    (unless ``pr16``): :func:`rwa_shared_bytes`; RSA (unless ``pr16``):
    :func:`rsa_shared_bytes` (``num_planes`` B, 0 for a dense J). The
    earlier route (``sweep.cu``): u, s and best_s of its N/width slice (3·N/width f32), the PWL
    intercepts and slopes (2·S), the staged window (64 steps × 4 uniforms
    and 64 temperatures), and for RWA the slice's block sums plus one
    128-wide lane buffer. Mirrors ``snowball_sweep_smem_bytes``."""
    if rwa and not pr16:
        return rwa_shared_bytes(n, segs, width)
    if not pr16:
        return rsa_shared_bytes(n, segs, width, num_planes)
    nc = n // width
    floats = (3 * nc + 2 * segs + common.SWEEP_WINDOW * 5
              + ((nc // lane) + common.MAX_LANE if rwa else 0))
    return 4 * floats


def widths(n: int, lane: int, segs: int, rwa: bool,
           pr16: bool = False, num_planes: int = 0) -> list:
    """The cluster widths the sweep can run N on, for any N up to the
    port's ceiling ``coupling.SWEEP_STATE_MAX_N``. RWA (unless ``pr16``):
    the powers of two c ≤ 16 and ≤ ``tree_leaves(N)`` whose subtrees of
    ``tree_leaves(N) / c`` leaves fit one block. RSA (unless ``pr16``): any
    c ≤ 16 whose last block holds a site below N and whose blocks fit
    (:func:`rsa_shared_bytes`, with ``num_planes`` B, 0 for a dense J, the
    largest row at B ≤ 16). Neither reads ``lane``. The earlier route:
    c ≤ 8 whose slices N/c are whole lane blocks and fit one block's
    shared memory."""
    if not pr16 and not rwa:
        if n > coupling_store.SWEEP_STATE_MAX_N:
            return []
        return [c for c in RSA_CLUSTERS
                if (c - 1) * rsa_slice(n, c) < n
                and rsa_ring(n, segs, c, num_planes) > 0]
    if rwa and not pr16:
        if n > coupling_store.SWEEP_STATE_MAX_N:
            return []
        leaves = common.tree_leaves(n)
        return [c for c in RWA_CLUSTERS
                if c <= leaves and leaves // c <= RWA_MAX_RANK_LEAVES
                and rwa_shared_bytes(n, segs, c) <= MAX_SHARED_BYTES]
    return [c for c in range(1, MAX_CLUSTER + 1)
            if n % c == 0 and (n // c) % lane == 0
            and shared_bytes(n, lane, segs, rwa, c, True)
            <= MAX_SHARED_BYTES]


#: Spins of a plane row that one block's 8 warps decode in one pass (1024
#: each: 32 packed words a warp).
PLANE_PASS_SPINS = 8 * 1024


def cluster_width(n: int, lane: int, segs: int, rwa: bool,
                  planes: bool = False, r: int = 1,
                  pr16: bool = False, num_planes: int = 0) -> int:
    """The blocks per replica the sweep runs on (chosen here from N, the
    mode, the store and R, not by the caller). Raises past the ceiling
    (:func:`max_n`).

    RWA (``csrc/sweep_rwa.cu``): its results do not depend on the width, so
    the rule is for speed alone: the narrowest width whose blocks hold at
    most :data:`RWA_BLOCK_LEAVES` leaves (the widest where none does),
    narrowed until R·c blocks stay within the card's SMs
    (:data:`COLORED_SMS`), or the narrowest that fits where none does.
    ``scripts/rwa_variants.py`` (an H100 80GB HBM3 at a 700 W limit; ms
    per 256-step launch of the keyed sweep, R=8, PWL, at c = 1, 2, 4, 8,
    16): K2000 dense 0.7309, 0.5379, 0.5273, 0.5252, 0.5326; K4096
    ``bitplane`` 1.1247, 0.7949, 0.6227, 0.5842, 0.6087; N=16384
    ``bitplane_hbm`` 3.4726, 1.9179, 1.1484, 0.8300, 0.7574; N=14,481
    3.4727, 1.9271, 1.1527, 0.8338, 0.7652. The rule picks the fastest
    width, or one within 0.4 % of it (c = 4, 8, 16, 16). A step is a
    chain of latencies (two exchanges, the row read, one leaf's evaluation
    and sums), so a block gains little from more than a few leaves' work;
    past 4 leaves a block the evaluation grows with them and a wider
    cluster pays. At 512 threads a block the same widths read no faster
    at R=8 (c = 16 then loses half its clusters to a second wave), and
    1,024 spill.

    RSA (``csrc/sweep_rsa.cu``; ``num_planes`` B, 0 for a dense J): its
    results do not depend on the width either: the widest width up to
    :data:`RSA_BLOCK_AIM` that fits (the narrowest where none does),
    narrowed until R·c blocks stay within the card's SMs, or the narrowest
    that fits where none does. ``scripts/rsa_variants.py`` (an H100 80GB
    HBM3 at a 700 W limit; the device's ms per 256-step launch of the
    keyed sweep, R=8, PWL, 10 launches replayed as one CUDA graph): K2000
    dense at c = 1, 2, 3, 4, 6, 8, 16: 0.1914, 0.1835, 0.1543, 0.1539,
    0.1541, 0.1527, 0.1688; K4096 ``bitplane`` at c = 1-8, 11, 16: 0.2484,
    0.2031, 0.2042, 0.1850, 0.1857, 0.1844, 0.1833, 0.1822, 0.2033, 0.2010;
    N=16384 ``bitplane_hbm`` at c = 1-8: 0.5830, 0.3612, 0.3095, 0.2653,
    0.2639, 0.2442, 0.2426, 0.2196, then 0.2232-0.2548 up to 16; N=14,481
    at c = 1-8: 0.5464, 0.3503, 0.2912, 0.2710, 0.2473, 0.2464, 0.2276,
    0.2219, then 0.2222-0.2539 up to 15. The rule's c = 8 is the fastest
    width at all four. 200 launches at c = 8 each replayed alone spread
    by under 0.3 % from the fastest to the median at every shape (the
    card holds 45-62 clusters of 8 at once); launches timed from the host
    add the host's dispatch wherever the stream was idle (0.43-0.77 ms a
    launch after 50 ms idle), which earlier readings of this rule
    included. A step is its decision, one exchange, the apply of a row
    part (a few quads a thread) and a block barrier: the split pays while
    a block holds more than a few hundred sites, and wider clusters add
    to the exchange (its floor, 0.0760-0.0841 ms a launch, rises with c).

    The earlier route (``pr16``): RWA and dense RSA take the widest width that
    fits; RSA on planes takes the narrowest width whose slice one block
    decodes in one pass (:data:`PLANE_PASS_SPINS`).
    ``chip_smoke.py``'s width sweep (an H100 80GB HBM3 at a 700 W limit; ms
    per 256-step launch of the keyed sweep, R=8, at c = 1, 2, 4, 8): K2000
    dense RSA 0.3432, 0.3796, 0.2800, 0.2651 and PR 16's RWA 1.6411,
    1.5150, 1.3186, 1.3130; K4096 ``bitplane`` RSA 0.4399, 0.5395, 0.5551,
    0.4893 and RWA 1.8670, 1.8205, 1.6662, 1.5883; N=16384 ``bitplane_hbm``
    RSA 0.8537, 0.5924, 0.5769, 0.5791 and RWA 6.5139, 3.9008, 2.7735,
    2.2571. An RSA step is one row update: on a dense J every thread takes
    fewer columns, but a plane row is decoded 1024 spins a warp, so a split
    pays only while a block would need a second pass (N=16384) and costs a
    cluster barrier where one pass suffices (K4096)."""
    fits = widths(n, lane, segs, rwa, pr16, num_planes)
    if not fits:
        top = MAX_CLUSTER if pr16 else 16
        raise ValueError(
            f"N={n} does not fit the sweep at any cluster width up to "
            f"{top}: a block's slice needs "
            f"{shared_bytes(n, lane, segs, rwa, top, pr16, num_planes)} "
            f"bytes of "
            f"shared memory at width {top} (at most "
            f"{MAX_SHARED_BYTES}), or N/width is not a whole number of "
            f"{lane}-wide lane blocks; the sweep takes N ≤ "
            f"{max_n(rwa, segs, pr16)} with the default lane")
    if not pr16:
        if rwa:
            small = [c for c in fits
                     if common.tree_leaves(n) // c <= RWA_BLOCK_LEAVES]
            pick = small[0] if small else fits[-1]
        else:
            aim = [c for c in fits if c <= RSA_BLOCK_AIM]
            pick = aim[-1] if aim else fits[0]
        ok = [c for c in fits if c <= pick and r * c <= COLORED_SMS]
        return ok[-1] if ok else fits[0]
    if planes and not rwa:
        one_pass = [c for c in fits if n // c <= PLANE_PASS_SPINS]
        if one_pass:
            return one_pass[0]
    return fits[-1]


@functools.cache
def max_n(rwa: bool = True, segs: int = 64, pr16: bool = False) -> int:
    """Largest N the sweep takes with the default lane. The earlier route: 8
    blocks of a cluster each hold a slice, so about 8 × 19.1k spins, in
    place of the TPU's VMEM wall at N=2000. RWA: 16 blocks of 128 leaves
    would hold 262,144 sites; RSA: 16 blocks, each with its ring of dense
    row parts, ~258k; the port's ceiling ``coupling.SWEEP_STATE_MAX_N``
    caps both."""
    if not pr16:
        n = coupling_store.SWEEP_STATE_MAX_N
        while not widths(n, 1, segs, rwa):
            n -= 1
        return n
    per_block = (MAX_SHARED_BYTES // 4 - 2 * segs - 5 * common.SWEEP_WINDOW
                 - (common.MAX_LANE if rwa else 0)) // 3
    n = MAX_CLUSTER * per_block
    while not widths(n, common.default_lane(n), segs, rwa, True):
        n -= 1
    return n


#: Blocks of the earlier colored kernel's clusters (``colored_sweep.cu``):
#: powers of 2 up to 16, the non-portable cluster size Hopper allows.
COLORED_CLUSTERS = (1, 2, 4, 8, 16)
#: Blocks of the route's clusters: any width up to 16.
COLORED_WIDTHS = tuple(range(1, 17))
#: Dense row slices in a colored block thread's cp.async ring of the
#: earlier kernel, ``csrc/colored_sweep.cu`` (``kRing``).
COLORED_RING = 8
#: Ring slots of a block of ``csrc/colored_sweep_hopper.cu``: as many as
#: the shared memory left over holds, between these (``kMinRing``,
#: ``kMaxRing``).
COLORED_MIN_RING, COLORED_MAX_RING = 2, 512
#: Warps of a ``csrc/colored_sweep_hopper.cu`` block (``kWarps``): each
#: sends a partial every step.
COLORED_WARPS = 8
#: SMs of an H100 SXM: the earlier colored rule kept R·C blocks within
#: them.
COLORED_SMS = 132
#: Clusters of each width an H100 80GB HBM3 holds at once with the route's
#: blocks (one an SM, its shared memory full):
#: ``cudaOccupancyMaxActiveClusters`` at N=16384, read by
#: ``scripts/colored_variants.py``. A cluster's blocks share a GPC, so past
#: 9 blocks only 7 clusters fit.
COLORED_CLUSTERS_HELD = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                         8: 15, 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7,
                         15: 7, 16: 7}


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def colored_slice_len(n: int, cluster: int) -> int:
    """Spins of a colored block's slice: all of N for one block, else a
    whole number of 32-spin words, ⌈⌈N/C⌉/32⌉ of them (the last block holds
    what is left). Mirrors ``slice_len``."""
    if cluster == 1:
        return n
    per = -(-n // cluster)
    return 32 * -(-per // 32)


def colored_slot_bytes(n: int, cluster: int, num_planes: int) -> int:
    """Bytes of one ring slot of ``csrc/colored_sweep_hopper.cu``: the
    2·B plane runs of the slice's words, each rounded up to 16 bytes, or
    (``num_planes`` 0, a dense J) the slice's floats rounded up to 16 bytes.
    Mirrors ``slot_bytes``."""
    nc = colored_slice_len(n, cluster)
    if num_planes == 0:
        return 4 * (-(-nc // 4) * 4)
    return 4 * 2 * num_planes * ((-(-nc // 32) + 3) // 4 * 4)


def _colored_layout(n: int, window: int, segs: int, cluster: int,
                    num_planes: int, ring: int) -> int:
    """``csrc/colored_sweep_hopper.cu``'s ``layout(...).total``."""
    nc = colored_slice_len(n, cluster)
    nwm = -(-window // 32) + 1
    return (3 * 32 * (-(-nc // 32) | 1) * 4 + _align16(8 * segs)
            + _align16(2 * 8 * nwm) + 2 * 8 * cluster * COLORED_WARPS + 16
            + _align16(4 * (max(ring, window) if num_planes == 0 else ring))
            + ring * colored_slot_bytes(n, cluster, num_planes))


@functools.cache
def colored_ring(n: int, window: int, segs: int, cluster: int = 1,
                 dense: bool = False, num_planes: int = 1) -> int:
    """Ring slots of a ``csrc/colored_sweep_hopper.cu`` block at width
    ``cluster``: as many as :data:`MAX_SHARED_BYTES` leaves room for after
    the state, at most :data:`COLORED_MAX_RING`; 0 where not even
    :data:`COLORED_MIN_RING` fit. Mirrors ``ring_slots``."""
    b = 0 if dense else num_planes
    base = _colored_layout(n, window, segs, cluster, b, 0)
    if base >= MAX_SHARED_BYTES:
        return 0
    k = min((MAX_SHARED_BYTES - base)
            // (colored_slot_bytes(n, cluster, b) + 4), COLORED_MAX_RING)
    while k >= COLORED_MIN_RING and _colored_layout(
            n, window, segs, cluster, b, k) > MAX_SHARED_BYTES:
        k -= 1
    return k if k >= COLORED_MIN_RING else 0


def colored_shared_bytes(n: int, window: int, segs: int, cluster: int = 1,
                         dense: bool = False, num_planes: int = 1,
                         pr17: bool = False) -> int:
    """Shared memory of one colored block holding a slice of
    :func:`colored_slice_len` spins: u, s and best_s word-transposed at an
    odd pitch (3·32·(⌈slice/32⌉ | 1) f32), the PWL intercepts and slopes,
    the two mailboxes (accept and sign words, ⌈S/32⌉+1 each), then on
    ``csrc/colored_sweep_hopper.cu`` the partials (a pair per rank and
    warp, two parities), the two mbarriers, the slots' headers (on the
    dense tier a step's whole list, S entries at least) and the ring of
    :func:`colored_ring` slots (at least 2; where fewer fit, the size at
    2). Mirrors ``snowball_colored_hopper_smem_bytes``.

    ``pr17``: the earlier kernel's (``csrc/colored_sweep.cu``), which keeps
    the accepted-slot list (S words) in place of the ring and, on the dense
    tier, a cp.async ring of :data:`COLORED_RING` row slices. Mirrors
    ``snowball_colored_smem_bytes``."""
    if not pr17:
        b = 0 if dense else num_planes
        ring = colored_ring(n, window, segs, cluster, dense, num_planes)
        return _colored_layout(n, window, segs, cluster, b,
                               ring or COLORED_MIN_RING)
    nc = colored_slice_len(n, cluster)
    pitch = -(-nc // 32) | 1
    nwm = -(-window // 32) + 1
    total = _align16(3 * 32 * pitch * 4)
    total += _align16(2 * segs * 4)
    total += _align16(4 * nwm * 4)
    total += _align16(4 * cluster * 4)
    total += _align16(2 * 8 * 4)
    total += _align16(window * 4)
    if dense:
        total += _align16(COLORED_RING * -(-nc // 4) * 16)
    return total


def colored_widths(n: int, window: int, segs: int, dense: bool = False,
                   num_planes: int = 1, pr17: bool = False) -> list:
    """The cluster widths C the colored kernel (``pr17``: the earlier one)
    can run N on: C blocks whose slices (:func:`colored_slice_len`, the last
    one nonempty) fit one block's shared memory, with the ring's two slots
    at least."""
    if not 1 <= window <= min(n, 65536):
        return []
    return [c for c in (COLORED_CLUSTERS if pr17 else COLORED_WIDTHS)
            if (c == 1 or (c - 1) * colored_slice_len(n, c) < n)
            and colored_shared_bytes(n, window, segs, c, dense, num_planes,
                                     pr17) <= MAX_SHARED_BYTES]


def colored_width(n: int, window: int, segs: int, r: int,
                  dense: bool = False, num_planes: int = 1,
                  pr17: bool = False) -> int:
    """The blocks per replica the colored sweep runs on (chosen here from
    N, the window, R and the tier, not by the caller): the widest width
    that fits whose R clusters the card holds at once
    (:data:`COLORED_CLUSTERS_HELD`), on the plane tiers one whose slice is
    whole 16-byte runs of words where one is (its rows copy 16 bytes a
    copy), or the narrowest that fits where none holds R. Raises past the
    ceiling (:func:`colored_max_n`).

    ``scripts/colored_variants.py`` on an H100 80GB HBM3 at a 700.00 W
    limit (one run; keyed, R=8, ms per 256-step launch by CUDA-graph
    replay, C = 1..16): the N=16384, χ=11 anchor on ``bitplane_hbm``
    114.857, 17.799, 17.647, 12.442, 15.772, 12.680, 12.011, **7.523**,
    10.898, 14.274, 20.688, 20.654, 13.769, 20.264, 20.264, 12.300; dense
    (C ≥ 2) 388.254, 113.703, 63.615, 49.894, 37.092, 42.295, 29.935,
    **26.290**, 47.589, 44.088, 45.293, 42.288, 39.257, 37.071, 28.558; a
    32×32 torus (C = 1–8, 11, 16) 3.590, 3.002, 2.927, 2.147, 2.195, 2.158,
    2.122, **1.846**, 3.678, 3.560; sparse N=4096 (no C=14) 3.958, 2.495,
    3.290, 2.130, 2.903, 2.908, 2.831, **1.906**, 2.066, 4.034, 3.737,
    4.048, 4.037, 4.046, 3.520. Past C=9 the card holds 7 clusters, so R=8
    runs in two waves; on the planes a slice of 57–103 words (C = 5–7, 9)
    copies 4 bytes a copy. The rule picks the fastest width in all four
    lines. ``pr17``: the earlier kernel's rule, the widest power of 2 whose
    R·C blocks stay within :data:`COLORED_SMS` (its readings in PERF.md
    §6)."""
    fits = colored_widths(n, window, segs, dense, num_planes, pr17)
    if not fits:
        raise ValueError(
            f"N={n} with a class window of S={window} fits no colored "
            f"cluster width: a block holds its slice of u, s and best_s, "
            f"the window's mailboxes and at least two ring slots in "
            f"{MAX_SHARED_BYTES} bytes of shared memory, with C ≤ "
            f"{COLORED_CLUSTERS[-1]} blocks; at this window the colored "
            f"sweep takes {window} ≤ N ≤ "
            f"{colored_max_n(window, segs, num_planes, pr17)} "
            f"(colored_max_n)")
    if pr17:
        ok = [c for c in fits if r * c <= COLORED_SMS]
    else:
        ok = [c for c in fits if r <= COLORED_CLUSTERS_HELD[c]]
        # On the planes, a slice of whole 16-byte runs of words copies 16
        # bytes a copy, the others 4.
        ok = [c for c in ok if dense or c == 1
              or colored_slice_len(n, c) // 32 % 4 == 0] or ok
    return ok[-1] if ok else fits[0]


@functools.cache
def colored_max_n(window: int, segs: int = 64, num_planes: int = 1,
                  pr17: bool = False) -> int:
    """Largest N the colored sweep takes on the plane tiers (``num_planes``
    planes) at a class window of S: 16 blocks a replica, each holding a
    slice of up to N/16 spins and, on ``csrc/colored_sweep_hopper.cu``, a
    ring of at least two slots. Every N from S up to it fits some width.
    ``pr17``: the earlier kernel's (~288k spins at S=3072)."""
    c = COLORED_CLUSTERS[-1]
    nc = 32
    while colored_shared_bytes(c * (nc + 32), window, segs, c, False,
                               num_planes, pr17) <= MAX_SHARED_BYTES:
        nc += 32
    return c * nc


@functools.cache
def _fns():
    lib = _build.load("sweep")
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = lib.snowball_sweep
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 4 + [w] * 2 + [i] * 2
                   + [p] * 2 + [i] + [p] * 9 + [i] * 8 + [p])
    fn.restype = ctypes.c_int
    draw = lib.snowball_sweep_uniforms
    draw.argtypes = [w, w, i, i, i, i, p, p]
    draw.restype = ctypes.c_int
    return fn, draw


@functools.cache
def _rwa_fn():
    fn = _build.load("sweep_rwa").snowball_sweep_rwa
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 4 + [w] * 2 + [i] * 2
                   + [p] * 2 + [i] + [p] * 9 + [i] * 6 + [p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _rsa_fn():
    fn = _build.load("sweep_rsa").snowball_sweep_rsa
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 4 + [w] * 2 + [i] * 2
                   + [p] * 2 + [i] + [p] * 9 + [i] * 5 + [p])
    fn.restype = ctypes.c_int
    return fn


#: The packed PWL table of each live table tensor, by id: (a weak
#: reference to it, its version, the packed tensor, S). A solve passes one
#: table to every chunk's launch.
_PACKED_PWL: dict = {}


def _pwl_args(pwl_table: Optional[torch.Tensor]):
    """(pointer, S) of the table the kernels read: icpt[S], slopes[S], z_lo,
    z_hi, inv_step, computed on the table's device with the plain version's
    arithmetic (no host round trip), once per table tensor as long as it
    lives unmodified; (None, 0) for the exact sigmoid."""
    if pwl_table is None:
        return None, 0
    key = id(pwl_table)
    hit = _PACKED_PWL.get(key)
    if (hit is None or hit[0]() is not pwl_table
            or hit[1] != pwl_table._version):
        c = common.pwl_coefficients(pwl_table)
        packed = torch.cat([c.icpt, c.slopes,
                            torch.stack([c.z_lo, c.z_hi, c.inv_step])])
        ref_ = weakref.ref(pwl_table,
                           lambda _, key=key: _PACKED_PWL.pop(key, None))
        hit = (ref_, pwl_table._version, packed, c.icpt.shape[0])
        _PACKED_PWL[key] = hit
    return hit[2].data_ptr(), hit[3]


def _check_call(couplings, fields0: torch.Tensor, mode: str, gather: str,
                coupling: str, lane: Optional[int], coalesce: bool):
    """The arguments every sweep entry checks; returns the lane and whether
    rows_fetched is coalesced."""
    if mode not in ("rsa", "rwa"):
        raise ValueError(f"mode must be 'rsa' or 'rwa', got {mode!r}")
    if gather not in GATHERS:
        raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
    n = fields0.shape[1]
    coupling_store.validate_kernel_operand(coupling, couplings, n, gather)
    lane = common.default_lane(n) if lane is None else lane
    if n % lane or lane > common.MAX_LANE:
        raise ValueError(f"N={n} not divisible by lane={lane} (or lane > "
                         f"{common.MAX_LANE})")
    return lane, coalesce and coupling_store.FORMATS[coupling].coalescable


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
    (None = exact sigmoid). ``lane`` (default ``common.default_lane(N)``)
    is checked as JAX's signature has it; RWA's pick, on the card and in
    the plain version, is ``common.roulette_pick_tree`` and does not read
    it. ``gather`` takes the JAX package's values: on the
    dense tier they give identical results and run the same row-fetch
    kernel; the plane tiers reject "onehot". ``coalesce`` (the streamed tier
    only) counts ``rows_fetched`` as each step's unique rows per group of
    ``fit_block(R, block_r)`` replicas, charged to the lowest replica
    selecting each; the trajectory does not depend on it. Returns
    ``(fields, spins, energy, best_energy, best_spins, num_flips,
    rows_fetched)``.
    """
    lane, coalesce = _check_call(couplings, fields0, mode, gather, coupling,
                                 lane, coalesce)
    if fields0.device.type == "cpu":
        return ref.mcmc_sweep(couplings, fields0, spins0, energy0, uniforms,
                              temps, pwl_table, mode=mode,
                              uniformized=uniformized, lane=lane,
                              coupling=coupling, block_r=block_r,
                              coalesce=coalesce)
    return _launch(couplings, fields0, spins0, energy0, temps, pwl_table,
                   uniforms=uniforms, key=None, mode=mode,
                   uniformized=uniformized, block_r=block_r, lane=lane,
                   coalesce=coalesce, width=None)


def mcmc_sweep_keyed(couplings, fields0: torch.Tensor, spins0: torch.Tensor,
                     energy0: torch.Tensor, base_words: Sequence[int],
                     chunk: int, temps: torch.Tensor,
                     pwl_table: Optional[torch.Tensor] = None, *,
                     mode: str = "rsa", uniformized: bool = False,
                     gather: str = "dynamic", coupling: str = "dense",
                     block_r: int = 8, lane: Optional[int] = None,
                     coalesce: bool = True, out=None,
                     fold: Optional[int] = None):
    """:func:`mcmc_sweep` on the uniforms of ``rng.uniform01(rng.stream(
    base, Salt.SWEEP, chunk), (T, R, 4))``, where ``base_words`` are the two
    words of the base key (Python ints) and T = ``temps.shape[0]``; with a
    device ``fold`` (an int ≥ 0) on those of ``stream(base, SWEEP, fold,
    chunk)``, the stream of one rank's replicas in the replica-parallel
    solve. On the card the kernel draws them itself (no uniforms tensor,
    no host RNG); on the CPU the plain version runs on the drawn tensor.
    ``out`` (the card only) is the seven output tensors for the kernel to
    write in place of new ones, so a CUDA graph can read them at fixed
    addresses."""
    lane, coalesce = _check_call(couplings, fields0, mode, gather, coupling,
                                 lane, coalesce)
    if fold is not None and fold < 0:
        raise ValueError(f"a device fold is an index >= 0, got {fold}")
    if fields0.device.type == "cpu":
        if out is not None:
            raise ValueError("out= serves the card's launch only")
        uniforms = rng.uniform01(
            ref.sweep_chunk_key(base_words, chunk, fold),
            (temps.shape[0], fields0.shape[0], 4))
        return ref.mcmc_sweep(couplings, fields0, spins0, energy0, uniforms,
                              temps, pwl_table, mode=mode,
                              uniformized=uniformized, lane=lane,
                              coupling=coupling, block_r=block_r,
                              coalesce=coalesce)
    return _launch(couplings, fields0, spins0, energy0, temps, pwl_table,
                   uniforms=None, key=(base_words, chunk, fold), mode=mode,
                   uniformized=uniformized, block_r=block_r, lane=lane,
                   coalesce=coalesce, width=None, out=out)


def mcmc_sweep_at_width(width: int, couplings, fields0: torch.Tensor,
                        spins0: torch.Tensor, energy0: torch.Tensor,
                        temps: torch.Tensor,
                        pwl_table: Optional[torch.Tensor] = None, *,
                        uniforms: Optional[torch.Tensor] = None,
                        base_words: Optional[Sequence[int]] = None,
                        chunk: int = 0, mode: str = "rsa",
                        uniformized: bool = False, coupling: str = "dense",
                        block_r: int = 8, lane: Optional[int] = None,
                        coalesce: bool = True, pr16: bool = False):
    """The card's sweep at a cluster width of the caller's choice (one of
    :func:`widths`) in place of :func:`cluster_width`'s: for the width
    sweep and the card tests, never the solve. Takes ``uniforms`` or
    ``base_words`` and ``chunk``. ``pr16`` forces either mode onto the
    earlier kernel (``csrc/sweep.cu``), to time both designs in one run."""
    lane, coalesce = _check_call(couplings, fields0, mode, "dynamic",
                                 coupling, lane, coalesce)
    if fields0.device.type != "cuda":
        raise ValueError("mcmc_sweep_at_width runs the kernel: CUDA tensors "
                         "only")
    if (uniforms is None) == (base_words is None):
        raise ValueError("pass uniforms or base_words, not both")
    key = None if base_words is None else (base_words, chunk, None)
    return _launch(couplings, fields0, spins0, energy0, temps, pwl_table,
                   uniforms=uniforms, key=key, mode=mode,
                   uniformized=uniformized, block_r=block_r, lane=lane,
                   coalesce=coalesce, width=width, pr16=pr16)


def sweep_uniforms(base_words: Sequence[int], chunk: int, t: int, r: int,
                   device=None, fold: Optional[int] = None) -> torch.Tensor:
    """The (T, R, 4) uniforms the keyed sweep draws for ``chunk`` (and a
    device ``fold``): on the card by the kernel's own device function
    (``snowball_sweep_uniforms``), on the CPU by its plain version
    (``ref.sweep_uniforms``). The solve never calls it; the checks hold the
    in-kernel draw against ``rng.uniform01`` with it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cpu":
        return ref.sweep_uniforms(base_words, chunk, t, r, fold=fold)
    if t * r * 4 >= 2 ** 31:
        raise ValueError(f"T·R·4 = {t * r * 4} uniforms exceed one launch")
    out = torch.empty((t, r, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fns()[1](base_words[0], base_words[1], chunk,
                       -1 if fold is None else fold, t, r, out.data_ptr(),
                       stream)
    if rc != 0:
        raise RuntimeError(f"sweep_uniforms launch failed: CUDA error {rc}")
    uniforms_counter.count += 1
    return out


def _launch(couplings, fields0, spins0, energy0, temps, pwl_table, *,
            uniforms, key, mode, uniformized, block_r, lane, coalesce,
            width, out=None, pr16=False, entry=None):
    """Checks the operands and launches the source :func:`route` names
    (``snowball_sweep_rsa``, ``snowball_sweep_rwa`` or ``snowball_sweep``;
    reading ``uniforms``, or drawing from ``key = (base_words, chunk,
    fold)``), writing new output tensors or the seven given in ``out``. A
    refused launch raises and tries nothing else. ``entry``: an RSA
    measurement build's ``snowball_sweep_rsa`` (``scripts/rsa_variants.py``),
    launched in the route's place and counted on no counter."""
    r, n = fields0.shape
    t = temps.shape[0]
    rwa = mode == "rwa"
    dev = fields0.device
    checks = (("fields0", fields0, (r, n)),
              ("spins0", spins0, (r, n)), ("energy0", energy0, (r,)),
              ("temps", temps, (t, r)))
    if uniforms is not None:
        checks += (("uniforms", uniforms, (t, r, 4)),)
    if pwl_table is not None:
        checks += (("pwl_table", pwl_table, (pwl_table.shape[0], 3)),)
    check_operands(dev, checks)
    if isinstance(couplings, BitPlanes):
        shape = (couplings.num_planes, n, couplings.num_words)
        check_operands(dev, (("planes.pos", couplings.pos, shape),
                             ("planes.neg", couplings.neg, shape)),
                       dtype=torch.int32)
        store = (None, couplings.pos.data_ptr(), couplings.neg.data_ptr(),
                 couplings.num_planes, couplings.num_words)
        num_planes = couplings.num_planes
    else:
        check_operands(dev, (("couplings", couplings, (n, n)),))
        store = (couplings.data_ptr(), None, None, 0, 0)
        num_planes = 0
    if t * r * 4 >= 2 ** 32:
        raise ValueError(f"T·R·4 = {t * r * 4} uniform counters exceed the "
                         "32-bit count of one threefry draw")
    if key is None:
        draw = (uniforms.data_ptr(), 0, 0, 0, -1)
    else:
        (w0, w1), chunk, fold = key
        draw = (None, int(w0), int(w1), int(chunk),
                -1 if fold is None else int(fold))
    pwl_args = _pwl_args(pwl_table)
    segs = pwl_args[1]
    src = route(mode, pr16)
    fits = widths(n, lane, segs, rwa, pr16, num_planes)
    if width is None:
        width = cluster_width(n, lane, segs, rwa,
                              isinstance(couplings, BitPlanes), r, pr16,
                              num_planes)
    elif width not in fits:
        raise ValueError(f"cluster width {width} does not fit N={n} (lane "
                         f"{lane}): the widths that do are {fits}")
    shapes = ((r, n), (r, n), (r,), (r,), (r, n), (r,), (r,))
    if out is None:
        out = tuple(torch.empty(shape, dtype=torch.float32 if i < 5
                                else torch.int32, device=dev)
                    for i, shape in enumerate(shapes))
    else:
        named = tuple(zip(("out.u", "out.s", "out.e", "out.best_e",
                           "out.best_s", "out.num_flips",
                           "out.rows_fetched"), out, shapes))
        check_operands(dev, named[:5])
        check_operands(dev, named[5:], dtype=torch.int32)
    u, s, e, be, bs, nf, rf = out
    if coalesce:
        group = common.fit_block(r, block_r)
        site_log = torch.empty((max(t, 1), r), dtype=torch.int32, device=dev)
        done = torch.zeros((r // group,), dtype=torch.int32, device=dev)
        rows = (site_log.data_ptr(), done.data_ptr(), group)
    else:
        rows = (None, None, 0)
    common_args = (*store, fields0.data_ptr(), spins0.data_ptr(),
                   energy0.data_ptr(), *draw, temps.data_ptr(), *pwl_args,
                   u.data_ptr(), s.data_ptr(), e.data_ptr(), be.data_ptr(),
                   bs.data_ptr(), nf.data_ptr(), rf.data_ptr(), *rows, r, n,
                   t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if entry is not None:
            rc = entry(*common_args, width, stream)
        elif src == "sweep":
            rc = _fns()[0](*common_args, int(rwa), int(uniformized and rwa),
                           lane, width, stream)
        elif src == "sweep_rwa":
            rc = _rwa_fn()(*common_args, int(uniformized), width, stream)
        else:
            rc = _rsa_fn()(*common_args, width, stream)
    if rc != 0:
        raise RuntimeError(f"mcmc_sweep launch failed ({src}.cu): CUDA "
                           f"error {rc}")
    if entry is not None:
        return u, s, e, be, bs, nf, rf
    counter.count += 1
    if src == "sweep_rwa":
        rwa_hopper_counter.count += 1
    elif src == "sweep_rsa":
        rsa_hopper_counter.count += 1
    return u, s, e, be, bs, nf, rf


def colored_route(pr17: bool = False) -> str:
    """The source kernel D's launch takes: ``"colored_sweep_hopper"``, or
    ``"colored_sweep"`` (the earlier kernel) where ``pr17`` forces it
    (timing both designs in one run, never the solve)."""
    return "colored_sweep" if pr17 else "colored_sweep_hopper"


#: The C entry of each colored source; both take the same operands.
COLORED_ENTRIES = {"colored_sweep": "snowball_colored_sweep",
                   "colored_sweep_hopper": "snowball_colored_sweep_hopper"}


def colored_entry(lib: ctypes.CDLL, name: str):
    """The colored sweep's C entry ``name`` of a loaded library, typed."""
    fn = getattr(lib, name)
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 4 + [w] * 2 + [i] + [p] * 3
                   + [i] + [p] * 9 + [i] * 6 + [p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _colored_fns(src: str = "colored_sweep_hopper"):
    return colored_entry(_build.load(src), COLORED_ENTRIES[src])


def _check_colored(couplings, fields0, spins0, energy0, temps, sched,
                   coupling: str, window: int,
                   uniforms: Optional[torch.Tensor] = None) -> None:
    """The shapes every colored entry checks, on any device."""
    r, n = fields0.shape
    t = temps.shape[0]
    coupling_store.validate_kernel_operand(coupling, couplings, n)
    shapes = [("spins0", spins0, (r, n)), ("energy0", energy0, (r,)),
              ("temps", temps, (t, r)), ("sched", sched, (t, 3))]
    if uniforms is not None:
        shapes.append(("uniforms", uniforms, (t, r, window)))
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
    if not 1 <= window <= n:
        raise ValueError(f"class window S={window} must lie in [1, N={n}]")


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
    accepted once, charged to the group's lowest-index accepting replica.
    """
    if uniforms.dim() != 3:
        raise ValueError(f"uniforms must be (T, R, S), got shape "
                         f"{tuple(uniforms.shape)}")
    win = uniforms.shape[2]
    _check_colored(couplings, fields0, spins0, energy0, temps, sched,
                   coupling, win, uniforms)
    if fields0.device.type == "cpu":
        return ref.colored_sweep(couplings, fields0, spins0, energy0,
                                 uniforms, temps, sched, pwl_table,
                                 block_r=block_r)
    return _colored_launch(couplings, fields0, spins0, energy0, temps, sched,
                           pwl_table, uniforms=uniforms, key=None,
                           window=win, block_r=block_r, width=None)


def colored_sweep_keyed(couplings, fields0: torch.Tensor,
                        spins0: torch.Tensor, energy0: torch.Tensor,
                        base_words: Sequence[int], chunk: int,
                        temps: torch.Tensor, sched: torch.Tensor,
                        pwl_table: Optional[torch.Tensor] = None, *,
                        window: int, coupling: str = "dense",
                        block_r: int = 8):
    """:func:`colored_sweep` on the uniforms of ``rng.uniform01(rng.stream(
    base, Salt.SWEEP, chunk), (T, R, window))``, where ``base_words`` are the
    two words of the base key (Python ints) and T = ``temps.shape[0]``. On
    the card the kernel draws the class slots' uniforms itself (no uniforms
    tensor, no host RNG; ``ref.colored_uniforms`` is its plain version); on
    the CPU the plain version runs on the drawn tensor."""
    _check_colored(couplings, fields0, spins0, energy0, temps, sched,
                   coupling, window)
    if fields0.device.type == "cpu":
        uniforms = rng.uniform01(
            rng.stream(rng.from_words(*base_words), rng.Salt.SWEEP, chunk),
            (temps.shape[0], fields0.shape[0], window))
        return ref.colored_sweep(couplings, fields0, spins0, energy0,
                                 uniforms, temps, sched, pwl_table,
                                 block_r=block_r)
    return _colored_launch(couplings, fields0, spins0, energy0, temps, sched,
                           pwl_table, uniforms=None, key=(base_words, chunk),
                           window=window, block_r=block_r, width=None)


def colored_sweep_at_width(width: int, couplings, fields0: torch.Tensor,
                           spins0: torch.Tensor, energy0: torch.Tensor,
                           temps: torch.Tensor, sched: torch.Tensor,
                           pwl_table: Optional[torch.Tensor] = None, *,
                           uniforms: Optional[torch.Tensor] = None,
                           base_words: Optional[Sequence[int]] = None,
                           chunk: int = 0, window: Optional[int] = None,
                           coupling: str = "dense", block_r: int = 8,
                           pr17: bool = False):
    """The card's colored sweep at a cluster width of the caller's choice
    (one of :func:`colored_widths`) in place of :func:`colored_width`'s:
    for the width sweep and the card tests, never the solve. Takes
    ``uniforms``, or ``base_words``, ``chunk`` and ``window``. ``pr17``
    forces the earlier kernel (``csrc/colored_sweep.cu``, at one of its own
    widths), to time both designs in one run."""
    if (uniforms is None) == (base_words is None):
        raise ValueError("pass uniforms or base_words, not both")
    win = uniforms.shape[2] if uniforms is not None else window
    if win is None:
        raise ValueError("the keyed sweep needs its class window")
    _check_colored(couplings, fields0, spins0, energy0, temps, sched,
                   coupling, win, uniforms)
    if fields0.device.type != "cuda":
        raise ValueError("colored_sweep_at_width runs the kernel: CUDA "
                         "tensors only")
    key = None if base_words is None else (base_words, chunk)
    return _colored_launch(couplings, fields0, spins0, energy0, temps, sched,
                           pwl_table, uniforms=uniforms, key=key, window=win,
                           block_r=block_r, width=int(width), pr17=pr17)


#: The rows_fetched arrival counters of each (device, stream): the kernel
#: leaves them at zero, so they are zeroed once, not at every launch.
_ARRIVALS: dict = {}


def _arrivals(dev: torch.device, stream: int, groups: int) -> torch.Tensor:
    key = (dev.index, stream)
    have = _ARRIVALS.get(key)
    if have is None or have.numel() < groups:
        have = torch.zeros(max(groups, 64), dtype=torch.int32, device=dev)
        _ARRIVALS[key] = have
    return have


def _colored_launch(couplings, fields0, spins0, energy0, temps, sched,
                    pwl_table, *, uniforms, key, window, block_r, width,
                    pr17=False, entry=None):
    """Checks the operands and launches the source :func:`colored_route`
    names (``snowball_colored_sweep_hopper``, or ``snowball_colored_sweep``
    where ``pr17`` forces it; reading ``uniforms``, or drawing from ``key =
    (base_words, chunk)``) at cluster width ``width``, or at
    :func:`colored_width`'s. A refused launch raises and tries nothing
    else. ``entry``: a measurement build's entry with the same operands
    (``scripts/colored_variants.py``), launched in the route's place at the
    route's widths and counted on no counter."""
    r, n = fields0.shape
    t = temps.shape[0]
    dev = fields0.device
    checks = (("fields0", fields0, (r, n)), ("spins0", spins0, (r, n)),
              ("energy0", energy0, (r,)), ("temps", temps, (t, r)))
    if uniforms is not None:
        checks += (("uniforms", uniforms, (t, r, window)),)
    if pwl_table is not None:
        checks += (("pwl_table", pwl_table, (pwl_table.shape[0], 3)),)
    check_operands(dev, checks)
    check_operands(dev, (("sched", sched, (t, 3)),), dtype=torch.int32)
    dense = not isinstance(couplings, BitPlanes)
    if dense:
        check_operands(dev, (("couplings", couplings, (n, n)),))
        store = (couplings.data_ptr(), None, None, 0, 0)
        num_planes = 0
    else:
        num_planes = couplings.num_planes
        pshape = (couplings.num_planes, n, couplings.num_words)
        check_operands(dev, (("planes.pos", couplings.pos, pshape),
                             ("planes.neg", couplings.neg, pshape)),
                       dtype=torch.int32)
        store = (None, couplings.pos.data_ptr(), couplings.neg.data_ptr(),
                 couplings.num_planes, couplings.num_words)
    if t * r * window >= 2 ** 32:
        raise ValueError(f"T·R·S = {t * r * window} uniform counters exceed "
                         "the 32-bit count of one threefry draw")
    if key is None:
        draw = (uniforms.data_ptr(), 0, 0, 0)
    else:
        (w0, w1), chunk = key
        draw = (None, int(w0), int(w1), int(chunk))
    pwl_args = _pwl_args(pwl_table)
    segs = pwl_args[1]
    planes_kw = dict(num_planes=num_planes or 1, pr17=pr17)
    fits = colored_widths(n, window, segs, dense, **planes_kw)
    if width is None:
        width = colored_width(n, window, segs, r, dense, **planes_kw)
    elif width not in fits:
        raise ValueError(f"colored cluster width {width} does not fit N={n}"
                         f", S={window}: the widths that do are {fits}")
    src = colored_route(pr17)
    br = common.fit_block(r, block_r)
    u = torch.empty((r, n), dtype=torch.float32, device=dev)
    s = torch.empty((r, n), dtype=torch.float32, device=dev)
    bs = torch.empty((r, n), dtype=torch.float32, device=dev)
    e = torch.empty((r,), dtype=torch.float32, device=dev)
    be = torch.empty((r,), dtype=torch.float32, device=dev)
    nf = torch.empty((r,), dtype=torch.int32, device=dev)
    rf = torch.empty((r,), dtype=torch.int32, device=dev)
    masks = torch.empty((max(t, 1), r, -(-window // 32) + 1),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if torch.cuda.is_current_stream_capturing():
            # A graph replays its own zeroed counters (a cached tensor
            # would outlive the graph's memory pool).
            arrivals = torch.zeros((r // br,), dtype=torch.int32, device=dev)
        else:
            arrivals = _arrivals(dev, stream, r // br)
        fn = entry if entry is not None else _colored_fns(src)
        rc = fn(
            *store, fields0.data_ptr(), spins0.data_ptr(), energy0.data_ptr(),
            *draw, temps.data_ptr(), sched.data_ptr(), *pwl_args,
            u.data_ptr(), s.data_ptr(), e.data_ptr(), be.data_ptr(),
            bs.data_ptr(), nf.data_ptr(), rf.data_ptr(), masks.data_ptr(),
            arrivals.data_ptr(), br, r, n, t, window, width, stream)
    if rc != 0:
        raise RuntimeError(f"colored_sweep launch failed ({src}.cu): CUDA "
                           f"error {rc}")
    if entry is None:
        colored_counter.count += 1
        if not pr17:
            colored_hopper_counter.count += 1
    return u, s, e, be, bs, nf, rf
