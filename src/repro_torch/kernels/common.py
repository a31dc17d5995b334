"""Per-step selection math shared by the sweep's plain version and kernel.

Port of ``repro.kernels.common``. These torch functions are the plain
PyTorch definition of each step of the sweep; ``csrc/sweep.cu`` repeats the
same float operations in the same order where bitwise agreement is claimed
(the PWL flip probability, the site rescaling) and documents where it adds
in another order (the roulette sums).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import rng
from ..core.bitplane import WORD_BITS, as_uint32

#: Widest lane block of the two-level roulette (the JAX package's value).
MAX_LANE = 128

#: Steps whose uniforms and temperatures the card's single-flip sweep stages
#: in shared memory at a time (one uniform per thread of a 256-thread block).
SWEEP_WINDOW = 64


def fit_block(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is ≤ target."""
    for b in range(min(target, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def default_lane(n: int) -> int:
    """Largest divisor of ``n`` that is ≤ MAX_LANE (125 at N=2000): the
    roulette scans G = N/lane block sums, then one lane-wide block."""
    for lane in range(min(MAX_LANE, n), 0, -1):
        if n % lane == 0:
            return lane
    return 1


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Fused multiply-add ``a·b + c`` of f32 tensors with one rounding.

    XLA's CPU compiler contracts the PWL's multiply-adds into FMAs inside
    jit, so the JAX reference rounds them once; the CUDA kernel calls
    ``__fmaf_rn``. PyTorch has no f32 FMA, so this computes it exactly in
    float64: the product of two f32 values is exact there, TwoSum recovers
    the addition's error, and rounding the sum to odd before the final
    rounding to f32 makes that rounding correct.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


class PwlCoefficients(NamedTuple):
    """The PWL table in the intercept form both sweep versions evaluate."""

    icpt: torch.Tensor       # (S,) f32, fma(−slopes, knots, values)
    slopes: torch.Tensor     # (S,) f32
    z_lo: torch.Tensor       # () f32, first knot
    z_hi: torch.Tensor       # () f32, last knot
    inv_step: torch.Tensor   # () f32, 1 / knot spacing


def pwl_coefficients(pwl_table: torch.Tensor) -> PwlCoefficients:
    """Loop-invariant coefficients of a ``(S+1, 3)`` table, with JAX's f32
    arithmetic (``repro.kernels.common.flip_probability``)."""
    tbl = pwl_table.to(torch.float32)
    knots = tbl[:, 0]
    values = tbl[:, 1]
    slopes = tbl[:-1, 2]
    num_segments = tbl.shape[0] - 1
    inv_step = torch.tensor(1.0, dtype=torch.float32,
                            device=tbl.device) / (knots[1] - knots[0])
    icpt = fma(-slopes, knots[:-1], values[:-1])
    return PwlCoefficients(icpt.contiguous(), slopes.contiguous(),
                           knots[0], knots[num_segments], inv_step)


def flip_probability(delta_e: torch.Tensor, temperature,
                     pwl_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Glauber flip probability σ(−ΔE/T), exact or PWL (gather form).

    T ≤ 0 takes the greedy limit (1 downhill, 0.5 flat, 0 uphill). The PWL
    value is ``fma(slope[seg], zc, icpt[seg])`` with ``zc`` the clipped argument
    and ``seg = int((zc − z_lo)·inv_step)`` clipped to the segments.
    """
    de = delta_e.to(torch.float32)
    t = torch.as_tensor(temperature, dtype=torch.float32, device=de.device)
    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    z = -de / safe_t
    if pwl_table is None:
        warm = torch.sigmoid(z)
    else:
        c = pwl_coefficients(pwl_table)
        zc = torch.minimum(torch.maximum(z, c.z_lo), c.z_hi)
        seg = ((zc - c.z_lo) * c.inv_step).to(torch.int32)
        seg = torch.clamp(seg, 0, c.icpt.shape[0] - 1).to(torch.int64)
        warm = fma(c.slopes[seg], zc, c.icpt[seg])
    cold = torch.where(de < 0, 1.0, torch.where(de == 0, 0.5, 0.0))
    return torch.where(t > 0, warm, cold).to(torch.float32)


def roulette_block_pick(blk: torch.Tensor, u_roulette: torch.Tensor):
    """Level 1 of the roulette over the (R, G) block sums. Returns
    ``(g, residual, total, degenerate)``."""
    num_blocks = blk.shape[1]
    cb = torch.cumsum(blk, dim=1)
    total = cb[:, -1]
    degenerate = (total <= 0) | ~torch.isfinite(total)
    radius = u_roulette * torch.where(degenerate, torch.ones_like(total),
                                      total)
    g = torch.clamp((cb <= radius[:, None]).sum(dim=1), max=num_blocks - 1)
    iota_g = torch.arange(num_blocks, device=blk.device)
    base = torch.where(iota_g[None, :] < g[:, None], blk,
                       torch.zeros_like(blk)).sum(dim=1)
    return g, radius - base, total, degenerate


def roulette_lane_pick(sel: torch.Tensor, residual: torch.Tensor,
                       lane: int) -> torch.Tensor:
    """Level 2: the lane pick inside the selected (R, lane) block."""
    cl = torch.cumsum(sel, dim=1)
    return torch.clamp((cl <= residual[:, None]).sum(dim=1), max=lane - 1)


def roulette_pick(p_all: torch.Tensor, u_roulette: torch.Tensor, lane: int):
    """Two-level roulette-wheel selection (paper Eq. 28-29): site ``j`` with
    probability ``p_j / W``. Returns ``(site int64, total, degenerate)``."""
    r_, n = p_all.shape
    num_blocks = n // lane
    pb = p_all.reshape(r_, num_blocks, lane)
    blk = pb.sum(dim=2)
    g, residual, total, degenerate = roulette_block_pick(blk, u_roulette)
    sel = pb[torch.arange(r_, device=p_all.device), g]
    l = roulette_lane_pick(sel, residual, lane)
    return g * lane + l, total, degenerate


def site_from_uniform(u01: torch.Tensor, n: int) -> torch.Tensor:
    """Random-scan site pick — the canonical ``core.rng`` rescaling."""
    return rng.index_from_uniform(u01, n).to(torch.int64)


def decode_bitplane_rows(pos: torch.Tensor, neg: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Packed signed bit-plane words → f32 coupling rows (Eq. 13).

    ``pos``/``neg``: (B, ..., W) int32-held words of one J row per plane.
    Returns (..., n) float32, J_row = Σ_b 2^b (bits(pos_b) − bits(neg_b)),
    LSB-first, summed plane by plane in b order; the values are small
    integers, so the row is exact.
    """
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=pos.device)

    def expand(words):  # (..., W) -> (..., W·32) {0,1}, LSB-first
        bits = (as_uint32(words)[..., :, None] >> shifts) & 1
        return bits.reshape(words.shape[:-1] + (-1,))

    row = torch.zeros(pos.shape[1:-1] + (pos.shape[-1] * WORD_BITS,),
                      dtype=torch.float32, device=pos.device)
    for b in range(pos.shape[0]):
        diff = expand(pos[b]) - expand(neg[b])
        row = row + float(1 << b) * diff.to(torch.float32)
    return row[..., :n]


def coalesce_rows(j: torch.Tensor):
    """Duplicate structure of one step's (R,) selected sites: the unique-row
    fetch plan of the streamed tier. Returns ``(nu, usite, uo, fetched)``:

    * ``nu``      — () int32, the number of unique sites;
    * ``usite``   — (R,) int32, the m-th unique site in first-occurrence
                    order for m < nu, site 0's value past nu;
    * ``uo``      — (R,) int32, each replica's index into the unique list
                    (``usite[uo[r]] == j[r]``);
    * ``fetched`` — (R,) int32, 1 on the lowest-index replica of each
                    duplicate group, 0 on the others (``sum == nu``).
    """
    r = j.shape[0]
    ids = torch.arange(r, dtype=torch.int32, device=j.device)
    rr = ids[:, None].expand(r, r)
    cc = ids[None, :].expand(r, r)
    eq = j[:, None] == j[None, :]
    first_idx = torch.where(eq, cc, torch.full_like(cc, r)).min(dim=1).values
    is_first = first_idx == ids
    fetched = is_first.to(torch.int32)
    uo_first = ((cc <= rr) & is_first[None, :]).sum(dim=1).to(torch.int32) - 1
    uo = torch.where(cc == first_idx[:, None], uo_first[None, :],
                     torch.zeros_like(cc)).sum(dim=1).to(torch.int32)
    nu = fetched.sum().to(torch.int32)
    jj = j.to(torch.int32)
    usite = torch.where((rr == uo_first[None, :]) & is_first[None, :],
                        jj[None, :], torch.zeros_like(cc)).sum(dim=1)
    usite = torch.where(ids < nu, usite, usite[0]).to(torch.int32)
    return nu, usite, uo, fetched


def rows_fetched_step(j: torch.Tensor, block_r: int,
                      coalesce: bool) -> torch.Tensor:
    """(R,) int32 rows one step fetches per replica: 1 each, or, coalesced,
    the ``fetched`` of :func:`coalesce_rows` over each group of
    ``fit_block(R, block_r)`` consecutive replicas."""
    r = j.shape[0]
    if not coalesce:
        return torch.ones(r, dtype=torch.int32, device=j.device)
    br = fit_block(r, block_r)
    return torch.cat([coalesce_rows(g)[3] for g in j.split(br)])
