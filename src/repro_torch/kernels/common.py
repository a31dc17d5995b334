"""Per-step selection math shared by the sweep's plain version and kernel.

Port of ``repro.kernels.common``. These torch functions are the plain
PyTorch definition of each step of the sweep; ``csrc/sweep.cu`` and
``csrc/sweep_rwa.cu`` repeat the same float operations in the same order
where bitwise agreement is claimed (the PWL flip probability, the site
rescaling, and ``roulette_pick_tree``, RWA's roulette on the card);
``roulette_pick`` is JAX's lane-order roulette, which the card's sums
follow only up to their order.
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


def tree_leaves(n: int) -> int:
    """Leaves of :func:`roulette_pick_tree`'s tree over N sites: the power
    of two ≥ ⌈N / MAX_LANE⌉ (sites past N are phantoms of probability 0)."""
    need = -(-n // MAX_LANE)
    return 1 << max(0, (need - 1).bit_length())


def _pairs(x: torch.Tensor) -> torch.Tensor:
    """Each node of the next level up: left child plus right child."""
    return x[..., 0::2] + x[..., 1::2]


def _subtree_levels(p: torch.Tensor) -> list:
    """The node sums of the tree over (R, leaves·128) padded probabilities,
    from the leaves (level 0, (R, leaves)) up to the subtree's root. A
    leaf's 128 sites sit 4 to a lane of 32; a lane adds its pairs, then
    the lanes pair up in index order (the card's shuffle butterfly)."""
    r = p.shape[0]
    x = _pairs(_pairs(p.reshape(r, -1, 32, 4)))[..., 0]       # (R, L, 32)
    while x.shape[-1] > 1:
        x = _pairs(x)
    levels = [x[..., 0]]
    while levels[-1].shape[1] > 1:
        levels.append(_pairs(levels[-1]))
    return levels


def roulette_pick_tree(p_all: torch.Tensor, u_roulette: torch.Tensor,
                       subtrees: int = 1):
    """The roulette of the card's RWA kernel (``csrc/sweep_rwa.cu``): site
    ``j`` with probability ``p_j / W`` over a binary tree whose sums do not
    depend on how the card splits it. Returns ``(site int64, total,
    degenerate)`` as :func:`roulette_pick`.

    N is padded with zeros to :func:`tree_leaves` leaves of 128 sites;
    every node is its left child plus its right child, from a lane's 4
    sites up to the total W. ``subtrees`` (a power of two up to the
    leaves) sums each of that many equal subtrees on its own and then the
    top of the tree over their sums, as the card's cluster ranks do; the
    result is the same bitwise for every split. The radius is ``u·W`` (``u``
    alone on a degenerate W ≤ 0 or non-finite); the pick descends from the
    root, going right iff the radius is ≥ the left sum and the right
    subtree holds a site < N, subtracting that sum; in the leaf it takes
    the ≤-count of the prefix sums (lane k's exclusive scan of the lane
    totals plus its running sum over its 4 sites), clamped to the leaf's
    last site < N. The reference's ≤-count form summed in another order:
    it agrees with :func:`roulette_pick` except near ties."""
    r, n = p_all.shape
    nl = tree_leaves(n)
    if subtrees < 1 or subtrees > nl or subtrees & (subtrees - 1):
        raise ValueError(f"subtrees must be a power of two in [1, {nl}], "
                         f"got {subtrees}")
    rows = torch.arange(r, device=p_all.device)
    p = torch.zeros((r, nl * MAX_LANE), dtype=torch.float32,
                    device=p_all.device)
    p[:, :n] = p_all
    parts = [_subtree_levels(x) for x in p.chunk(subtrees, dim=1)]
    levels = [torch.cat([part[k] for part in parts], dim=1)
              for k in range(len(parts[0]))]
    while levels[-1].shape[1] > 1:          # the top, over the subtrees
        levels.append(_pairs(levels[-1]))
    total = levels[-1][:, 0]
    degenerate = (total <= 0) | ~torch.isfinite(total)
    res = u_roulette * torch.where(degenerate, torch.ones_like(total), total)
    node = torch.zeros(r, dtype=torch.int64, device=p_all.device)
    for lvl in range(len(levels) - 2, -1, -1):
        left = levels[lvl][rows, 2 * node]
        right_first = (2 * node + 1) * (MAX_LANE << lvl)
        go = (res >= left) & (right_first < n)
        res = torch.where(go, res - left, res)
        node = 2 * node + go.to(torch.int64)
    x = p.reshape(r, nl, 32, 4)[rows, node]                    # (R, 32, 4)
    run = [x[..., 0]]
    for m in range(1, 4):
        run.append(run[-1] + x[..., m])
    incl = run[3]
    for off in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[:, :off], incl[:, off:] + incl[:, :-off]],
                         dim=1)
    excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    pref = torch.stack([excl + c for c in run], dim=2)         # (R, 32, 4)
    cnt = (pref <= res[:, None, None]).sum(dim=(1, 2))
    first = node * MAX_LANE
    last = torch.clamp(n - 1 - first, max=MAX_LANE - 1)
    return first + torch.minimum(cnt, last), total, degenerate


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
