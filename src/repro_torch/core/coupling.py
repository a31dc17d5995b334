"""Coupling-store format names (port of ``repro.core.coupling``'s registry).

This slice serves the ``"dense"`` tier only: J as an (N, N) f32 tensor in
device memory, one row read per replica per step by the sweep kernel. The
TPU's VMEM thresholds do not carry over. The port's dense ceiling follows
from the sweep kernel's shared-memory budget (u, s and best_s of one replica
in one thread block's shared memory): see
``repro_torch.kernels.sweep.dense_max_n``.
"""
from __future__ import annotations

from typing import Optional

#: Every tier the JAX package knows, in its registry order.
FORMATS = ("dense", "bitplane", "bitplane_hbm", "bitplane_sharded",
           "bitplane_sharded_2d")
COUPLING_FORMATS = ("auto",) + FORMATS
#: Tiers this port serves so far.
SERVED_FORMATS = ("dense",)


def resolve_format(fmt: Optional[str]) -> str:
    """Resolve the ``coupling_format`` knob. "auto" is "dense" in this slice
    (the JAX package picks a plane tier only past its VMEM wall; the plane
    tiers are not ported yet). An explicit plane tier raises."""
    if fmt in (None, "auto"):
        return "dense"
    if fmt not in FORMATS:
        raise ValueError(
            f"coupling format must be one of {COUPLING_FORMATS}, got {fmt!r}")
    if fmt not in SERVED_FORMATS:
        raise NotImplementedError(
            f"coupling_format={fmt!r} is not ported yet (ROADMAP queue 2 "
            "items 3-5: the bit-plane tiers and bitplane_field_init; the "
            "sharded tiers are queue 1 item 12)")
    return fmt
