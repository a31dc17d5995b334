"""The parity contract of the roulette paths, shared by the tests and
``chip_smoke.py``.

RSA with the PWL table and integer J is bit-exact everywhere. The RWA
roulette adds its block and lane sums in another order in each
implementation, so two implementations may pick different sites when the
roulette radius lies within a rounding error of a cumulative boundary. Such
a step is a near tie; every other step must agree exactly.
"""
from __future__ import annotations

import torch

#: A step is a near tie when the radius lies within this fraction of the
#: total weight W of a cumulative boundary (or, uniformized, u·N of W).
NEAR_TIE_REL = 1e-5


def roulette_near_tie(p_all: torch.Tensor, u_roulette: torch.Tensor,
                      u_uniformize: torch.Tensor, uniformized: bool,
                      rel: float = NEAR_TIE_REL) -> torch.Tensor:
    """(R,) bool: steps whose pick (or uniformized accept) can depend on the
    order of the float sums. Boundaries are recomputed in float64 from the
    f32 weights ``p_all`` (R, N)."""
    p = p_all.to(torch.float64)
    cum = torch.cumsum(p, dim=1)
    total = cum[:, -1]
    radius = u_roulette.to(torch.float64) * total
    gap = (cum - radius[:, None]).abs().min(dim=1).values
    tie = (total > 0) & (gap < rel * total)
    if uniformized:
        n = p.shape[1]
        accept_gap = (u_uniformize.to(torch.float64) * n - total).abs()
        tie |= (total > 0) & (accept_gap < rel * total)
    return tie
