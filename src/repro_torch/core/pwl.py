"""Piecewise-linear flip probability (paper §IV-B3a). Port of
``repro.core.pwl``.

Uniform knots on ``[-z_max, z_max]``, the exact logistic at the knots
(computed in float64, stored as f32) and f32 slopes between them: the
sweeps' ``(S+1, 3)`` table (:func:`pwl_table`) and the reference engine's
sigmoid and flip probabilities (:func:`make_pwl_sigmoid`,
:func:`make_flip_probability`).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _pwl_arrays(num_segments: int, z_max: float):
    """(knots (S+1,), values (S+1,), slopes (S,)) as f32 numpy arrays."""
    knots = np.linspace(-z_max, z_max, num_segments + 1).astype(np.float32)
    values = (1.0 / (1.0 + np.exp(-knots.astype(np.float64)))).astype(np.float32)
    slopes = (np.diff(values) / np.diff(knots)).astype(np.float32)
    return knots, values, slopes


def pwl_table(num_segments: int = 64, z_max: float = 8.0,
              device=None) -> torch.Tensor:
    """The ``(S+1, 3)`` f32 ``[knot, value, slope]`` table (last slope 0)."""
    knots, values, slopes = _pwl_arrays(num_segments, z_max)
    table = np.stack([knots, values,
                      np.append(slopes, 0.0).astype(np.float32)], axis=1)
    return torch.from_numpy(table).to(device)


#: ``(delta_e, temperature) -> p``: the flip probability of every engine.
FlipProbFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_pwl_sigmoid(num_segments: int = 64,
                     z_max: float = 8.0) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """σ(x) ≈ the LUT with ``num_segments`` uniform linear pieces on
    [-z_max, z_max], in the reference's gather form ``values[seg] +
    slopes[seg]·(x − knots[seg])``, ``seg = floor((x + z_max)/step)``.
    Under ``jit`` XLA contracts that multiply-add into one FMA and divides
    by the constant step as a product with its f32 reciprocal; the port
    does both (``kernels.common.fma``), so it is bitwise equal to the
    jitted reference."""
    from ..kernels.common import fma

    knots, values, slopes = _pwl_arrays(num_segments, z_max)
    lo = float(values[0])
    hi = float(values[-1])
    # XLA folds the division by the constant knot spacing into a product
    # with its f32 reciprocal; so does the port.
    inv_step = float(np.float32(1.0) / (knots[1] - knots[0]))
    tables = {}   # device -> the three arrays as tensors, copied once

    def pwl(x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if x.device not in tables:
            tables[x.device] = tuple(torch.from_numpy(a).to(x.device)
                                     for a in (knots, values, slopes))
        seg = torch.floor((x + z_max) * inv_step).to(torch.int32)
        seg = torch.clamp(seg, 0, num_segments - 1).to(torch.int64)
        kn, va, sl = (a[seg] for a in tables[x.device])
        y = fma(sl, x - kn, va)
        y = torch.where(x <= -z_max, lo, y)
        return torch.where(x >= z_max, hi, y)

    return pwl


def _greedy_flip_probability(delta_e: torch.Tensor) -> torch.Tensor:
    """T → 0⁺ limit: p=1 downhill, 0.5 flat, 0 uphill."""
    return torch.where(delta_e < 0, 1.0,
                       torch.where(delta_e == 0, 0.5, 0.0)).to(torch.float32)


def make_flip_probability(sigmoid_fn: Optional[Callable] = None) -> FlipProbFn:
    """``P_flip(ΔE, T) = σ(−ΔE/T)`` (paper Eq. 2) with T ≤ 0 taken greedily.
    ``sigmoid_fn=None`` is the exact ``torch.sigmoid`` (within a few ulp of
    ``jax.nn.sigmoid``); pass :func:`make_pwl_sigmoid` for the LUT."""
    sig = torch.sigmoid if sigmoid_fn is None else sigmoid_fn

    def flip_probability(delta_e: torch.Tensor,
                         temperature) -> torch.Tensor:
        de = delta_e.to(torch.float32)
        t = torch.as_tensor(temperature, dtype=torch.float32,
                            device=de.device)
        safe_t = torch.where(t > 0, t, torch.ones_like(t))
        warm = sig(-de / safe_t)
        return torch.where(t > 0, warm,
                           _greedy_flip_probability(de)).to(torch.float32)

    return flip_probability


exact_flip_probability: FlipProbFn = make_flip_probability(None)
pwl_flip_probability: FlipProbFn = make_flip_probability(make_pwl_sigmoid())


def pwl_error_bound(num_segments: int, z_max: float) -> float:
    """Interpolation-error bound max|σ''|·h²/8, max|σ''| ≈ 0.09623."""
    h = 2.0 * z_max / num_segments
    return 0.09623 * h * h / 8.0
