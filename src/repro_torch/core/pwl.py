"""Piecewise-linear flip-probability table (paper §IV-B3a).

Port of ``repro.core.pwl.pwl_table`` and its numpy construction: uniform
knots on ``[-z_max, z_max]``, the exact logistic at the knots (computed in
float64, stored as f32) and f32 slopes between them.
"""
from __future__ import annotations

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
