"""What every CUDA wrapper shares: operand checks and a launch count."""
from __future__ import annotations

import torch


class LaunchCounter:
    """A plain integer count that a wrapper bumps once per kernel launch, so
    a run can show which kernels it went through."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0

    def __repr__(self) -> str:
        return f"LaunchCounter({self.name!r}, count={self.count})"


def check_operands(device: torch.device, operands,
                   dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every ``(name, tensor, shape)`` is a contiguous tensor of
    ``dtype`` and that shape on ``device`` — all a kernel takes."""
    for name, x, shape in operands:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got "
                             f"{x.dtype} (contiguous={x.is_contiguous()})")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
