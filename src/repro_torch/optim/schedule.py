"""Learning-rate schedules for the train loop (port of
``repro.optim.schedule``).

Each schedule is a function of the step, an int or an integer tensor, and
returns a float32 tensor on the step's device (the CPU for an int),
computed op by op in float32 as the JAX functions compute it.
"""
from __future__ import annotations

import math

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def cosine_lr(base_lr: float, total_steps: int, min_ratio: float = 0.1):
    def lr(step):
        step = _as_step(step)
        frac = torch.clamp(step.float() / _f32(max(total_steps, 1), step),
                           max=1.0)
        cos = _f32(0.5, step) * (1.0 + torch.cos(_f32(math.pi, step) * frac))
        return _f32(base_lr, step) * (_f32(min_ratio, step)
                                      + _f32(1 - min_ratio, step) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_ratio: float = 0.1):
    decay = cosine_lr(base_lr, max(total_steps - warmup_steps, 1), min_ratio)

    def lr(step):
        step = _as_step(step)
        warm = (_f32(base_lr, step) * step.float()
                / _f32(max(warmup_steps, 1), step))
        return torch.where(step < warmup_steps, warm,
                           decay(step - warmup_steps))

    return lr
