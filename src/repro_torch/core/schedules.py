"""Annealing temperature schedules (paper §II-C, Alg. 1, Fig. 15).

Port of ``repro.core.schedules``: ``Schedule(t)`` maps integer steps to f32
temperatures with JAX's float32 arithmetic. ``linear`` and ``constant`` match
JAX bitwise; ``geometric`` goes through ``torch.pow``, which differs from
XLA's ``pow`` by up to 2 ulp on some steps, and ``cosine`` through
``torch.cos``.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str  # "linear" | "geometric" | "cosine" | "constant"
    t0: float
    t1: float
    steps: int

    def __call__(self, t) -> torch.Tensor:
        t = torch.as_tensor(t)
        frac = torch.clamp(t.to(torch.float32) / float(max(self.steps - 1, 1)),
                           max=1.0)
        if self.kind == "linear":
            return self.t0 + (self.t1 - self.t0) * frac
        if self.kind == "geometric":
            lo = max(self.t1, 1e-12)
            ratio = lo / max(self.t0, 1e-12)
            base = torch.tensor(ratio, dtype=torch.float32, device=frac.device)
            return (torch.tensor(self.t0, dtype=torch.float32,
                                 device=frac.device) * torch.pow(base, frac))
        if self.kind == "cosine":
            return self.t1 + 0.5 * (self.t0 - self.t1) * (
                1.0 + torch.cos(torch.tensor(math.pi, dtype=torch.float32)
                                * frac))
        if self.kind == "constant":
            return torch.full_like(frac, self.t0)
        raise ValueError(f"unknown schedule kind {self.kind!r}")


def linear(t0: float, t1: float, steps: int) -> Schedule:
    return Schedule("linear", t0, t1, steps)


def geometric(t0: float, t1: float, steps: int) -> Schedule:
    return Schedule("geometric", t0, t1, steps)


def cosine(t0: float, t1: float, steps: int) -> Schedule:
    return Schedule("cosine", t0, t1, steps)


def constant(t: float, steps: int = 1) -> Schedule:
    return Schedule("constant", t, t, steps)
