"""Time-to-solution statistics (paper Eq. 32). Port of ``repro.core.tts``
(numpy; the same values for the same inputs).

    TTS(p) = t_a · ln(1 − p) / ln(1 − P_a(t_a))

with each run a Bernoulli trial succeeding with probability ``P_a(t_a)``.
Edge cases follow the standard convention (Rønnow et al.): P_a = 0 ⇒ ∞;
P_a ≥ p ⇒ a single run suffices ⇒ TTS = t_a. TTS comes in the unit of
``time_per_run``: steps, or seconds from a measured per-step cost.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TTSResult:
    success_probability: float
    num_runs: int
    num_successes: int
    tts: float              # in the unit of ``time_per_run``
    time_per_run: float
    target_probability: float


def success_probability(best_energies, threshold: float) -> float:
    """Fraction of runs reaching the target (energy ≤ threshold); zero runs
    give 0.0, as :func:`estimate` does."""
    best = np.asarray(best_energies)
    if best.size == 0:
        return 0.0
    return float(np.mean(best <= threshold))


def tts(p_success: float, time_per_run: float, target: float = 0.99) -> float:
    """Eq. 32 with edge cases."""
    if not (0.0 < target < 1.0):
        raise ValueError("target must be in (0, 1)")
    if p_success <= 0.0:
        return math.inf
    if p_success >= target:
        return time_per_run
    return time_per_run * math.log1p(-target) / math.log1p(-p_success)


def estimate(best_energies, threshold: float, time_per_run: float,
             target: float = 0.99) -> TTSResult:
    best = np.asarray(best_energies).reshape(-1)
    hits = int(np.sum(best <= threshold))
    p = hits / best.size if best.size else 0.0
    return TTSResult(
        success_probability=p,
        num_runs=int(best.size),
        num_successes=hits,
        tts=tts(p, time_per_run, target),
        time_per_run=time_per_run,
        target_probability=target,
    )
