"""Greedy 1-opt post-processing. Port of ``repro.core.refine``.

After annealing, repeatedly flip the single spin with the most negative
ΔE = 2 s_i u_i until no improving flip exists: a deterministic descent of
Θ(N) per flip with the incremental local-field update of Eq. 12. It never
lowers the cut.
"""
from __future__ import annotations

import torch

from . import ising

#: ΔE below which a flip counts as improving (the JAX package's).
IMPROVING = -1e-6


def greedy_descent(problem: ising.IsingProblem, spins: torch.Tensor,
                   max_flips: int = 512):
    """spins: (..., N) ±1 on the problem's device. Returns ``(refined
    spins, refined energy incl. offset)``.

    Every chain of the flattened batch descends at once: each pass flips,
    in every chain still improving, its spin of least ΔE (``torch.argmin``
    takes the first minimum, as ``jnp.argmin`` does), and a chain stops at
    its first pass without an improving flip or after ``max_flips`` passes,
    as the JAX ``while_loop`` under ``vmap`` does. On integer J every value
    is an exact integer, so the result is bitwise the JAX one."""
    J = problem.couplings
    shape = spins.shape
    s = spins.reshape(-1, shape[-1]).clone()
    u = ising.local_fields(problem, s)
    e = ising.energy(problem, s)
    rows = torch.arange(s.shape[0], device=s.device)
    live = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for _ in range(max_flips):
        de = 2.0 * s.to(torch.float32) * u
        j = torch.argmin(de, dim=-1)
        de_j = de[rows, j]
        live = live & (de_j < IMPROVING)
        if not bool(live.any()):
            break
        s_old = s[rows, j]
        s[rows, j] = torch.where(live, -s_old, s_old)
        u = torch.where(live[:, None],
                        u - 2.0 * J[j] * s_old.to(u.dtype)[:, None], u)
        e = torch.where(live, e + de_j, e)
    return s.reshape(shape), e.reshape(shape[:-1]) + problem.offset
