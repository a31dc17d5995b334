"""Ising problems and Hamiltonian (paper §II-B), dense couplings only.

Port of the dense half of ``repro.core.ising``:
``H(s) = -1/2 sᵀ J s - hᵀ s`` with symmetric, zero-diagonal J, local field
``u = J s + h`` and flip cost ``ΔE_i = 2 s_i u_i``. Spins are int8 at rest
and f32 inside the fused sweep state. Edge-list problems are a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SPIN_DTYPE = torch.int8


@dataclasses.dataclass(frozen=True)
class IsingProblem:
    """An Ising instance: dense symmetric ``couplings`` (N, N) f32 with zero
    diagonal, ``fields`` (N,) f32 and a constant energy ``offset``."""

    couplings: torch.Tensor
    fields: torch.Tensor
    offset: float = 0.0

    @property
    def num_spins(self) -> int:
        return int(self.couplings.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.couplings.device

    def to(self, device) -> "IsingProblem":
        return IsingProblem(self.couplings.to(device), self.fields.to(device),
                            self.offset)

    @staticmethod
    def validate(J: np.ndarray, h: np.ndarray) -> None:
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise ValueError(f"J must be square, got {J.shape}")
        if h.shape != (J.shape[0],):
            raise ValueError(f"h shape {h.shape} incompatible with J {J.shape}")
        if not np.isfinite(J).all():
            i, j = np.argwhere(~np.isfinite(J))[0]
            raise ValueError(
                f"J must be finite: J[{i}, {j}] = {float(J[i, j])!r}")
        if not np.isfinite(h).all():
            (i,) = np.argwhere(~np.isfinite(h))[0]
            raise ValueError(f"h must be finite: h[{i}] = {float(h[i])!r}")
        if not np.allclose(J, J.T):
            raise ValueError("J must be symmetric")
        if not np.allclose(np.diag(J), 0.0):
            raise ValueError("J must have zero diagonal")

    @classmethod
    def create(cls, J, h=None, offset: float = 0.0, check: bool = True,
               device=None) -> "IsingProblem":
        """Build from array-likes; the tensors are placed on ``device``
        (default: the CPU, where numpy input lives)."""
        J = np.asarray(J, dtype=np.float32)
        if h is None:
            h = np.zeros(J.shape[0], dtype=np.float32)
        h = np.asarray(h, dtype=np.float32)
        if check:
            cls.validate(J, h)
        return cls(couplings=torch.from_numpy(J.copy()).to(device),
                   fields=torch.from_numpy(h.copy()).to(device),
                   offset=float(offset))

    @classmethod
    def create_sparse(cls, *args, **kwargs):
        raise NotImplementedError(
            "edge-list problems are not ported yet (ROADMAP queue 1 item 2: "
            "EdgeList / IsingProblem.create_sparse)")


def energy(problem: IsingProblem, spins: torch.Tensor) -> torch.Tensor:
    """H(s); ``spins`` is (..., N) in {-1,+1}. Returns (...,) f32."""
    s = spins.to(torch.float32)
    Js = torch.einsum("ij,...j->...i", problem.couplings, s)
    pair = -0.5 * torch.einsum("...i,...i->...", s, Js)
    field = -torch.einsum("i,...i->...", problem.fields, s)
    return pair + field


def local_fields(problem: IsingProblem, spins: torch.Tensor) -> torch.Tensor:
    """u_i = h_i + Σ_j J_ij s_j, computed from scratch (paper Eq. 11)."""
    s = spins.to(torch.float32)
    return torch.einsum("ij,...j->...i", problem.couplings, s) + problem.fields


def energy_from_fields(u_j: torch.Tensor, spins: torch.Tensor,
                       fields: torch.Tensor) -> torch.Tensor:
    """H(s) from precomputed pairwise local fields ``u^J = J s`` (the same
    contractions as :func:`energy`)."""
    s = spins.to(torch.float32)
    pair = -0.5 * torch.einsum("...i,...i->...", s, u_j.to(torch.float32))
    field = -torch.einsum("i,...i->...", fields, s)
    return pair + field


def random_spins(key: torch.Tensor, shape) -> torch.Tensor:
    """Uniform random ±1 spins from ``key`` (a batch of keys gives a batch of
    configurations), equal to ``repro.core.ising.random_spins``."""
    from . import rng

    up = rng.bernoulli_half(key, shape)
    return torch.where(up, 1, -1).to(SPIN_DTYPE)
