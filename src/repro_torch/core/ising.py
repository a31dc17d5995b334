"""Ising problems and Hamiltonian (paper §II-B). Port of ``repro.core.ising``.

``H(s) = -1/2 sᵀ J s - hᵀ s`` with symmetric, zero-diagonal J, local field
``u = J s + h`` and flip cost ``ΔE_i = 2 s_i u_i``. Spins are int8 at rest
and f32 inside the fused sweep state. J is a dense (N, N) tensor or a
canonical :class:`EdgeList`: the dense-J-free form, which only the
plane-backed solve path consumes.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Optional

import numpy as np
import torch

SPIN_DTYPE = torch.int8


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeList:
    """Canonical sparse (COO) couplings, each undirected edge once.

    ``rows[k] < cols[k]`` (int32), integer ``weights`` (int64, never zero),
    sorted lexicographically. :meth:`create` symmetric-canonicalizes
    (``(i, j)`` and ``(j, i)`` name one edge), sums duplicates, drops
    exact-zero sums and refuses self-loops, non-integer and non-finite
    weights. The dense equivalent is ``J[i, j] = J[j, i] = w``. Host-side
    numpy; equality and hashing go by content.
    """

    rows: np.ndarray     # (nnz,) int32, rows[k] < cols[k]
    cols: np.ndarray     # (nnz,) int32
    weights: np.ndarray  # (nnz,) int64, never zero
    num_spins: int

    @classmethod
    def create(cls, rows, cols, weights, num_spins: int) -> "EdgeList":
        """Canonicalize a raw COO triple (see the class docstring)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        w = np.asarray(weights)
        if rows.ndim != 1 or rows.shape != cols.shape or rows.shape != w.shape:
            raise ValueError(
                f"edge arrays must be equal-length 1-D, got rows {rows.shape} "
                f"cols {cols.shape} weights {w.shape}")
        n = int(num_spins)
        if n <= 0:
            raise ValueError(f"num_spins must be positive, got {num_spins}")
        ri = rows.astype(np.int64)
        ci = cols.astype(np.int64)
        if not (np.array_equal(ri, rows) and np.array_equal(ci, cols)):
            raise ValueError("edge endpoints must be integers")
        if rows.size and (ri.min() < 0 or ci.min() < 0
                          or ri.max() >= n or ci.max() >= n):
            raise ValueError(f"edge endpoints out of range for N={n}")
        if np.any(ri == ci):
            raise ValueError("self-loop edges (i == i) are not representable "
                             "couplings; drop the diagonal before ingestion")
        wf = w.astype(np.float64)
        bad = np.flatnonzero(~np.isfinite(wf))
        if bad.size:
            k = int(bad[0])
            raise ValueError(
                f"edge weights must be finite: edge #{k} "
                f"({int(ri[k])}, {int(ci[k])}) has weight {float(w[k])!r}"
                + (f" (+{bad.size - 1} more non-finite)" if bad.size > 1
                   else ""))
        wi = np.rint(wf).astype(np.int64)
        bad = np.flatnonzero(wi != wf)
        if bad.size:
            k = int(bad[0])
            raise ValueError(
                "edge-list ingestion requires integer weights (pre-scale "
                f"first): edge #{k} ({int(ri[k])}, {int(ci[k])}) has weight "
                f"{float(w[k])!r}")
        lo = np.minimum(ri, ci)
        hi = np.maximum(ri, ci)
        order = np.lexsort((hi, lo))
        lo, hi, wi = lo[order], hi[order], wi[order]
        if lo.size:
            first = np.ones(lo.size, bool)
            first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
            starts = np.flatnonzero(first)
            wi = np.add.reduceat(wi, starts)
            lo, hi = lo[starts], hi[starts]
            keep = wi != 0
            lo, hi, wi = lo[keep], hi[keep], wi[keep]
        return cls(rows=lo.astype(np.int32), cols=hi.astype(np.int32),
                   weights=wi, num_spins=n)

    @classmethod
    def from_dense(cls, J) -> "EdgeList":
        """Upper-triangle nonzeros of a symmetric zero-diagonal matrix."""
        if isinstance(J, torch.Tensor):
            J = J.detach().cpu().numpy()
        J = np.asarray(J)
        if J.ndim != 2 or J.shape[0] != J.shape[1]:
            raise ValueError(f"J must be square, got {J.shape}")
        if not np.array_equal(J, J.T):
            raise ValueError("J must be symmetric")
        if np.any(np.diag(J) != 0):
            raise ValueError("J must have zero diagonal")
        r, c = np.nonzero(np.triu(J, 1))
        return cls.create(r, c, J[r, c], J.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def max_abs_weight(self) -> int:
        return int(np.abs(self.weights).max(initial=0))

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes + self.cols.nbytes + self.weights.nbytes)

    def negated(self) -> "EdgeList":
        """The edge list of −J (the Max-Cut w → J = −w mapping)."""
        return EdgeList(rows=self.rows, cols=self.cols,
                        weights=-self.weights, num_spins=self.num_spins)

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        """Materialize the (N, N) matrix: O(N²), tests and small N only."""
        J = np.zeros((self.num_spins, self.num_spins), dtype)
        J[self.rows, self.cols] = self.weights
        J[self.cols, self.rows] = self.weights
        return J

    @cached_property
    def _digest(self) -> bytes:
        h = hashlib.sha256()
        h.update(str(self.num_spins).encode())
        for a in (self.rows, self.cols, self.weights):
            h.update(a.tobytes())
        return h.digest()

    def __eq__(self, other) -> bool:
        return (isinstance(other, EdgeList)
                and self.num_spins == other.num_spins
                and self._digest == other._digest)

    def __hash__(self) -> int:
        return hash((self.num_spins, self._digest))


@dataclasses.dataclass(frozen=True)
class IsingProblem:
    """An Ising instance: symmetric zero-diagonal couplings, ``fields`` (N,)
    f32 and a constant energy ``offset``. The couplings are a dense (N, N)
    f32 tensor, or ``couplings=None`` with a canonical :class:`EdgeList` in
    ``edges``; the dense helpers below then raise."""

    couplings: Optional[torch.Tensor]
    fields: torch.Tensor
    offset: float = 0.0
    edges: Optional[EdgeList] = None

    @property
    def num_spins(self) -> int:
        if self.couplings is not None:
            return int(self.couplings.shape[-1])
        return self.edges.num_spins

    @property
    def device(self) -> torch.device:
        return self.fields.device

    @property
    def coupling_source(self):
        """What ``core.coupling.CouplingStore.build`` consumes: the edge list
        of a dense-J-free problem, else the dense J."""
        return self.edges if self.couplings is None else self.couplings

    def to(self, device) -> "IsingProblem":
        J = None if self.couplings is None else self.couplings.to(device)
        return IsingProblem(J, self.fields.to(device), self.offset,
                            self.edges)

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
    def create_sparse(cls, edges: EdgeList, h=None, offset: float = 0.0,
                      device=None) -> "IsingProblem":
        """Dense-J-free instance from a canonical :class:`EdgeList`: no
        (N, N) matrix is made, here or on the plane-backed solve path."""
        if not isinstance(edges, EdgeList):
            raise TypeError(f"create_sparse needs an EdgeList, got "
                            f"{type(edges).__name__} (EdgeList.create "
                            "canonicalizes raw COO arrays)")
        n = edges.num_spins
        if h is None:
            h = np.zeros(n, dtype=np.float32)
        h = np.asarray(h, dtype=np.float32)
        if h.shape != (n,):
            raise ValueError(f"h shape {h.shape} incompatible with N={n}")
        return cls(couplings=None, fields=torch.from_numpy(h.copy()).to(device),
                   offset=float(offset), edges=edges)


def _require_dense(problem: IsingProblem, what: str) -> torch.Tensor:
    if problem.couplings is None:
        raise ValueError(
            f"{what} needs the dense (N, N) couplings, but this problem is "
            "edge-list-backed (dense-J-free). Use the plane-backed path "
            "(backend='fused' with a bit-plane coupling_format) or "
            "materialize explicitly via problem.edges.to_dense() for small N.")
    return problem.couplings


def energy(problem: IsingProblem, spins: torch.Tensor) -> torch.Tensor:
    """H(s); ``spins`` is (..., N) in {-1,+1}. Returns (...,) f32."""
    _require_dense(problem, "ising.energy")
    s = spins.to(torch.float32)
    Js = torch.einsum("ij,...j->...i", problem.couplings, s)
    pair = -0.5 * torch.einsum("...i,...i->...", s, Js)
    field = -torch.einsum("i,...i->...", problem.fields, s)
    return pair + field


def local_fields(problem: IsingProblem, spins: torch.Tensor) -> torch.Tensor:
    """u_i = h_i + Σ_j J_ij s_j, computed from scratch (paper Eq. 11)."""
    _require_dense(problem, "ising.local_fields")
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


def delta_energies(problem: IsingProblem, spins: torch.Tensor,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ΔE_i = 2 s_i u_i for every candidate single-spin flip (paper Eq. 2)."""
    if u is None:
        u = local_fields(problem, spins)
    return 2.0 * spins.to(torch.float32) * u


def incremental_field_update(J: torch.Tensor, u: torch.Tensor,
                             j: torch.Tensor,
                             s_old_j: torch.Tensor) -> torch.Tensor:
    """u'_i = u_i − 2 J_ij s_j_old after flipping spin j (paper Eq. 12/17):
    Θ(N) instead of a Θ(N²) recompute. ``j`` and ``s_old_j`` carry the
    leading axes of ``u`` (one flip per chain); J is symmetric, so row j
    is column j."""
    row = J[j.to(torch.int64)]
    return u - 2.0 * row * s_old_j.to(u.dtype)[..., None]


def random_spins(key: torch.Tensor, shape) -> torch.Tensor:
    """Uniform random ±1 spins from ``key`` (a batch of keys gives a batch of
    configurations), equal to ``repro.core.ising.random_spins``."""
    from . import rng

    up = rng.bernoulli_half(key, shape)
    return torch.where(up, 1, -1).to(SPIN_DTYPE)


def brute_force_ground_state(problem: IsingProblem):
    """Exhaustive ground-state search (tests only; N ≤ 24). Returns
    ``(energy + offset, spins (N,) int8 numpy, all energies + offset)``."""
    n = problem.num_spins
    if n > 24:
        raise ValueError("brute force limited to N<=24")
    J = _require_dense(problem, "brute_force_ground_state").to(torch.float32)
    idx = torch.arange(2 ** n, device=J.device)
    bits = (idx[:, None] >> torch.arange(n, device=J.device)[None, :]) & 1
    spins = (2 * bits - 1).to(torch.float32)
    Js = spins @ J
    e = (-0.5 * torch.einsum("ki,ki->k", spins, Js)
         - spins @ problem.fields.to(torch.float32))
    k = int(torch.argmin(e))
    return (float(e[k]) + problem.offset,
            spins[k].to(SPIN_DTYPE).cpu().numpy(),
            e.cpu().numpy() + problem.offset)
