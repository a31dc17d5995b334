"""Signed bit-plane representation of the coupling matrix (paper §IV-B1).
Port of ``repro.core.bitplane``.

    J_ij = Σ_{b=0}^{B-1} 2^b (B_b⁺(i,j) − B_b⁻(i,j))            (Eq. 13)

Planes are 1-bit and packed 32 couplers per 32-bit word, LSB-first: bit k of
word w in row i is column 32·w + k. The local-field init uses the
Hamming-weight identities (Eq. 14–16):

    m_P = popcount(P_word)        o_P = popcount(P_word & x_word)
    Σ_{j∈word, B⁺=1} s_j = 2 o_P − m_P     (and analogously for B⁻)

so ``u_i^(J) = Σ_b Σ_w 2^b [(2o_P − m_P) − (2o_N − m_N)]``.

The encoders are the reference's numpy code, so the plane words are
bit-equal to JAX's, padding included. PyTorch's CPU ``uint32`` has no
``<<``, so a packed word is held as an ``int32`` tensor with the same 32
bits (``torch.from_numpy(words.view(np.int32))``), and bit arithmetic runs
on int64 masked to 32 bits. The CUDA kernels read the same memory as
``uint32``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BitPlanes:
    """Packed signed bit-planes of an integer coupling matrix.

    ``pos``/``neg``: (B, N, W) int32 tensors holding the uint32 words, W ≥
    ceil(N / 32); bit ``j % 32`` of word ``j // 32`` in row i of plane b
    holds B_b^±(i, j). J is symmetric, so a row doubles as a column.
    """

    pos: torch.Tensor
    neg: torch.Tensor
    num_spins: int

    @property
    def num_planes(self) -> int:
        return int(self.pos.shape[0])

    @property
    def num_words(self) -> int:
        return int(self.pos.shape[-1])

    @property
    def nbytes(self) -> int:
        return int(self.pos.numel() + self.neg.numel()) * 4

    def to(self, device) -> "BitPlanes":
        return BitPlanes(self.pos.to(device), self.neg.to(device),
                         self.num_spins)

    @classmethod
    def from_numpy(cls, pos: np.ndarray, neg: np.ndarray, num_spins: int,
                   device=None) -> "BitPlanes":
        """Planes from (B, N, W) uint32 word arrays (on the CPU, a writable
        contiguous array is used without a copy)."""
        def words(a):
            a = np.ascontiguousarray(a, dtype=np.uint32)
            if not a.flags.writeable:
                a = a.copy()
            return torch.from_numpy(a.view(np.int32)).to(device)
        return cls(words(pos), words(neg), int(num_spins))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(pos, neg) as uint32 numpy arrays."""
        return (self.pos.cpu().numpy().view(np.uint32),
                self.neg.cpu().numpy().view(np.uint32))


def as_uint32(words: torch.Tensor) -> torch.Tensor:
    """The unsigned value of int32-held words, as int64 in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def as_int32_bits(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors with the same 32 bits."""
    return torch.where(values >= 2 ** 31, values - 2 ** 32,
                       values).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 value in [0, 2^32) (SWAR: PyTorch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _pack_bits(bits: np.ndarray, num_words: int | None = None) -> np.ndarray:
    """Pack a (..., N) {0,1} array into (..., W) uint32, LSB-first, padded
    with zero words up to ``num_words``."""
    n = bits.shape[-1]
    w = -(-n // WORD_BITS)
    if num_words is None:
        num_words = w
    elif num_words < w:
        raise ValueError(f"num_words={num_words} < ceil({n}/32)={w}")
    pad = num_words * WORD_BITS - n
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1)
    words = bits.reshape(bits.shape[:-1] + (-1, WORD_BITS)).astype(np.uint64)
    shifts = (np.uint64(1) << np.arange(WORD_BITS, dtype=np.uint64))
    return (words * shifts).sum(axis=-1).astype(np.uint32)


def encode_couplings(J, num_planes: int, align_words: int = 1,
                     row_range: "tuple[int, int] | None" = None
                     ) -> BitPlanes:
    """Sign-magnitude bit-plane encoding of a symmetric integer matrix
    (Eq. 13). Raises when |J_ij| ≥ 2**num_planes, on non-integer, non-finite
    or asymmetric J; warns on a nonzero diagonal. ``align_words`` rounds W
    up to a multiple with zero words (decoders truncate to N). With
    ``row_range=(lo, hi)`` only rows [lo, hi) are packed: (B, hi-lo, W)
    planes of the N-spin problem (one rank's slab of the sharded tier)."""
    if isinstance(J, torch.Tensor):
        J = J.detach().cpu().numpy()
    J = np.asarray(J)
    if not np.isfinite(J).all():
        i, j = np.argwhere(~np.isfinite(np.atleast_2d(J)))[0]
        raise ValueError(
            f"bit-plane encoding requires finite couplings: "
            f"J[{i}, {j}] = {float(np.atleast_2d(J)[i, j])!r}")
    Ji = np.rint(J).astype(np.int64)
    if not np.array_equal(Ji, J):
        bad = np.argwhere(np.atleast_2d(Ji != J))[0]
        i, j = int(bad[0]), int(bad[1])
        raise ValueError(
            "bit-plane encoding requires integer couplings (pre-scale "
            f"first): J[{i}, {j}] = {float(np.atleast_2d(J)[i, j])!r}")
    if Ji.ndim != 2 or Ji.shape[0] != Ji.shape[1]:
        raise ValueError(f"J must be square, got {Ji.shape}")
    if not np.array_equal(Ji, Ji.T):
        raise ValueError(
            "bit-plane encoding requires a symmetric J: packed planes store "
            "rows that double as columns in the incremental update")
    if np.any(np.diag(Ji) != 0):
        warnings.warn("bit-plane encoding of a J with nonzero diagonal "
                      "(self-couplings); flip updates will fold J_ii into u",
                      stacklevel=2)
    limit = 1 << num_planes
    if np.abs(Ji).max(initial=0) >= limit:
        i, j = np.argwhere(np.abs(Ji) >= limit)[0]
        raise ValueError(
            f"|J|max={np.abs(Ji).max()} needs more than {num_planes} planes "
            f"(first offender J[{i}, {j}] = {Ji[i, j]})")
    if align_words < 1:
        raise ValueError(f"align_words must be >= 1, got {align_words}")
    n = Ji.shape[0]
    w = -(-n // WORD_BITS)
    num_words = -(-w // align_words) * align_words
    if row_range is not None:
        lo, hi = row_range
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"row_range {row_range} out of bounds for N={n}")
        Ji = Ji[lo:hi]
    mag = np.abs(Ji)
    sign_pos = Ji > 0
    sign_neg = Ji < 0
    pos_planes = []
    neg_planes = []
    for b in range(num_planes):
        bit = ((mag >> b) & 1).astype(np.uint8)
        pos_planes.append(_pack_bits(bit * sign_pos, num_words))
        neg_planes.append(_pack_bits(bit * sign_neg, num_words))
    return BitPlanes.from_numpy(np.stack(pos_planes), np.stack(neg_planes), n)


def edge_plane_words(edges, num_planes: int, align_words: int = 1,
                     row_range: "tuple[int, int] | None" = None
                     ) -> "tuple[np.ndarray, np.ndarray]":
    """O(nnz) sparse → packed-plane encoding of (a row slice of) the planes
    of a canonical :class:`repro_torch.core.ising.EdgeList`: numpy uint32
    ``(pos, neg)``, each (B, hi-lo, W). No (N, N) array is made."""
    n = edges.num_spins
    lo_row, hi_row = (0, n) if row_range is None else row_range
    if not 0 <= lo_row <= hi_row <= n:
        raise ValueError(f"row_range {row_range} out of bounds for N={n}")
    limit = 1 << num_planes
    amax = int(np.abs(edges.weights).max(initial=0))
    if amax >= limit:
        k = int(np.argmax(np.abs(edges.weights)))
        raise ValueError(
            f"|J|max={amax} needs more than {num_planes} planes (first "
            f"offender edge #{k} ({int(edges.rows[k])}, "
            f"{int(edges.cols[k])}) with weight {int(edges.weights[k])})")
    if align_words < 1:
        raise ValueError(f"align_words must be >= 1, got {align_words}")
    w_min = -(-n // WORD_BITS)
    num_words = -(-w_min // align_words) * align_words
    # Each canonical (i < j, w) entry sets bit j in row i and bit i in row j.
    r2 = np.concatenate([edges.rows, edges.cols]).astype(np.int64)
    c2 = np.concatenate([edges.cols, edges.rows]).astype(np.int64)
    w2 = np.concatenate([edges.weights, edges.weights])
    if row_range is not None:
        keep = (r2 >= lo_row) & (r2 < hi_row)
        r2, c2, w2 = r2[keep], c2[keep], w2[keep]
    r2 = r2 - lo_row
    word = c2 // WORD_BITS
    bit = (np.uint32(1) << (c2 % WORD_BITS).astype(np.uint32))
    mag = np.abs(w2)
    shape = (num_planes, hi_row - lo_row, num_words)
    pos = np.zeros(shape, np.uint32)
    neg = np.zeros(shape, np.uint32)
    for b in range(num_planes):
        has_bit = ((mag >> b) & 1) == 1
        for plane, sel in ((pos, w2 > 0), (neg, w2 < 0)):
            m = has_bit & sel
            np.bitwise_or.at(plane[b], (r2[m], word[m]), bit[m])
    return pos, neg


def encode_edges(edges, num_planes: int | None = None,
                 align_words: int = 1) -> BitPlanes:
    """Edge list → packed planes in O(nnz), plane-for-plane bit-identical to
    ``encode_couplings(edges.to_dense(), ...)``."""
    if num_planes is None:
        num_planes = max(1, edges.max_abs_weight.bit_length())
    pos, neg = edge_plane_words(edges, num_planes, align_words)
    return BitPlanes.from_numpy(pos, neg, edges.num_spins)


def decode_couplings(planes: BitPlanes) -> np.ndarray:
    """Inverse of :func:`encode_couplings`: the (N, N) int64 matrix."""
    pos, neg = planes.to_numpy()
    n = planes.num_spins
    out = np.zeros((n, n), dtype=np.int64)
    for b in range(planes.num_planes):
        for arr, sgn in ((pos[b], 1), (neg[b], -1)):
            bits = ((arr[..., :, None] >> np.arange(WORD_BITS, dtype=np.uint32))
                    & 1).astype(np.int64)
            bits = bits.reshape(n, -1)[:, :n]
            out += sgn * (1 << b) * bits
    return out


def pack_spins(spins: torch.Tensor, num_words: int | None = None
               ) -> torch.Tensor:
    """±1 spins (..., N) as bits x_j = [s_j > 0] packed LSB-first into
    (..., W) int32-held words, zero-padded up to ``num_words``."""
    x = (spins > 0).to(torch.int64)
    n = x.shape[-1]
    w = -(-n // WORD_BITS)
    if num_words is None:
        num_words = w
    elif num_words < w:
        raise ValueError(f"num_words={num_words} < ceil({n}/32)={w}")
    pad = num_words * WORD_BITS - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    words = x.reshape(x.shape[:-1] + (-1, WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    return as_int32_bits((words << shifts).sum(dim=-1))


def hamming_fields(pos: torch.Tensor, neg: torch.Tensor,
                   spin_words: torch.Tensor) -> torch.Tensor:
    """u^(J)[r, i] = Σ_b 2^b Σ_w [(2o_P − m_P) − (2o_N − m_N)] for (B, N, W)
    planes and (R, W) spin words, one replica at a time so the int64
    temporaries stay (B, N, W). Returns (R, N) float32: exact integers, so
    any summation order gives the same value."""
    num_planes, n, _ = pos.shape
    p = as_uint32(pos)
    q = as_uint32(neg)
    m = popcount32(p).sum(-1) - popcount32(q).sum(-1)
    weights = 2.0 ** torch.arange(num_planes, dtype=torch.float32,
                                  device=pos.device)
    rows = []
    for words in spin_words:
        x = as_uint32(words)
        o = popcount32(p & x).sum(-1) - popcount32(q & x).sum(-1)
        rows.append(torch.tensordot(weights, (2 * o - m).to(torch.float32),
                                    dims=([0], [0])))
    if not rows:
        return torch.zeros((0, n), dtype=torch.float32, device=pos.device)
    return torch.stack(rows)


def local_fields_from_planes(planes: BitPlanes,
                             spins: torch.Tensor) -> torch.Tensor:
    """u_i^(J) from packed planes via Hamming-weight accumulation
    (Eq. 14–16). ``spins`` (..., N) ±1; returns (..., N) float32, the exact
    integer for integer J."""
    xw = pack_spins(spins, planes.num_words)
    flat = xw.reshape(-1, xw.shape[-1])
    out = hamming_fields(planes.pos, planes.neg, flat)
    return out.reshape(xw.shape[:-1] + (planes.num_spins,))
