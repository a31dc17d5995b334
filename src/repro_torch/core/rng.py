"""Stateless counter-based RNG, bit-exact with ``jax.random`` (paper §IV-B3d).

Port of ``repro.core.rng``. JAX's default generator is threefry2x32 with
``jax_threefry_partitionable=True``; this module reimplements it on int64
tensors holding uint32 values (masked after every add and shift, because
PyTorch's CPU ``uint32`` has no ``<<``), so every key, bit and uniform equals
JAX's for the same seed. A key is an int64 tensor whose last axis holds the
two 32-bit words; leading axes batch independent keys.
"""
from __future__ import annotations

from enum import IntEnum

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


class Salt(IntEnum):
    """Purpose-specific salts (the same values as ``repro.core.rng.Salt``)."""

    SITE = 0
    ACCEPT = 1
    ROULETTE = 2
    UNIFORMIZE = 3
    INIT = 4
    REPLICA = 5
    PROBLEM = 6
    SWEEP = 7


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on uint32 values held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, rot) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: the words ``(seed >> 32, seed & 0xFFFFFFFF)``
    (JAX without x64 takes 32-bit seeds; the solve passes its seed through
    :func:`fold_in`, as a uint32)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def from_words(hi: int, lo: int, device=None) -> torch.Tensor:
    """The key whose two 32-bit words are ``(hi, lo)``."""
    return torch.tensor([hi & MASK32, lo & MASK32], dtype=torch.int64,
                        device=device)


def words(key: torch.Tensor) -> tuple:
    """The two words of one key as Python ints (a device read if the key
    lies on the card)."""
    hi, lo = key.tolist()
    return int(hi), int(lo)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the count pair ``(0, data)`` under ``key``.

    ``data`` is an int or an integer tensor (taken modulo 2**32, as JAX's
    uint32 cast does); the result has shape ``broadcast(key[..., 0], data)
    + (2,)``.
    """
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def stream(key: torch.Tensor, *indices) -> torch.Tensor:
    """Pure function (seed, i0, i1, ...) -> key, as ``repro.core.rng.stream``."""
    for ix in indices:
        key = fold_in(key, ix)
    return key


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable threefry).

    A batch of keys ``(..., 2)`` gives ``(...) + shape`` bits, one independent
    draw per key. Values are uint32 held in int64.
    """
    shape = tuple(shape)
    count = 1
    for d in shape:
        count *= d
    counts = torch.arange(count, dtype=torch.int64, device=key.device)
    counts = counts.reshape(shape)
    batch = key.shape[:-1]
    view = batch + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return o1 ^ o2


def uniform01(key: torch.Tensor, shape=()) -> torch.Tensor:
    """Uniform f32 in [0, 1] as ``uint32 → f32 · 2⁻³²`` (``repro`` Eq. 26)."""
    return bits(key, shape).to(torch.float32) * (2.0 ** -32)


def index_from_uniform(u01: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical ``u ∈ [0,1) → site index`` rescaling (paper Eq. 22)."""
    j = (u01.to(torch.float32) * float(n)).to(torch.int32)
    return torch.clamp(j, max=n - 1)


#: Largest N for which :func:`uniform_index` uses the float rescaling of
#: :func:`index_from_uniform` (the sweep's site pick).
FLOAT_INDEX_MAX_N = 4096


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable threefry): key i of the split is
    the hash of the count pair ``(0, i)``, the same as ``fold_in(key, i)``.
    A ``(..., 2)`` key gives ``(..., num, 2)``."""
    return fold_in(key[..., None, :],
                   torch.arange(num, dtype=torch.int64, device=key.device))


def randint(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, n, int32)`` for 0 < n < 2**31: two
    32-bit draws from the two halves of :func:`split`, combined modulo n in
    uint32 arithmetic (JAX's ``_randint``; its products wrap at 2**32)."""
    halves = split(key)
    higher = bits(halves[..., 0, :], ())
    lower = bits(halves[..., 1, :], ())
    multiplier = (1 << 16) % n
    multiplier = ((multiplier * multiplier) & MASK32) % n
    offset = (((higher % n) * multiplier) & MASK32) + lower % n
    return (offset & MASK32) % n


def uniform_index(key: torch.Tensor, n: int) -> torch.Tensor:
    """Uniform site index in [0, n) per key, as int64, equal to
    ``repro.core.rng.uniform_index``: the float rescaling up to
    :data:`FLOAT_INDEX_MAX_N`, the exact fixed point ``floor(u·n/2³²)`` up
    to 2¹⁶, then :func:`randint`."""
    if n <= FLOAT_INDEX_MAX_N:
        return index_from_uniform(uniform01(key), n).to(torch.int64)
    if n <= 1 << 16:
        u = bits(key, ())
        hi = u >> 16
        lo = u & 0xFFFF
        return (hi * n + ((lo * n) >> 16)) >> 16
    return randint(key, n)


def bernoulli_half(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, 0.5, shape)``: JAX's float32 uniform built
    from the top 23 bits (``bits >> 9 | 0x3F800000`` viewed as f32, minus 1)
    compared against 0.5."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0) < 0.5
