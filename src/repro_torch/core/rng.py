"""Stateless counter-based RNG, bit-exact with ``jax.random`` (paper §IV-B3d).

Port of ``repro.core.rng``. JAX's default generator is threefry2x32 with
``jax_threefry_partitionable=True``; this module reimplements it on int64
tensors holding uint32 values (masked after every add and shift, because
PyTorch's CPU ``uint32`` has no ``<<``), so every key, bit and uniform equals
JAX's for the same seed. A key is an int64 tensor whose last axis holds the
two 32-bit words; leading axes batch independent keys.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# Distributions of jax.random (the data pipeline's draws)
# ---------------------------------------------------------------------------

#: Elements of one slice of a large draw: the counters are an iota over the
#: shape, so a draw made a row slice at a time equals the whole draw.
DRAW_SLICE = 1 << 26

_F32_TINY = torch.finfo(torch.float32).tiny


def _s32(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x &= MASK32
    return x - (1 << 32) if x >= 1 << 31 else x


def _rotl_i32(x: torch.Tensor, d: int) -> torch.Tensor:
    # >> is arithmetic on int32: keep the d bits that wrap around.
    return (x << d).bitwise_or_((x >> (32 - d)).bitwise_and_((1 << d) - 1))


def _threefry_i32(k1: int, k2: int, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """:func:`threefry2x32` on int32 tensors holding uint32 bits (adds wrap
    modulo 2**32), for one key given as two ints; returns ``o1 ^ o2``.
    Half the bytes of the int64 form and no masking: the big draws use
    it. ``x1`` and ``x2`` are overwritten."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ _KS_PARITY) & MASK32)
    x1.add_(_s32(ks[0]))
    x2.add_(_s32(ks[1]))
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x1.add_(x2)
            x2 = _rotl_i32(x2, rot).bitwise_xor_(x1)
        x1.add_(_s32(ks[(i + 1) % 3]))
        x2.add_(_s32(ks[(i + 2) % 3] + i + 1))
    return x1.bitwise_xor_(x2)


def counter_bits(key: torch.Tensor, start: int, count: int,
                 device=None) -> torch.Tensor:
    """The 32-bit draws of flat counters ``start .. start + count`` under
    one key (JAX's partitionable threefry: counter i hashes the words
    ``(i >> 32, i & 0xFFFFFFFF)``), as int32 holding the uint32 bits, on
    ``device`` (default: the key's). ``bits(key, shape).flatten()[start:
    start + count]`` with the same bits."""
    device = key.device if device is None else device
    k1, k2 = words(key)
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    lo = idx & MASK32
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)
    hi = (idx >> 32).to(torch.int32)
    return _threefry_i32(k1, k2, hi, lo)


def _mantissa_floats(b: torch.Tensor) -> torch.Tensor:
    """JAX's f32 uniform in [0, 1) from 32 random bits: the top 23 as the
    mantissa of a float in [1, 2), minus 1 (exact: ``(b >> 9) · 2⁻²³``)."""
    return ((b >> 9) & 0x7FFFFF).to(torch.float32) * (2.0 ** -23)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a·b + c`` with one rounding, as the reference's compiled code
    contracts it: the product of two f32 values is exact in f64 and the
    sum is rounded once to f64 and once to f32 (no input of this module's
    draws rounds differently; the tests check every one)."""
    return (a.double() * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


#: The Cephes coefficients of the reference's f32 log.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log of positive finite x, bitwise the JAX reference's
    on the CPU (XLA's Cephes polynomial, whose multiply-adds LLVM fuses):
    the data pipeline's Zipf logits and Gumbel noise go through it, so a
    batch's tokens equal JAX's. ``torch.log`` differs by an ulp on ~14 %
    of inputs, enough to move an argmax."""
    c = [torch.tensor(p, dtype=torch.float32, device=x.device)
         for p in _LOG_P]
    x = torch.clamp(x.float(), min=_F32_TINY)
    xb = x.view(torch.int32)
    e = ((xb >> 23) - 127).float() + 1.0
    m = ((xb & -2139095041) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < 0.707106781186547524
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    y = _fma(m, c[0], c[1])
    y1 = _fma(m, c[3], c[4])
    y2 = _fma(m, c[6], c[7])
    y = _fma(y, m, c[2])
    y1 = _fma(y1, m, c[5])
    y2 = _fma(y2, m, c[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, torch.tensor(_LOG_Q1, dtype=torch.float32,
                                 device=x.device) * e)
    m = m - 0.5 * x2
    m = m + y
    return m + torch.tensor(_LOG_Q2, dtype=torch.float32, device=x.device) * e


_GUMBEL_TABLES: dict = {}


def gumbel_table(device) -> torch.Tensor:
    """Gumbel noise of each of the 2²³ uniforms JAX's low-mode sampler can
    draw: entry k is ``-log(-log(u))`` with ``u = k·2⁻²³`` (k ≥ 1) or the
    smallest normal f32 (k = 0), in the reference's arithmetic. 32 MiB
    per device, made once."""
    device = torch.device(device)
    if device not in _GUMBEL_TABLES:
        k = torch.arange(1 << 23, dtype=torch.float32, device=device)
        u = torch.clamp(k * (2.0 ** -23), min=_F32_TINY)
        _GUMBEL_TABLES[device] = -log_f32(-log_f32(u))
    return _GUMBEL_TABLES[device]


def _draw_shape(shape) -> tuple:
    shape = tuple(int(d) for d in shape)
    count = 1
    for d in shape:
        count *= d
    return shape, count


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    mantissa floats scaled as ``max(minval, f·(maxval − minval) +
    minval)`` in f32, the multiply-add fused as the reference's."""
    shape, count = _draw_shape(shape)
    f = _mantissa_floats(counter_bits(key, 0, count, device))
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(lo, _fma(f, span, lo)).reshape(shape)


def gumbel(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in the default "low"
    mode: ``-log(-log(u))`` with ``u`` uniform in [tiny, 1), read from
    :func:`gumbel_table`."""
    shape, count = _draw_shape(shape)
    b = counter_bits(key, 0, count, device)
    return gumbel_table(b.device)[((b >> 9) & 0x7FFFFF).long()].reshape(shape)


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape=shape)`` for
    one distribution (1-D ``logits`` of V categories): the Gumbel-max
    ``argmax(gumbel(key, shape + (V,)) + logits)``, the first maximum on
    ties, as int64 on the logits' device. The (…, V) noise is drawn
    :data:`DRAW_SLICE` elements at a time, whole rows each."""
    if logits.dim() != 1:
        raise ValueError("categorical takes one distribution: 1-D logits")
    shape, rows = _draw_shape(() if shape is None else shape)
    v = logits.shape[0]
    table = gumbel_table(logits.device)
    per = max(1, DRAW_SLICE // v)
    out = torch.empty(rows, dtype=torch.int64, device=logits.device)
    for r0 in range(0, rows, per):
        n = min(per, rows - r0)
        b = counter_bits(key, r0 * v, n * v, logits.device)
        g = table[((b >> 9) & 0x7FFFFF).long()].view(n, v)
        out[r0:r0 + n] = torch.argmax(g + logits, dim=-1)
    return out.reshape(shape)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for float32 or bfloat16:
    ``√2 · erfinv(u)`` with ``u`` uniform in (−1, 1) drawn in ``dtype``
    (for bf16 the low 8 bits of each draw, the top 7 of them as the
    mantissa, since JAX draws 8 bits for a float of 7 mantissa bits),
    each step rounded to ``dtype``. bf16 draws are bitwise JAX's; an f32
    draw differs by ~1e-5 relative near the tails, since ``torch.erfinv``
    is not the reference's polynomial."""
    shape, count = _draw_shape(shape)
    b = counter_bits(key, 0, count, device)
    if dtype == torch.bfloat16:
        f = ((b & 0xFF) >> 1).to(torch.float32) * (2.0 ** -7)
    elif dtype == torch.float32:
        f = _mantissa_floats(b)
    else:
        raise ValueError(f"normal draws float32 or bfloat16, not {dtype}")
    one = torch.tensor(1.0, dtype=dtype)
    lo = torch.nextafter(-one, torch.zeros((), dtype=dtype)).to(f.device)
    span = one.to(f.device) - lo
    if dtype == torch.bfloat16:
        u = f.to(dtype) * span + lo     # each op rounded to bf16
    else:
        u = _fma(f, span, lo)
    u = torch.maximum(lo, u)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=f.device)
    return (sqrt2 * torch.erfinv(u.float()).to(dtype)).reshape(shape)


def bernoulli(key: torch.Tensor, p: float, shape=(),
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: an f32 uniform below
    ``float32(p)``."""
    shape, count = _draw_shape(shape)
    f = _mantissa_floats(counter_bits(key, 0, count, device))
    return (f < torch.tensor(p, dtype=torch.float32,
                             device=f.device)).reshape(shape)
