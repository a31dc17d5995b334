"""Kernel C's arithmetic on the CPU: the select identity its CUDA kernel
(``csrc/bitplane_field.cu``) rests on, and the port's plain
``bitplane_field_init`` against the JAX package's Pallas kernel (interpret
mode) and its reference, bitwise, on arbitrary plane words.

The identity: for any words p, q and x, p & x and q & ~x share no bit, so
    (2·popc(p&x) − popc(p)) − (2·popc(q&x) − popc(q))
        = 2·popc((p & x) | (q & ~x)) − popc(p) − popc(q),
whether or not p and q overlap. The kernel takes one popcount per replica
and word from it. Real planes never set a coupling in both pos and neg; the
words here do, so nothing rests on that.

The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitplane_field as jfield
from repro.kernels import ref as jref
from repro_torch.core.bitplane import popcount32
from repro_torch.kernels import bitplane_field, ref


def _words(g, shape):
    return g.integers(0, 2 ** 32, shape, dtype=np.uint32)


def _pair(kind, g, shape):
    """pos and neg words: independent (they overlap on about a quarter of
    the bits), equal, one a superset of the other, or disjoint."""
    p = _words(g, shape)
    q = {"random": lambda: _words(g, shape),
         "equal": lambda: p.copy(),
         "superset": lambda: p | _words(g, shape),
         "disjoint": lambda: _words(g, shape) & ~p}[kind]()
    return p, q


@pytest.mark.parametrize("kind", ["random", "equal", "superset", "disjoint"])
def test_select_identity_on_overlapping_words(kind):
    g = np.random.default_rng(["random", "equal", "superset",
                               "disjoint"].index(kind))
    p, q = _pair(kind, g, (4096,))
    x = _words(g, (4096,))
    # The extremes of every word.
    p[:4], q[:4], x[:4] = 0, 0xFFFFFFFF, np.array([0, 0xFFFFFFFF, 1, 1 << 31])
    if kind == "random":
        assert ((p & q) != 0).mean() > 0.9   # pos and neg overlap

    def pc(a):
        return popcount32(torch.from_numpy(a.astype(np.int64)))

    lhs = (2 * pc(p & x) - pc(p)) - (2 * pc(q & x) - pc(q))
    rhs = 2 * pc((p & x) | (q & ~x)) - pc(p) - pc(q)
    assert torch.equal(lhs, rhs)
    jpc = jax.lax.population_count
    want = np.asarray(jpc(jnp.asarray((p & x) | (q & ~x)))).astype(np.int64)
    np.testing.assert_array_equal(pc((p & x) | (q & ~x)).numpy(), want)


@pytest.mark.parametrize("num_planes", [1, 2, 3])
@pytest.mark.parametrize("r", [1, 13, 32])
def test_plain_field_init_on_overlapping_words_equals_jax(r, num_planes):
    n, w = 48, 37
    g = np.random.default_rng(100 * r + num_planes)
    pos, neg = _pair("random", g, (num_planes, n, w))
    x = _words(g, (r, w))
    want_kernel = np.asarray(jfield.bitplane_field_init(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(x), interpret=True))
    want_ref = np.asarray(jref.bitplane_field_init(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(x), n))
    tpos, tneg, tx = (torch.from_numpy(a.view(np.int32))
                      for a in (pos, neg, x))
    got_ref = ref.bitplane_field_init(tpos, tneg, tx)
    got_wrapper = bitplane_field.bitplane_field_init(tpos, tneg, tx)
    for got in (got_ref, got_wrapper):
        assert got.dtype == torch.float32 and got.shape == (r, n)
        for want in (want_kernel, want_ref):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))
    # The identity the card's kernel computes, summed per plane in order.
    p64, q64, x64 = (torch.from_numpy(a.astype(np.int64))
                     for a in (pos, neg, x))
    sel = (p64[None] & x64[:, None, None]) | (q64[None] & ~x64[:, None, None]
                                              & 0xFFFFFFFF)
    contrib = (2 * popcount32(sel).sum(-1)
               - (popcount32(p64) + popcount32(q64)).sum(-1)[None])
    acc = torch.zeros((r, n), dtype=torch.float32)
    for b in range(num_planes):
        acc = acc + float(1 << b) * contrib[:, b].to(torch.float32)
    assert torch.equal(acc, got_ref)
