"""The port's threefry RNG against ``jax.random``, bitwise.

Every stream the fused solve consumes is checked: the base key
``fold_in(key(0), seed)``, the chunk uniforms ``uniform01(stream(base,
SWEEP, c), (T, R, 4))``, the replica-init keys ``REPLICA → INIT`` and the
bernoulli float construction inside ``ising.random_spins``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core import rng as jrng
from repro_torch.core import ising as tising
from repro_torch.core import rng as trng
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sweep

SEEDS = [0, 1, 7, 12345, 2**31 + 5, 2**32 - 1]


def _jbase(seed):
    return jax.random.fold_in(jax.random.key(0), jnp.asarray(seed, jnp.uint32))


def _tbase(seed):
    return trng.fold_in(trng.key(0), seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key_matches(seed):
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(_jbase(seed))), _tbase(seed).numpy())


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
@pytest.mark.parametrize("chunk", [0, 1, 78, 1000])
def test_sweep_uniforms_match(seed, chunk):
    shape = (17, 8, 4)
    want = jrng.uniform01(jrng.stream(_jbase(seed), jrng.Salt.SWEEP, chunk),
                          shape)
    got = trng.uniform01(trng.stream(_tbase(seed), trng.Salt.SWEEP, chunk),
                         shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("chunk", [0, 1, 78, 1000])
@pytest.mark.parametrize("t", [17, 64, 130])
def test_sweep_kernel_draw_mirror_matches(seed, chunk, t):
    """The keyed sweep's in-kernel draw, mirrored in torch (the chunk key
    from the base key's two words, then each staged window's per-thread
    counter (t·R + r)·4 + slot), equals ``rng.uniform01`` of the chunk's
    stream and JAX's draw bitwise, also where T is not a multiple of the
    64-step window."""
    r = 8
    base = _tbase(seed)
    words = trng.words(base)
    assert torch.equal(trng.from_words(*words), base)
    got = tref.sweep_uniforms(words, chunk, t, r)
    want = trng.uniform01(trng.stream(base, trng.Salt.SWEEP, chunk),
                          (t, r, 4))
    assert got.dtype == torch.float32 and got.shape == (t, r, 4)
    assert torch.equal(got, want)
    assert torch.equal(sweep.sweep_uniforms(words, chunk, t, r), want)
    jwant = jrng.uniform01(jrng.stream(_jbase(seed), jrng.Salt.SWEEP, chunk),
                           (t, r, 4))
    np.testing.assert_array_equal(np.asarray(jwant), got.numpy())


def test_fold_in_chains_and_key_seeds_match():
    for seed in (0, 99, 2**31 - 1):
        jk = jax.random.key(seed)
        tk = trng.key(seed)
        for ix in (0, 5, 2**31, 2**32 - 1):
            jk = jax.random.fold_in(jk, jnp.asarray(ix, jnp.uint32))
            tk = trng.fold_in(tk, ix)
            np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                          tk.numpy())


def test_batched_fold_in_matches_vmap():
    base_j, base_t = _jbase(11), _tbase(11)
    want = jax.vmap(lambda i: jrng.stream(base_j, jrng.Salt.REPLICA, i))(
        jnp.arange(16))
    got = trng.stream(base_t, trng.Salt.REPLICA, torch.arange(16))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(want)),
                                  got.numpy())


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 5])
@pytest.mark.parametrize("n", [64, 250, 2000])
def test_replica_init_spins_match(seed, n):
    r = 8
    keys_j = jax.vmap(lambda i: jrng.stream(_jbase(seed), jrng.Salt.REPLICA,
                                            i))(jnp.arange(r))
    want = jax.vmap(lambda k: jising.random_spins(
        jrng.stream(k, jrng.Salt.INIT), (n,)))(keys_j)
    keys_t = trng.stream(trng.stream(_tbase(seed), trng.Salt.REPLICA,
                                     torch.arange(r)), trng.Salt.INIT)
    got = tising.random_spins(keys_t, (n,))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_bernoulli_float_construction_matches():
    for seed in range(5):
        jk = jax.random.key(seed)
        want = jax.random.bernoulli(jk, 0.5, (3, 1000))
        got = trng.bernoulli_half(trng.key(seed), (3, 1000))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_bits_and_index_from_uniform_match():
    jk = jax.random.key(42)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (5, 7), jnp.uint32)).astype(np.int64),
        trng.bits(trng.key(42), (5, 7)).numpy())
    u = np.random.default_rng(0).random(10000).astype(np.float32)
    u[:3] = [0.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 1.0]
    for n in (1, 64, 250, 2000):
        np.testing.assert_array_equal(
            np.asarray(jrng.index_from_uniform(jnp.asarray(u), n)),
            trng.index_from_uniform(torch.from_numpy(u), n).numpy())
