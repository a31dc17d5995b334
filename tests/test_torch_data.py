"""The port's data pipeline (``repro_torch.data``) and the ``jax.random``
distributions it draws from (``repro_torch.core.rng``) against the JAX
package's, on the CPU.

Bounds: the tokens and labels of every batch are bitwise JAX's (threefry
counters, the Gumbel noise through the reference's own f32 log, the
first maximum on ties); so are hubert's masks and the bf16 frame
embeddings. The Gumbel noise is checked on every one of the 2²³ uniforms
the sampler can draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro_torch import configs as tconfigs
from repro_torch.core import rng
from repro_torch.data import DataConfig, SyntheticLMData

ARCHS = ("qwen2-7b", "granite-moe-1b-a400m", "llava-next-34b",
         "hubert-xlarge")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, and the
    tier-1 run shares the cores among several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=3, batch=4, seq=32):
    jd = JSyntheticLMData(jconfigs.get_config(arch, smoke=True),
                          JDataConfig(seed=seed, global_batch=batch,
                                      seq_len=seq))
    td = SyntheticLMData(tconfigs.get_config(arch, smoke=True),
                         DataConfig(seed=seed, global_batch=batch,
                                    seq_len=seq), device="cpu")
    return jd, td


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", [0, 1, 7])
def test_batch_is_bitwise_jax(arch, step):
    jd, td = _pair(arch)
    jb, tb = jd.batch(step), td.batch(step)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        want = np.asarray(jb[k])
        got = tb[k]
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
        else:
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    if arch == "hubert-xlarge":
        labels = tb["labels"].numpy()
        assert (labels == -1).any() and (labels >= 0).any()


def test_gumbel_noise_bitwise_on_every_uniform():
    k = np.arange(1 << 23, dtype=np.uint32)
    tiny = np.finfo(np.float32).tiny
    u = ((k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0))
    u = np.maximum(u, tiny)
    want = np.asarray(jax.jit(lambda u: -jnp.log(-jnp.log(u)))(u))
    got = rng.gumbel_table("cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    ranks = np.arange(1, 160_001, dtype=np.float32)
    np.testing.assert_array_equal(
        rng.log_f32(torch.from_numpy(ranks)).numpy(),
        np.asarray(jax.jit(jnp.log)(ranks)))


def test_distributions_bitwise_jax():
    jk = jax.random.fold_in(jax.random.key(11), 5)
    tk = rng.fold_in(rng.key(11), 5)
    for lo, hi in ((0.0, 1.0), (0.3, 1.7), (-2.0, 5.0)):
        np.testing.assert_array_equal(
            rng.uniform(tk, (40, 50), lo, hi).numpy(),
            np.asarray(jax.random.uniform(jk, (40, 50), minval=lo,
                                          maxval=hi)))
    np.testing.assert_array_equal(
        rng.gumbel(tk, (7, 300)).numpy(),
        np.asarray(jax.random.gumbel(jk, (7, 300))))
    np.testing.assert_array_equal(
        rng.bernoulli(tk, 0.3, (40, 50)).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.3, (40, 50))))
    np.testing.assert_array_equal(
        rng.normal(tk, (4000,), torch.bfloat16).float().numpy(),
        np.asarray(jax.random.normal(jk, (4000,), jnp.bfloat16)).astype(
            np.float32))
    # f32 normals: torch.erfinv is not XLA's polynomial.
    got = rng.normal(tk, (4000,)).numpy()
    want = np.asarray(jax.random.normal(jk, (4000,)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    logits = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    np.testing.assert_array_equal(
        rng.categorical(tk, torch.from_numpy(logits), (6, 9)).numpy(),
        np.asarray(jax.random.categorical(jk, jnp.asarray(logits),
                                          shape=(6, 9))))


def test_sliced_draw_equals_whole_draw(monkeypatch):
    key = rng.fold_in(rng.key(2), 9)
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(size=(777,)).astype(np.float32))
    whole = rng.categorical(key, logits, (5, 13))
    for per in (1, 777, 777 * 3 + 5):
        monkeypatch.setattr(rng, "DRAW_SLICE", per)
        assert torch.equal(rng.categorical(key, logits, (5, 13)), whole)
    full = rng.counter_bits(key, 0, 5000)
    assert torch.equal(rng.counter_bits(key, 1234, 321), full[1234:1555])
    want = rng.bits(key, (5000,))
    assert torch.equal(full.long() & rng.MASK32, want)


def test_counters_past_two_to_the_32():
    """The high counter word: JAX's partitionable iota splits the flat
    index into (hi, lo) words; the int32 hash equals the int64 one."""
    key = rng.fold_in(rng.key(4), 1)
    start = (1 << 32) - 3
    got = rng.counter_bits(key, start, 6).long() & rng.MASK32
    idx = torch.arange(start, start + 6, dtype=torch.int64)
    o1, o2 = rng.threefry2x32(key[0], key[1], idx >> 32, idx & rng.MASK32)
    assert torch.equal(got, o1 ^ o2)


def test_skip_ahead_and_host_shard():
    _, td = _pair("qwen2-7b", seed=7, batch=4, seq=16)
    jd, _ = _pair("qwen2-7b", seed=7, batch=4, seq=16)
    b1 = td.batch(10)
    assert torch.equal(b1["tokens"], td.batch(10)["tokens"])
    assert not torch.equal(b1["tokens"], td.batch(11)["tokens"])
    # A fresh pipeline skips straight to step 10.
    assert torch.equal(_pair("qwen2-7b", 7, 4, 16)[1].batch(10)["labels"],
                       b1["labels"])
    jb = jd.batch(10)
    for i in range(2):
        got = td.host_shard(b1, i, 2)
        want = jd.host_shard(jb, i, 2)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stacked = torch.cat([td.host_shard(b1, i, 2)["tokens"] for i in range(2)])
    assert torch.equal(stacked, b1["tokens"])


def test_zipf_drift_stream_at_another_vocab():
    """A vocab that is not a power of two and a longer sequence."""
    jcfg = dataclasses.replace(jconfigs.get_config("qwen2-7b", smoke=True),
                               vocab_size=1999)
    tcfg = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True),
                               vocab_size=1999)
    jb = JSyntheticLMData(jcfg, JDataConfig(seed=5, global_batch=3,
                                            seq_len=100)).batch(4)
    tb = SyntheticLMData(tcfg, DataConfig(seed=5, global_batch=3,
                                          seq_len=100), device="cpu").batch(4)
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
