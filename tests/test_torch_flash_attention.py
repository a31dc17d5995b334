"""The port's flash attention on the CPU (its plain version) against the JAX
package's ``chunked_attention``, the Pallas kernel's own oracle
(``repro/kernels/flash_attention.py:17``): the Pallas kernel itself cannot
run on the installed jax (no ``pl.load``).

Inputs are numpy normals from a seed, handed to both packages. Tolerances
are JAX's own for flash against chunked (``tests/test_flash_attention.py``):
2e-5 in f32 (the two sum the same products in another order and the chunked
path rescales per KV block), 2e-2 in bf16 (one bf16 ulp at |out| ≤ 2 is
2^-7 ≈ 0.008; both round p to bf16 before P·V, but the chunked path also
rounds q·scale to bf16 where the flash versions scale the f32 scores).
"""
import jax  # noqa: F401  (the port's tests import both packages)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as jax_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import layers as tlayers

CASES = [
    (2, 6, 2, 256, 64, 64, 64),
    (1, 4, 4, 128, 32, 32, 64),   # MHA
    (2, 8, 1, 128, 64, 64, 32),   # MQA
    (1, 2, 2, 192, 16, 64, 64),   # non-power-of-two seq
]


def _qkv(seed, b, hq, hkv, sq, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", CASES)
def test_flash_matches_jax_chunked(causal, b, hq, hkv, s, d, bq, bk):
    arrays = _qkv(b + s, b, hq, hkv, s, d)
    scale = 1.0 / d ** 0.5
    got = fa.flash_attention(*_port(arrays), causal, scale, bq, bk)
    want = jax_chunked(*_jax(arrays), causal=causal, q_chunk=bq, kv_chunk=bk,
                       scale=scale)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", CASES)
def test_flash_bf16_matches_jax_chunked(causal, b, hq, hkv, s, d, bq, bk):
    """bf16 inputs: the plain version's cast points (q and k as bf16 values,
    scale on the f32 scores, p rounded to bf16 before P·V) against JAX's
    chunked path in bf16, 2e-2 as above."""
    arrays = _qkv(b + s, b, hq, hkv, s, d)
    scale = 1.0 / d ** 0.5
    got = fa.flash_attention(*_port(arrays, torch.bfloat16), causal, scale,
                             bq, bk)
    want = jax_chunked(*_jax(arrays, jnp.bfloat16), causal=causal,
                       q_chunk=bq, kv_chunk=bk, scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def _attention_with_p(q, k, v, causal, scale, round_p):
    """Attention of bf16 q, k, v in f32 with the bf16 kernel's cast points,
    p rounded to bf16 before P·V or not."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = torch.where(mask, s, ref.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    return ((p @ vf) / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_plain_rounds_p_before_pv(causal):
    """The bf16 plain version rounds p (and only p) to bf16 before P·V, as
    the tensor-core kernel does: it equals an independent computation with
    that cast bitwise, and differs from the same computation with an f32 p
    by at most 2e-2 (one bf16 ulp of |out| ≤ 2, the bf16 bound)."""
    q, k, v = _port(_qkv(11, 1, 4, 2, 96, 32), torch.bfloat16)
    got = ref.flash_attention(q, k, v, causal, 0.2)
    assert torch.equal(got, _attention_with_p(q, k, v, causal, 0.2, True))
    f32_p = _attention_with_p(q, k, v, causal, 0.2, False)
    assert not torch.equal(got, f32_p)
    torch.testing.assert_close(got.float(), f32_p.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,d,mma_sync,entry", [
    pytest.param(torch.bfloat16, 32, False, "flash_attention_forward_bf16",
                 id="dtype0-flash_attention_forward_bf16"),
    pytest.param(torch.float32, 32, False, "flash_attention_forward_f32",
                 id="dtype1-flash_attention_forward_f32"),
    pytest.param(torch.bfloat16, 64, False,
                 "flash_attention_forward_bf16_wgmma", id="bf16-64"),
    pytest.param(torch.bfloat16, 128, False,
                 "flash_attention_forward_bf16_wgmma", id="bf16-128"),
    pytest.param(torch.bfloat16, 64, True, "flash_attention_forward_bf16",
                 id="bf16-64-mma_sync"),
    pytest.param(torch.bfloat16, 128, True, "flash_attention_forward_bf16",
                 id="bf16-128-mma_sync"),
    pytest.param(torch.bfloat16, 80, False, "flash_attention_forward_bf16",
                 id="bf16-80"),
    pytest.param(torch.float32, 64, False, "flash_attention_forward_f32",
                 id="f32-64"),
    pytest.param(torch.float32, 128, True, "flash_attention_forward_f32",
                 id="f32-128-mma_sync"),
])
def test_flash_launch_routes_by_dtype(monkeypatch, dtype, d, mma_sync,
                                      entry):
    """The launch picks the C entry by dtype and head dim (bf16 at D 64 and
    128 the wgmma entry unless ``mma_sync`` forces the mma.sync one) and
    bumps only that entry's counter (a stand-in for the library records
    the calls; no card); a launch without ``with_lse`` passes a null
    lse."""
    calls = []

    def fake_fn(name):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(fa, "_fn", fake_fn)
    q, k, v = _port(_qkv(3, 2, 6, 2, 64, d), dtype)
    before = [c.count for c in fa.FWD_COUNTERS]
    out = fa._launch(q, k, v, True, 0.25, 7, mma_sync=mma_sync)
    assert out.dtype == dtype and out.shape == q.shape
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert args[4] is None
    assert args[5:11] == (2, 6, 2, 64, 64, d) and args[12:] == (1, 7)
    bumped = fa.fwd_route(dtype, d, mma_sync)[1]
    assert fa.fwd_route(dtype, d, mma_sync)[0] == entry
    assert [c.count for c in fa.FWD_COUNTERS] == [
        n + (c is bumped) for n, c in zip(before, fa.FWD_COUNTERS)]


def test_flash_launch_refuses_a_failed_entry(monkeypatch):
    """A non-zero return from the entry raises and counts nothing."""
    monkeypatch.setattr(fa, "_fn", lambda name: lambda *args: 1)
    q, k, v = _port(_qkv(4, 1, 2, 1, 32, 16), torch.bfloat16)
    before = [c.count for c in fa.FWD_COUNTERS]
    with pytest.raises(RuntimeError, match="flash_attention_forward_bf16"):
        fa._launch(q, k, v, False, 0.25, 0)
    assert [c.count for c in fa.FWD_COUNTERS] == before


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_dtypes(dtype):
    arrays = _qkv(0, 2, 4, 2, 128, 64)
    got = fa.flash_attention(*_port(arrays, getattr(torch, dtype)), True,
                             0.125, 64, 64)
    want = jax_chunked(*_jax(arrays, getattr(jnp, dtype)), causal=True,
                       q_chunk=64, kv_chunk=64, scale=0.125)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d", [(64, 128, 24), (128, 64, 80),
                                      (96, 96, 160)])
def test_flash_uneven_lengths_and_head_dims(causal, sq, skv, d):
    """Sq ≠ Skv (the mask stays top-left aligned, as in both JAX
    functions) and head dims of the configs (80, 160) and off the kernel's
    grid (24, which only the plain version takes). f32, 2e-5 as above."""
    arrays = _qkv(sq + d, 1, 4, 2, sq, d, skv)
    got = fa.flash_attention(*_port(arrays), causal, 0.3, 32, 32)
    want = jax_chunked(*_jax(arrays), causal=causal, q_chunk=32, kv_chunk=32,
                       scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_equals_the_ports_chunked_attention():
    """The two attention paths of the port's model agree in f32 (2e-5, as
    above), with the chunked one at the configs' default chunks."""
    q, k, v = _port(_qkv(5, 2, 6, 2, 256, 32))
    for causal in (True, False):
        a = fa.flash_attention(q, k, v, causal, 0.2, 512, 1024)
        b = tlayers.chunked_attention(q, k, v, causal=causal, q_chunk=64,
                                      kv_chunk=128, scale=0.2)
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_flash_plain_version_slices_query_rows(monkeypatch):
    """The plain version forms its scores a slice of query rows at a time;
    the slicing changes nothing (bitwise)."""
    q, k, v = _port(_qkv(6, 2, 4, 2, 96, 16))
    whole = ref.flash_attention(q, k, v, True, 0.25)
    monkeypatch.setattr(ref, "FLASH_PLAIN_SCORE_ELEMENTS", 4 * 96 * 7)
    sliced = ref.flash_attention(q, k, v, True, 0.25)
    assert torch.equal(whole, sliced)


def test_flash_refuses_indivisible_sequences():
    q, k, v = _port(_qkv(1, 1, 2, 2, 96, 16))
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, v, True, 0.25, 64, 64)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q, k[:, :1].expand(1, 3, 96, 16).contiguous(),
                           v[:, :1].expand(1, 3, 96, 16).contiguous(), True,
                           0.25, 32, 32)


def test_flash_never_falls_back_for_a_device_tensor(monkeypatch):
    """Only a CPU tensor reaches the plain version: a tensor on any other
    device goes to the kernel or raises (here a meta tensor stands for a
    tensor the kernel cannot take), and is never computed by the plain
    version."""
    called = []
    monkeypatch.setattr(ref, "flash_attention",
                        lambda *a, **k: called.append(1))
    q = torch.empty((1, 2, 64, 16), device="meta")
    before = [c.count for c in fa.FWD_COUNTERS]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention(q, q, q, True, 0.25)
    assert not called
    assert [c.count for c in fa.FWD_COUNTERS] == before
