"""Kernel E's backward on the CPU: the plain backward
(``ref.flash_attention_bwd``, the CUDA kernel's three passes written
straight) and the autograd Function around it.

* The plain backward against ``jax.vjp`` through the JAX package's
  ``chunked_attention`` (what its ``_flash_bwd`` differentiates), within
  1e-5 (f32) and 0.02 (bf16) of each gradient's max |grad|: causal and
  not, GQA rep 1, 2 and 4, D = 16 and 80, Sq above and below Skv.
* The plain forward's log-sum-exp against ``torch.logsumexp`` of the
  masked f32 scores (log2 units), and its ``out`` bitwise the same with
  and without it.
* The Function on the CPU is bitwise the plain backward and runs no
  ``chunked_attention``; on the meta device (a dry run) the cost counter
  counts the backward once at its entry, with 2.5× the forward's flops.

Inputs are numpy normals from a seed. The kernel itself runs only on the
card: ``tests/test_torch_cuda_kernels.py`` (``-m cuda``) holds it against
the plain backward there.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.device import meta_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.roofline import count_costs

#: (B, Hq, Hkv, Sq, Skv, D, q_chunk, kv_chunk): GQA rep 1, 2 and 4, D = 16
#: and 80, and Sq on either side of Skv (the causal mask top-left aligned).
CASES = [
    (2, 2, 2, 64, 64, 16, 16, 32),
    (1, 4, 2, 64, 64, 16, 32, 16),
    (2, 8, 2, 64, 64, 80, 16, 32),
    (1, 4, 1, 48, 64, 80, 16, 32),
    (1, 4, 2, 64, 32, 16, 32, 16),
]
#: Of each gradient's max |grad|: the bounds the Function's gradients meet
#: against JAX's (test_torch_train.py::test_flash_function_backward).
BOUND = {"float32": 1e-5, "bfloat16": 0.02}


def _draw(case, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
              (b, hq, sq, d)]
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case, causal, dtype):
    arrays = _draw(case)
    q, k, v, g = _torch(arrays, dtype)
    scale = case[5] ** -0.5
    out, lse = ref.flash_attention(q, k, v, causal, scale, return_lse=True)
    got = ref.flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: jlayers.chunked_attention(
        q_, k_, v_, causal=causal, q_chunk=case[6], kv_chunk=case[7],
        scale=scale), *(jnp.asarray(a, jdt) for a in arrays[:3]))
    for name, x, w, like in zip("qkv", got, vjp(jnp.asarray(arrays[3], jdt)),
                                (q, k, v)):
        w = np.asarray(w, np.float32)
        assert x.dtype == like.dtype and x.shape == like.shape
        err = float(np.abs(x.float().numpy() - w).max())
        assert err <= BOUND[dtype] * float(np.abs(w).max()), f"d{name}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES[2:])
def test_plain_lse_matches_logsumexp(case, causal, dtype):
    """The saved lse is log2 Σ exp(s) of the scaled scores: for f32 inputs
    s = (q·scale)·k, for bf16 s = (q·k)·scale (the kernels' cast points)."""
    q, k, v, _ = _torch(_draw(case, seed=1), dtype)
    b, hq, hkv, sq, skv, d = case[:6]
    scale = d ** -0.5
    _, lse = ref.flash_attention(q, k, v, causal, scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf = k.float()[:, :, None]
    if dtype == "float32":
        s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    else:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        mask = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        s = torch.where(mask, s, -math.inf)
    want = (torch.logsumexp(s, dim=-1) / math.log(2)).reshape(b, hq, sq)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_out_same_with_lse(causal, dtype):
    q, k, v, _ = _torch(_draw(CASES[3]), dtype)
    scale = CASES[3][5] ** -0.5
    out, _ = ref.flash_attention(q, k, v, causal, scale, return_lse=True)
    assert torch.equal(out, ref.flash_attention(q, k, v, causal, scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_function_on_cpu_is_the_plain_backward(monkeypatch, causal, dtype):
    """The Function's backward on the CPU is the plain backward, bitwise,
    and never reaches ``chunked_attention`` (made to raise here); no kernel
    launches."""
    def refuse(*args, **kwargs):
        raise AssertionError("the Function's backward ran chunked_attention")

    monkeypatch.setattr(layers, "chunked_attention", refuse)
    case = CASES[2]
    q, k, v, g = _torch(_draw(case, seed=2), dtype)
    scale = case[5] ** -0.5
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (fa.tc_counter, fa.f32_counter, fa.bwd_tc_counter,
                fa.bwd_f32_counter)
    before = [c.count for c in counters]
    out = fa.flash_attention(*ins, causal, scale, case[6], case[7])
    got = torch.autograd.grad(out, ins, g)
    assert [c.count for c in counters] == before
    want_out, lse = ref.flash_attention(q, k, v, causal, scale,
                                        return_lse=True)
    assert torch.equal(out.detach(), want_out)
    want = ref.flash_attention_bwd(q, k, v, want_out, lse, g, causal, scale)
    for x, w in zip(got, want):
        assert x.dtype == w.dtype and torch.equal(x, w)


@pytest.mark.parametrize("causal", [True, False])
def test_meta_backward_counts_its_entry(causal):
    """A dry run's backward: empty gradients of the inputs' shapes, and
    ``flash_attention_bwd`` counted once with 2.5× the forward's flops
    (the five products) and the bytes of ``fa.bwd_cost``."""
    b, hq, hkv, s, d = 2, 4, 2, 64, 16
    ins = [torch.empty(b, h, s, d, dtype=torch.bfloat16, device="meta",
                       requires_grad=True) for h in (hq, hkv, hkv)]
    g = torch.empty(b, hq, s, d, dtype=torch.bfloat16, device="meta")
    with count_costs() as c, meta_device():
        out = fa.flash_attention(*ins, causal, d ** -0.5, 16, 16)
        grads = torch.autograd.grad(out, ins, g)
    for x, like in zip(grads, ins):
        assert x.is_meta and x.shape == like.shape and x.dtype == like.dtype
    cost = c.cost
    assert cost.kernels == {"flash_attention": 1, "flash_attention_bwd": 1}
    fwd = fa.flops(ins[0], ins[1], causal)
    pairs = s * (s + 1) / 2 if causal else s * s
    assert fwd == 4 * b * hq * d * pairs
    assert cost.flops == fwd + 2.5 * fwd
    fwd_bytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    bwd_bytes = 2 * (4 * b * hq * s * d + 4 * b * hkv * s * d) \
        + 2 * 4 * b * hq * s
    assert cost.bytes == fwd_bytes + bwd_bytes


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "flash_attention_backward_bf16"),
    (torch.float32, "flash_attention_backward_f32")])
def test_backward_launch_routes_by_dtype(monkeypatch, dtype, entry):
    """The backward launch picks the C entry by dtype, passes the saved lse
    and a (B, Hq, Sq) f32 Δ scratch, and bumps only that entry's counter
    once (a stand-in records the call; no card). A failed entry raises and
    counts nothing."""
    calls = []

    def fake_fn(name):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(fa, "_bwd_fn", fake_fn)
    q, k, v, g = _torch(_draw(CASES[1]), "float32")
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
    out, lse = ref.flash_attention(q, k, v, True, 0.25, return_lse=True)
    counters = (fa.bwd_tc_counter, fa.bwd_f32_counter)
    before = [c.count for c in counters]
    dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, g, True, 0.25, 7)
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert args[4] == lse.data_ptr() and args[5] == g.data_ptr()
    assert args[6:9] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[10:16] == (1, 4, 2, 64, 64, 16) and args[17:] == (1, 7)
    for x, like in zip((dq, dk, dv), (q, k, v)):
        assert x.dtype == dtype and x.shape == like.shape
    bumped = fa.BWD_ENTRIES[dtype][1]
    assert [c.count for c in counters] == [
        b + (c is bumped) for b, c in zip(before, counters)]
    monkeypatch.setattr(fa, "_bwd_fn", lambda name: lambda *args: 2)
    with pytest.raises(RuntimeError, match=entry):
        fa._launch_bwd(q, k, v, out, lse, g, True, 0.25, 0)
    assert [c.count for c in counters] == [
        b + (c is bumped) for b, c in zip(before, counters)]
