"""Kernel E's forward routes: the wgmma entry
(``csrc/flash_attention_wgmma.cu``, bfloat16 at head dims 64 and 128)
beside the mma.sync and f32 entries (``csrc/flash_attention.cu``).

* On the CPU: the route table. ``_launch`` with the entries replaced by
  stand-ins (no card) calls the entry ``fwd_route`` names for every
  (dtype, D), from the library ``LIBRARIES`` names, with the shape and a
  null or real lse pointer, bumps that entry's counter alone, and
  ``mma_sync=True`` sends bfloat16 at D 64 and 128 to the mma.sync entry
  and changes nothing else; a refused launch raises and counts nothing.
* On the card (``-m cuda``; each test skips without one): the wgmma route
  against the plain forward (``ref.flash_attention``) within 2e-2 (the
  bf16 bound of ``chip_smoke.FLASH_TOL``) and its lse within
  ``ref.FLASH_LSE_TOL``, at D 64 and 128, GQA rep 1, 2 and 7, Sq above and
  below Skv, ragged lengths, causal and not; two calls bitwise equal; the
  forced mma.sync route against the plain version; a call from a thread
  with no current CUDA context (as autograd's recompute) bitwise a call
  from the main thread; the autograd Function's backward, fed by this
  forward's lse, against the plain backward within ``ref.FLASH_BWD_TOL``.

The file imports neither JAX nor the JAX package. Run the card tests with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_forward_wgmma.py
"""
import threading

import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)
#: The bf16 bound of a forward against its plain version (one bf16 ulp of
#: |out| ≤ 2, the bound ``chip_smoke.FLASH_TOL`` holds every route to).
BF16_TOL = 2e-2


def _qkv(dtype, d, b=1, hq=4, hkv=2, sq=64, skv=64, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(sh, generator=g, device=device).to(dtype)
            for sh in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _expected(dtype, d, mma_sync):
    if dtype == torch.float32:
        return "flash_attention_forward_f32", fa.f32_counter
    if d in (64, 128) and not mma_sync:
        return "flash_attention_forward_bf16_wgmma", fa.fwd_wgmma_counter
    return "flash_attention_forward_bf16", fa.tc_counter


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("mma_sync", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_route_table(monkeypatch, dtype, d, mma_sync, with_lse):
    """Each (dtype, D), with and without the forced mma.sync route: the
    entry called, its library, the pointers and shape it is given, and the
    one counter bumped once."""
    calls = []

    def fake_fn(entry):
        def launch(*args):
            calls.append((entry, args))
            return 0
        return launch

    monkeypatch.setattr(fa, "_fn", fake_fn)
    entry, counter = _expected(dtype, d, mma_sync)
    assert fa.fwd_route(dtype, d, mma_sync) == (entry, counter)
    assert _build.SOURCES[fa.LIBRARIES[entry]] == (
        "flash_attention_wgmma.cu" if counter is fa.fwd_wgmma_counter
        else "flash_attention.cu")
    q, k, v = _qkv(dtype, d)
    before = [c.count for c in fa.FWD_COUNTERS]
    res = fa._launch(q, k, v, True, 0.25, 5, with_lse, mma_sync=mma_sync)
    out, lse = res if with_lse else (res, None)
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4] == (lse.data_ptr() if with_lse else None)
    assert args[5:11] == (1, 4, 2, 64, 64, d) and args[11:] == (0.25, 1, 5)
    assert out.dtype == dtype and out.shape == q.shape
    if with_lse:
        assert lse.dtype == torch.float32 and lse.shape == (1, 4, 64)
    assert [c.count for c in fa.FWD_COUNTERS] == [
        n + (c is counter) for n, c in zip(before, fa.FWD_COUNTERS)]


@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_forward_refused_raises_and_counts_nothing(monkeypatch, d):
    """A launch the wgmma entry refuses raises with the entry's name; no
    other entry (the mma.sync one, the plain version) is tried and no
    counter moves."""
    calls = []

    def refusing(entry):
        def launch(*args):
            calls.append(entry)
            return 1
        return launch

    monkeypatch.setattr(fa, "_fn", refusing)
    monkeypatch.setattr(ref, "flash_attention",
                        lambda *a, **k: calls.append("plain"))
    q, k, v = _qkv(torch.bfloat16, d)
    before = [c.count for c in fa.FWD_COUNTERS]
    with pytest.raises(RuntimeError, match="flash_attention_forward_bf16_"
                                           "wgmma launch failed"):
        fa._launch(q, k, v, False, 0.125, 0, True)
    assert calls == ["flash_attention_forward_bf16_wgmma"]
    assert [c.count for c in fa.FWD_COUNTERS] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _stream():
    return torch.cuda.current_stream().cuda_stream


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 4, 4, 256, 256, 64),      # rep 1
    (2, 16, 8, 512, 512, 64),     # granite's heads, rep 2
    (2, 7, 1, 512, 512, 64),      # rep 7
    (1, 7, 1, 333, 200, 64),      # rep 7, ragged, Sq > Skv
    (1, 8, 2, 200, 333, 64),      # Sq < Skv
    (1, 1, 1, 64, 64, 64),        # one warpgroup's rows
    (1, 2, 1, 4113, 4113, 64),    # 4,096 + 17
    (2, 8, 8, 256, 256, 128),     # rep 1
    (1, 8, 4, 512, 512, 128),     # rep 2
    (1, 28, 4, 200, 200, 128),    # qwen2-7b's heads, rep 7
    (1, 7, 1, 333, 200, 128),
    (1, 4, 2, 200, 333, 128),
    (1, 2, 2, 100, 100, 128),
])
def test_wgmma_forward_matches_plain(cuda_device, b, hq, hkv, sq, skv, d,
                                     causal):
    """The wgmma route against the plain forward on the same q, k, v: out
    within 2e-2, lse within ``ref.FLASH_LSE_TOL``; a second call bitwise
    the first; one count on the wgmma counter a call, none elsewhere."""
    q, k, v = _qkv(torch.bfloat16, d, b, hq, hkv, sq, skv, seed=d + sq,
                   device=cuda_device)
    scale = d ** -0.5
    before = [c.count for c in fa.FWD_COUNTERS]
    out, lse = fa._forward(q, k, v, causal, scale, with_lse=True)
    again, lse2 = fa._forward(q, k, v, causal, scale, with_lse=True)
    want, want_lse = ref.flash_attention(q, k, v, causal, scale,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert [c.count for c in fa.FWD_COUNTERS] == [
        n + 2 * (c is fa.fwd_wgmma_counter)
        for n, c in zip(before, fa.FWD_COUNTERS)]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    torch.testing.assert_close(out.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert float((lse - want_lse).abs().max()) <= ref.FLASH_LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_forced_mma_sync_forward_matches_plain(cuda_device, d):
    """``mma_sync=True`` at D 64 and 128 launches the mma.sync entry; both
    routes stay within the bound of the plain forward, their lse within
    ``ref.FLASH_LSE_TOL``."""
    q, k, v = _qkv(torch.bfloat16, d, 1, 8, 2, 300, 300, seed=7,
                   device=cuda_device)
    scale = d ** -0.5
    before = [c.count for c in fa.FWD_COUNTERS]
    old = fa._launch(q, k, v, True, scale, _stream(), True, mma_sync=True)
    new = fa._launch(q, k, v, True, scale, _stream(), True)
    want, want_lse = ref.flash_attention(q, k, v, True, scale,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(fa.FWD_COUNTERS, before)] == [1, 1, 0]
    for out, lse in (old, new):
        torch.testing.assert_close(out.float(), want.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        assert float((lse - want_lse).abs().max()) <= ref.FLASH_LSE_TOL


@pytest.mark.cuda
def test_wgmma_forward_from_a_fresh_thread(cuda_device):
    """A call from a thread on which no CUDA call has run yet (autograd's
    recompute under remat runs on such a thread) launches and is bitwise
    the main thread's."""
    q, k, v = _qkv(torch.bfloat16, 128, 1, 4, 2, 256, 256, seed=3,
                   device=cuda_device)
    want = fa._forward(q, k, v, True, 128 ** -0.5)
    got = {}

    def run():
        try:
            with torch.cuda.device(q.device):
                got["out"] = fa._forward(q, k, v, True, 128 ** -0.5)
                torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 (re-raised below)
            got["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    assert torch.equal(got["out"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_function_backward_from_the_wgmma_forward(cuda_device, d):
    """The autograd Function at D 64 and 128: the wgmma forward and the
    wgmma backward launch once each, and the gradients (the backward fed by
    this forward's out and lse) are within ``ref.FLASH_BWD_TOL`` of max
    |plain| of the plain backward from the same out and lse."""
    q, k, v = _qkv(torch.bfloat16, d, 2, 8, 2, 384, 384, seed=11,
                   device=cuda_device)
    grad = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(12), device=cuda_device).bfloat16()
    scale = d ** -0.5
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (*fa.FWD_COUNTERS, fa.bwd_wgmma_counter, fa.bwd_tc_counter,
                fa.bwd_f32_counter)
    before = [c.count for c in counters]
    out = fa.flash_attention(*ins, True, scale, 128, 128)
    got = torch.autograd.grad(out, ins, grad)
    assert [c.count - n for c, n in zip(counters, before)] == [
        1, 0, 0, 1, 0, 0]
    fout, lse = fa._forward(q, k, v, True, scale, with_lse=True)
    assert torch.equal(fout, out)
    want = ref.flash_attention_bwd(q, k, v, fout, lse, grad, True, scale)
    torch.cuda.synchronize()
    errs = [float((a.float() - b.float()).abs().max())
            / float(b.float().abs().max()) for a, b in zip(got, want)]
    assert max(errs) <= ref.FLASH_BWD_TOL[torch.bfloat16]
