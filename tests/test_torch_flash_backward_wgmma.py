"""Kernel E's backward routes: the wgmma entry
(``csrc/flash_attention_bwd_wgmma.cu``, bfloat16 at head dims 64 and 128)
beside the mma.sync and f32 entries (``csrc/flash_attention_bwd.cu``).

* On the CPU: the route table. ``_launch_bwd`` with the entries replaced
  by stand-ins (no card) calls the entry ``bwd_route`` names for every
  (dtype, D), from the library ``BWD_LIBRARIES`` names, bumps that entry's
  counter alone, and ``mma_sync=True`` sends bfloat16 at D 64 and 128 to
  the mma.sync entry and changes nothing else; a refused launch raises
  and counts nothing.
* On the card (``-m cuda``; each test skips without one): the wgmma
  route against the plain backward (``ref.flash_attention_bwd``) within
  ``ref.FLASH_BWD_TOL`` at D 64 and 128, GQA rep 1, 2, 4 and 7, Sq above
  and below Skv, ragged lengths (100, 200, 333, 4,096 + 17), causal and
  not; two calls bitwise equal; the route counters (the wgmma entry at D
  64 and 128, the mma.sync entry at D 80 and 160 and when forced).

The file imports neither JAX nor the JAX package. Run the card tests with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_backward_wgmma.py
"""
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

COUNTERS = (fa.bwd_wgmma_counter, fa.bwd_tc_counter, fa.bwd_f32_counter)
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 144, 160, 192, 256)


def _inputs(dtype, d, b=1, hq=4, hkv=2, sq=64, skv=64, causal=True,
            seed=0):
    """q, k, v, dO from a seeded generator on the CPU, and the plain
    forward's out and lse."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(sh, generator=g).to(dtype) for sh in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))
    out, lse = ref.flash_attention(q, k, v, causal, d ** -0.5,
                                   return_lse=True)
    return q, k, v, out, lse, dout


def _expected(dtype, d, mma_sync):
    if dtype == torch.float32:
        return "flash_attention_backward_f32", fa.bwd_f32_counter
    if d in (64, 128) and not mma_sync:
        return "flash_attention_backward_bf16_wgmma", fa.bwd_wgmma_counter
    return "flash_attention_backward_bf16", fa.bwd_tc_counter


@pytest.mark.parametrize("mma_sync", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route_table(monkeypatch, dtype, d, mma_sync):
    """Each (dtype, D), with and without the forced mma.sync route: the
    entry called, its library, the shape it is given, and the one counter
    bumped once."""
    calls = []

    def fake_fn(entry):
        def launch(*args):
            calls.append((entry, args))
            return 0
        return launch

    monkeypatch.setattr(fa, "_bwd_fn", fake_fn)
    entry, counter = _expected(dtype, d, mma_sync)
    assert fa.bwd_route(dtype, d, mma_sync) == (entry, counter)
    assert _build.SOURCES[fa.BWD_LIBRARIES[entry]] == (
        "flash_attention_bwd_wgmma.cu" if counter is fa.bwd_wgmma_counter
        else "flash_attention_bwd.cu")
    q, k, v, out, lse, dout = _inputs(dtype, d)
    before = [c.count for c in COUNTERS]
    dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, dout, True, 0.25, 5,
                                mma_sync=mma_sync)
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert args[6:9] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[10:16] == (1, 4, 2, 64, 64, d) and args[17:] == (1, 5)
    assert [c.count for c in COUNTERS] == [
        n + (c is counter) for n, c in zip(before, COUNTERS)]


@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_route_refused_raises_and_counts_nothing(monkeypatch, d):
    """A launch the wgmma entry refuses raises with the entry's name; no
    other entry is tried and no counter moves."""
    calls = []

    def refusing(entry):
        def launch(*args):
            calls.append(entry)
            return 1
        return launch

    monkeypatch.setattr(fa, "_bwd_fn", refusing)
    q, k, v, out, lse, dout = _inputs(torch.bfloat16, d)
    before = [c.count for c in COUNTERS]
    with pytest.raises(RuntimeError, match="flash_attention_backward_bf16_"
                                           "wgmma launch failed"):
        fa._launch_bwd(q, k, v, out, lse, dout, False, 0.125, 0)
    assert calls == ["flash_attention_backward_bf16_wgmma"]
    assert [c.count for c in COUNTERS] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _rel_errs(got, want):
    return [float((a.float() - b.float()).abs().max())
            / float(b.float().abs().max()) for a, b in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 4, 4, 256, 256, 64),      # rep 1
    (2, 16, 8, 512, 512, 64),     # granite's heads, rep 2
    (1, 8, 2, 100, 100, 64),      # rep 4, ragged
    (1, 7, 1, 333, 200, 64),      # rep 7, Sq > Skv
    (1, 4, 2, 200, 333, 128),     # Sq < Skv
    (1, 28, 4, 200, 200, 128),    # qwen2-7b's heads, rep 7
    (1, 4, 4, 333, 333, 128),
    (1, 2, 1, 4113, 4113, 64),    # 4,096 + 17
    (1, 2, 2, 4113, 4113, 128),
    (1, 4, 2, 160, 96, 80),       # the mma.sync route
    (1, 6, 3, 100, 200, 160),
])
def test_wgmma_backward_matches_plain(cuda_device, b, hq, hkv, sq, skv, d,
                                      causal):
    """The route the wrapper takes for bf16 at D against the plain
    backward on the same q, k, v, out, lse and dO, within
    ``ref.FLASH_BWD_TOL``; a second call bitwise the first; one count on
    the route's counter a call, none elsewhere."""
    g = torch.Generator(device=cuda_device).manual_seed(d + sq)
    q, k, v, dout = (torch.randn(sh, generator=g, device=cuda_device)
                     .to(torch.bfloat16) for sh in (
        (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))
    scale = d ** -0.5
    out, lse = fa._forward(q, k, v, causal, scale, with_lse=True)
    mine = fa.bwd_wgmma_counter if d in (64, 128) else fa.bwd_tc_counter
    before = [c.count for c in COUNTERS]
    got = fa._backward(q, k, v, out, lse, dout, causal, scale)
    again = fa._backward(q, k, v, out, lse, dout, causal, scale)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)
    torch.cuda.synchronize()
    assert [c.count for c in COUNTERS] == [
        n + 2 * (c is mine) for n, c in zip(before, COUNTERS)]
    for x, y, w in zip(got, again, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape
        assert torch.equal(x, y)
    assert max(_rel_errs(got, want)) <= ref.FLASH_BWD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_forced_mma_sync_route_matches_plain(cuda_device, d):
    """``mma_sync=True`` at D 64 and 128 launches the mma.sync entry, and
    both routes stay within the bound of the plain backward."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, dout = (torch.randn(sh, generator=g, device=cuda_device)
                     .to(torch.bfloat16) for sh in (
        (1, 8, 300, d), (1, 2, 300, d), (1, 2, 300, d), (1, 8, 300, d)))
    scale = d ** -0.5
    out, lse = fa._forward(q, k, v, True, scale, with_lse=True)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    before = [c.count for c in COUNTERS]
    old = fa._launch_bwd(q, k, v, out, lse, dout, True, scale, stream,
                         mma_sync=True)
    new = fa._launch_bwd(q, k, v, out, lse, dout, True, scale, stream)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, True, scale)
    torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(COUNTERS, before)] == [1, 1, 0]
    tol = ref.FLASH_BWD_TOL[torch.bfloat16]
    assert max(_rel_errs(old, want)) <= tol
    assert max(_rel_errs(new, want)) <= tol
