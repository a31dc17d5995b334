"""The port's MoE, Mamba and RWKV families (``repro_torch.models.moe``,
``ssm``, ``rwkv`` and their model assembly) against the JAX package's.

Parameters come from JAX's ``init_params`` and cross with
``interop.lm_params_from_numpy``; inputs are numpy draws from a seed.
Bounds, relative to the reference's max |value|: 1e-4 in f32 compute (the
same f32 arithmetic summed in another order); in bf16 0.03 (``PERF.md`` §2,
as ``tests/test_arch_smoke.py``: a bf16 rounding that falls the other way
in one layer moves the next layer's inputs by an ulp). The router's top-k
is held as a set (``torch.topk`` and ``lax.top_k`` may order exact ties
differently). ``jamba-1.5-large-398b``'s smoke model runs under ``-m slow``
only, as in ``tests/test_arch_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

FAMILIES = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b",
            "jamba-1.5-large-398b")
BOUND = {"float32": 1e-4, "bfloat16": 0.03}
B, S = 2, 32


def _cases(ids=FAMILIES):
    return [pytest.param(a, marks=pytest.mark.slow)
            if a == "jamba-1.5-large-398b" else a for a in ids]


def _cfgs(arch, compute="bfloat16"):
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                                compute_dtype=compute),
            dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                                compute_dtype=compute))


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jconfigs.get_config(arch, smoke=True)
            p = jparams.init_params(jmodel.model_specs(cfg), jax.random.key(0))
            cache[arch] = jax.tree.map(np.asarray, p)
        return cache[arch]

    return get


def _block_params(specs, seed: int, perturb=()):
    """JAX-initialised parameters of one unstacked block (numpy), with the
    leaves in ``perturb`` (zeros at init) drawn N(0, 0.1²) so their paths
    are exercised."""
    p = jax.tree.map(np.asarray, jparams.init_params(specs,
                                                     jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for name in perturb:
        p[name] = (rng.normal(size=p[name].shape) * 0.1).astype(np.float32)
    return p


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-6))


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_ffn_matches_jax(arch, compute):
    jcfg, tcfg = _cfgs(arch, compute)
    p = _block_params(jmodel._moe_specs(jcfg), 1)
    jx, tx = _x((B, S, jcfg.d_model), 2, compute)
    want, jaux = jmoe.moe_ffn(jcfg, jax.tree.map(jnp.asarray, p), jx)
    got, taux = tmoe.moe_ffn(tcfg, interop.lm_params_from_numpy(p, "cpu"), tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _rel(got, want) <= BOUND[compute]
    for name in ("load_balance_loss", "router_z_loss", "expert_load"):
        np.testing.assert_allclose(getattr(taux, name).numpy(),
                                   np.asarray(getattr(jaux, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(taux.expert_load.sum()) == pytest.approx(1.0, abs=1e-6)


def test_moe_router_selects_the_same_set():
    """The top-k expert set of every token equals ``lax.top_k``'s on the
    same probabilities, and the slots count earlier tokens per expert."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", "float32")
    p = _block_params(jmodel._moe_specs(jcfg), 3)
    jx, tx = _x((B, 64, jcfg.d_model), 4, "float32")
    r = tmoe.route(tcfg, interop.lm_params_from_numpy(p, "cpu"), tx)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jx,
                                      jnp.asarray(p["router"])), axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    np.testing.assert_array_equal(np.sort(r.experts.numpy(), axis=-1),
                                  np.sort(np.asarray(idx), axis=-1))
    np.testing.assert_allclose(r.probs.numpy(), np.asarray(probs), rtol=1e-5,
                               atol=1e-7)
    e = r.experts.numpy()
    for b in range(B):
        for s in (0, 17, 63):
            for j in range(jcfg.experts_per_token):
                assert r.slot[b, s, j] == int((e[b, :s] == e[b, s, j]).sum())


def test_moe_capacity_drops_the_same_pairs():
    """A router that sends every token to the same k experts (expert 0
    first): each expert keeps the first C tokens of a sequence and drops
    the rest, in both packages; the dropped tokens' outputs are zero."""
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b", "float32")
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0)
    d, e = jcfg.d_model, jcfg.num_experts
    p = _block_params(jmodel._moe_specs(jcfg), 5)
    p["router"] = np.outer(np.ones(d), np.arange(e, 0, -1) * 2.0).astype(
        np.float32) / d
    x = np.abs(np.random.default_rng(6).normal(size=(B, S, d))) + 0.1
    x = x.astype(np.float32)
    c = tmoe._capacity(tcfg, S)
    assert c == jmoe._capacity(jcfg, S) == S * jcfg.experts_per_token // e
    tp = interop.lm_params_from_numpy(p, "cpu")
    r = tmoe.route(tcfg, tp, torch.from_numpy(x))
    assert (r.experts == torch.arange(jcfg.experts_per_token)).all()
    assert torch.equal(r.keep, (torch.arange(S) < c)[None, :, None].expand(
        B, S, jcfg.experts_per_token))
    want, _ = jmoe.moe_ffn(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    assert _rel(got, want) <= BOUND["float32"]
    assert not bool(got[:, c:].any()) and bool(got[:, :c].any())
    assert not np.asarray(want)[:, c:].any()


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_block_matches_jax_prefill_and_decode(compute):
    """A 32-token prefill (chunked scan, 4 chunks), then a cached 8-token
    prefill and 4 one-token decode steps carrying the conv window and SSM
    state, each against JAX's."""
    jcfg, tcfg = _cfgs("jamba-1.5-large-398b", compute)
    p = _block_params(jmodel._mamba_specs(jcfg), 7)
    jp, tp = jax.tree.map(jnp.asarray, p), interop.lm_params_from_numpy(
        p, "cpu")
    jx, tx = _x((B, S, jcfg.d_model), 8, compute)
    want, _ = jssm.mamba_block(jcfg, jp, jx)
    got, none = tssm.mamba_block(tcfg, tp, tx)
    assert none is None and _rel(got, want) <= BOUND[compute]
    jc, tc = jssm.init_cache(jcfg, B), tssm.init_cache(tcfg, B, "cpu")
    for a, b in [(0, 8)] + [(t, t + 1) for t in range(8, 12)]:
        want, jc = jssm.mamba_block(jcfg, jp, jx[:, a:b], cache=jc)
        got, tc = tssm.mamba_block(tcfg, tp, tx[:, a:b], cache=tc)
        assert _rel(got, want) <= BOUND[compute]
        assert tc.conv.dtype == tx.dtype and tc.ssm.dtype == torch.float32
        assert _rel(tc.ssm, jc.ssm) <= BOUND["float32"]
        assert _rel(tc.conv, jc.conv) <= BOUND[compute]


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    prev = rng.normal(size=(2, 6, 3)).astype(np.float32)
    for pv in (None, prev):
        jy, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if pv is None else jnp.asarray(pv))
        ty, ts = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if pv is None else torch.from_numpy(pv))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ssm_scan_matches_jax_and_the_recurrence():
    rng = np.random.default_rng(10)
    a = np.exp(-rng.uniform(0.0, 0.3, size=(2, 24, 5, 3))).astype(np.float32)
    u = rng.normal(size=(2, 24, 5, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    jh, jl = jssm._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(u), 8,
                                    h0=jnp.asarray(h0))
    th, tl = tssm._ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(u),
                                    8, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        tssm._ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(u), 7)


def test_ssm_scan_stays_finite_where_the_jax_scan_overflows():
    """A chunk whose Σ log a passes −88.7: JAX's cumulative-product form
    divides by exp(cum), which overflows f32, and returns NaN; the port
    splits the chunk and equals the step-by-step recurrence (ROADMAP queue
    3: jamba's own initialisation reaches this at its 256-step chunk)."""
    rng = np.random.default_rng(11)
    a = np.exp(-rng.uniform(0.4, 1.6, size=(1, 256, 4, 2))).astype(np.float32)
    u = rng.normal(size=(1, 256, 4, 2)).astype(np.float32) * 0.01
    jh, _ = jssm._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(u), 256)
    assert np.isnan(np.asarray(jh)).any()
    th, tl = tssm._ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(u),
                                    256)
    h = torch.zeros((1, 4, 2))
    want = []
    for t in range(256):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(u[:, t])
        want.append(h)
    want = torch.stack(want, dim=1)
    assert bool(torch.isfinite(th).all())
    torch.testing.assert_close(th, want, rtol=1e-4, atol=1e-6)
    assert torch.equal(tl, th[:, -1])


@pytest.mark.parametrize("chunk,steps,want", [
    (256, 0.05, 256),   # Σ log a = -12.8 a chunk: JAX's own chunking
    (256, 0.5, 128),    # -128 a chunk, -64 a half
    (256, 3.0, 16),     # -48 over 16 steps, -96 over 32
    (24, 20.0, 3),      # 24 → 12 → 6 → 3 (odd): -60 over 3 steps
    (24, 30.0, 1),      # -90 over 3 steps: single steps
    (1, 100.0, 1)])
def test_ssm_scan_piece_is_read_once_a_call(chunk, steps, want):
    """The scan's piece length: the longest of chunk, chunk/2, … (while
    even), then 1, whose every Σ log a stays within SCAN_LOG_SPAN. Unsplit,
    the scan is JAX's; split, it equals the step-by-step recurrence."""
    a = torch.full((1, 768, 2, 3), float(np.exp(-steps)))
    log_a = torch.log(torch.clamp(a, min=1e-37))
    assert tssm._piece_len(log_a, chunk) == want
    u = torch.from_numpy(np.random.default_rng(12).normal(
        size=(1, 768, 2, 3)).astype(np.float32))
    th, tl = tssm._ssm_scan_chunked(a, u, chunk)
    assert torch.equal(tl, th[:, -1])
    if want == chunk:
        jh, _ = jssm._ssm_scan_chunked(jnp.asarray(a.numpy()),
                                       jnp.asarray(u.numpy()), chunk)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-5)
        return
    h, rows = torch.zeros((1, 2, 3)), []
    for t in range(768):
        h = a[:, t] * h + u[:, t]
        rows.append(h)
    torch.testing.assert_close(th, torch.stack(rows, 1), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("module", [tssm, trwkv])
def test_family_caches_resolve_their_device(module):
    """``init_cache`` resolves its device as every allocating entry point
    of the port does: None is the card, and raises without one; the CPU
    only when asked."""
    arch = "jamba-1.5-large-398b" if module is tssm else "rwkv6-1.6b"
    cfg = tconfigs.get_config(arch, smoke=True)
    cache = module.init_cache(cfg, 2, "cpu")
    assert all(t.device.type == "cpu" and not bool(t.any()) for t in cache)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.init_cache(cfg, 2)


# ---------------------------------------------------------------------------
# RWKV
# ---------------------------------------------------------------------------

_RWKV_LORA = ("mix_lora_b", "decay_lora_b")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [32, 7])
def test_time_mix_and_channel_mix_match_jax(s, compute):
    """S = 32 takes the chunked wkv, S = 7 the scan; with a cache, the
    cached continuation and the token shifts; channel-mix reads the cache
    time-mix has just updated, as the model wires them."""
    jcfg, tcfg = _cfgs("rwkv6-1.6b", compute)
    pt = _block_params(jmodel._rwkv_specs(jcfg), 12, _RWKV_LORA)
    pt["bonus"] = (np.random.default_rng(13).normal(size=pt["bonus"].shape)
                   * 0.5).astype(np.float32)
    pc = _block_params(jmodel._cmix_specs(jcfg), 14)
    jpt, tpt = jax.tree.map(jnp.asarray, pt), interop.lm_params_from_numpy(
        pt, "cpu")
    jpc, tpc = jax.tree.map(jnp.asarray, pc), interop.lm_params_from_numpy(
        pc, "cpu")
    jx, tx = _x((B, s, jcfg.d_model), 15, compute)
    want, _ = jrwkv.time_mix(jcfg, jpt, jx)
    got, _ = trwkv.time_mix(tcfg, tpt, tx)
    assert _rel(got, want) <= BOUND[compute]
    want, _ = jrwkv.channel_mix(jcfg, jpc, jx)
    got, _ = trwkv.channel_mix(tcfg, tpc, tx)
    assert _rel(got, want) <= BOUND[compute]
    jc, tc = jrwkv.init_cache(jcfg, B), trwkv.init_cache(tcfg, B, "cpu")
    for a, b in ((0, s), (s, s + 1)):
        jy, tyx = _x((B, b - a, jcfg.d_model), 16 + a, compute)
        jo, jc = jrwkv.time_mix(jcfg, jpt, jy, cache=jc)
        to, tc = trwkv.time_mix(tcfg, tpt, tyx, cache=tc)
        assert _rel(to, jo) <= BOUND[compute]
        jo, jc = jrwkv.channel_mix(jcfg, jpc, jy, cache=jc)
        to, tc = trwkv.channel_mix(tcfg, tpc, tyx, cache=tc)
        assert _rel(to, jo) <= BOUND[compute]
        assert _rel(tc.wkv, jc.wkv) <= BOUND[compute]
        assert torch.equal(tc.shift, tyx[:, -1])
        assert torch.equal(tc.cmix_shift, tyx[:, -1])


def test_wkv_chunked_equals_scan():
    rng = np.random.default_rng(17)
    r, k, v = (torch.from_numpy(rng.normal(size=(2, 48, 3, 8)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(rng.uniform(-8, 1, size=(
        2, 48, 3, 8)))).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    oc, sc = trwkv._wkv_chunked(r, k, v, w, u, s0)
    os_, ss = trwkv._wkv_scan(r, k, v, w, u, s0)
    torch.testing.assert_close(oc, os_, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sc, ss, rtol=1e-4, atol=1e-4)
    jo, js = jrwkv._wkv_chunked(*(jnp.asarray(t.numpy())
                                  for t in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(oc.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    # A length off the chunk falls back to the scan, as in JAX.
    o7, _ = trwkv._wkv_chunked(r[:, :7], k[:, :7], v[:, :7], w[:, :7], u, s0)
    assert torch.equal(o7, trwkv._wkv_scan(r[:, :7], k[:, :7], v[:, :7],
                                           w[:, :7], u, s0)[0])


# ---------------------------------------------------------------------------
# The four architectures end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", _cases())
def test_forward_matches_jax(arch, compute, jax_params):
    """Logits within the bound, and the MoE losses and per-block expert
    load (each row summing to 1) within 1e-5 of JAX's."""
    jcfg, tcfg = _cfgs(arch, compute)
    tcfg = dataclasses.replace(tcfg, attn_impl="flash")
    np_params = jax_params(arch)
    toks = _tokens(tcfg, 1)
    want = jmodel.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                          tokens=jnp.asarray(toks))
    got = tmodel.forward(tcfg, interop.lm_params_from_numpy(np_params, "cpu"),
                         tokens=torch.from_numpy(toks).long())
    assert got.logits.shape == (B, S, tcfg.vocab_size)
    assert got.logits.dtype == getattr(torch, compute)
    assert _rel(got.logits, want.logits) <= BOUND[compute]
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-5)
    if tcfg.num_experts:
        assert float(got.aux_loss) > 0.0
        np.testing.assert_allclose(got.expert_load.numpy(),
                                   np.asarray(want.expert_load), atol=1e-6)
        torch.testing.assert_close(got.expert_load.sum(-1),
                                   torch.ones(got.expert_load.shape[0]))
    else:
        assert got.expert_load is None and want.expert_load is None
        assert float(got.aux_loss) == 0.0


@pytest.mark.parametrize("arch", _cases())
def test_decode_step_matches_jax(arch, jax_params):
    """Eight one-token steps from an empty cache, then a 4-token step:
    logits within the bf16 bound of JAX's, and every cache entry (KV, conv
    window, SSM and wkv states, token shifts) beside JAX's new cache."""
    jcfg, tcfg = _cfgs(arch)
    np_params = jax_params(arch)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = interop.lm_params_from_numpy(np_params, "cpu")
    toks = _tokens(tcfg, 5, s=12)
    jc = jmodel.init_decode_cache(jcfg, B, 16)
    tc = tmodel.init_decode_cache(tcfg, B, 16, device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        {b: {k: {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for n, t in d.items()} for k, d in blk.items()}
         for b, blk in tc.items()}
    for a, b in [(t, t + 1) for t in range(8)] + [(8, 12)]:
        jl, jc = jmodel.decode_step(jcfg, jp, jc, jnp.int32(a),
                                    tokens=jnp.asarray(toks[:, a:b]))
        tl, tc2 = tmodel.decode_step(tcfg, tp, tc, a,
                                     tokens=torch.from_numpy(
                                         toks[:, a:b]).long())
        assert tc2 is tc                   # written in place
        assert _rel(tl, jl) <= BOUND["bfloat16"]
    for blk, entries in tc.items():
        for kind, state in entries.items():
            for name, t in state.items():
                want = np.asarray(jc[blk][kind][name], np.float32)
                got = t.float().numpy()
                if kind == "attn":
                    got, want = got[..., :12, :], want[..., :12, :]
                np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2,
                                           err_msg=f"{blk} {kind} {name}")


@pytest.mark.parametrize("arch", _cases())
def test_decode_matches_forward(arch, jax_params):
    """The port's one-token decode loop reproduces its own forward within
    0.03 of max |logit| (bf16), as tests/test_arch_smoke.py holds JAX's."""
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                              attn_impl="flash")
    params = interop.lm_params_from_numpy(jax_params(arch), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 4, s=16)).long()
    full = tmodel.forward(cfg, params, tokens=toks).logits.float()
    cache = tmodel.init_decode_cache(cfg, B, 16, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = tmodel.decode_step(cfg, params, cache, t,
                                       tokens=toks[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1).float()
    scale = float(full.abs().max()) + 1e-6
    assert float((full - dec).abs().max()) / scale < 0.03


def test_interop_carries_the_family_trees(jax_params):
    """Router and per-expert wi/wg/wo, Mamba and RWKV leaves cross with
    their keys, shapes and values (bf16 through f32 without loss)."""
    for arch in ("granite-moe-1b-a400m", "rwkv6-1.6b"):
        p = jax_params(arch)
        t = interop.lm_params_from_numpy(p, "cpu")
        want = dict(jparams.tree_paths(jax.tree.map(
            lambda a: jparams.ParamSpec(a.shape, (None,) * a.ndim), p)))
        got = dict(tparams.tree_paths(t))
        assert got.keys() == want.keys()
        for path, leaf in got.items():
            node = p
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(leaf.numpy(), node)
    cfg = dataclasses.replace(jconfigs.get_config("jamba-1.5-large-398b",
                                                  smoke=True),
                              param_dtype="bfloat16")
    p = jax.tree.map(np.asarray, jparams.init_params(
        jmodel._mamba_specs(cfg), jax.random.key(1)))
    t = interop.lm_params_from_numpy(p, "cpu")
    assert {k: v.dtype for k, v in t.items()} == \
        {k: torch.bfloat16 for k in p}
    for k in p:
        np.testing.assert_array_equal(t[k].float().numpy(),
                                      p[k].astype(np.float32))


def test_family_initialisers():
    """uniform_fan within 1/sqrt(leading dim), A_log = log(1..N), and
    dt_bias the inverse softplus of dt in [1e-3, 0.1] (the JAX package's
    definitions; the draws are torch's)."""
    cfg = tconfigs.get_config("jamba-1.5-large-398b", smoke=True)
    specs = tmodel.model_specs(cfg)
    p = tparams.init_params(specs, torch.Generator().manual_seed(0),
                            device="cpu")
    m = p["groups"]["b0"]["mixer"]
    g = cfg.num_groups
    for name in ("conv_w", "dt_proj"):
        assert float(m[name].abs().max()) <= 1.0 / g ** 0.5
        assert float(m[name].std()) > 0.1 / g ** 0.5
    want = torch.log(torch.arange(1, cfg.ssm_state_dim + 1,
                                  dtype=torch.float32))
    assert torch.equal(m["a_log"], want.expand_as(m["a_log"]))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    assert tparams.param_count(specs) == jparams.param_count(
        jmodel.model_specs(jconfigs.get_config("jamba-1.5-large-398b",
                                               smoke=True)))
