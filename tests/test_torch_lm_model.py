"""The port's LM serving path against the JAX package's
(``repro.models.model``), on the six dense smoke configs.

Parameters come from JAX's ``init_params(model_specs(SMOKE), key(0))`` and
cross with ``interop.lm_params_from_numpy``; tokens and frame embeddings
are numpy draws from a seed. The port runs ``attn_impl="flash"`` (on the CPU
the kernel's plain version); JAX runs its default ``"chunked"`` (its flash
kernel cannot run on the installed jax). Bounds, relative to max |logit|:
1e-4 in f32 compute (two layers of the same f32 arithmetic summed in another
order), 0.03 in bf16 (the bound ``tests/test_arch_smoke.py`` uses for bf16
path differences: the flash path keeps q·scale and p in f32 where chunked
rounds them to bf16, and a bf16 rounding that falls the other way in one
layer moves the next layer's inputs by an ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams

ARCHS = ("qwen2-7b", "starcoder2-7b", "stablelm-12b", "nemotron-4-340b",
         "llava-next-34b", "hubert-xlarge")
B, S = 2, 32


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


def _inputs(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    if cfg.uses_token_embedding:
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    return {"embeddings": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)}


def _jax_in(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _port_in(inputs):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in inputs.items()}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("compute,bound", [("float32", 1e-4),
                                           ("bfloat16", 0.03)])
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_forward_matches_jax_chunked(arch, compute, bound, jax_params):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               compute_dtype=compute)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               compute_dtype=compute, attn_impl="flash")
    np_params = jax_params(arch)
    inputs = _inputs(tcfg, 1)
    want = jmodel.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                          **_jax_in(inputs)).logits
    before = (fa.tc_counter.count, fa.f32_counter.count)
    out = tmodel.forward(tcfg, interop.lm_params_from_numpy(np_params, "cpu"),
                         **_port_in(inputs))
    # the CPU runs the plain version
    assert (fa.tc_counter.count, fa.f32_counter.count) == before
    assert out.logits.shape == (B, S, tcfg.vocab_size)
    assert out.logits.dtype == getattr(torch, compute)
    assert float(out.aux_loss) == 0.0
    assert _rel(out.logits, want) <= bound


@pytest.mark.parametrize("arch", ["qwen2-7b", "starcoder2-7b"])
def test_decode_matches_forward(arch, jax_params):
    """The port's one-token decode loop reproduces its own flash forward
    (bf16; 0.03 of max |logit|, as tests/test_arch_smoke.py)."""
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                              attn_impl="flash")
    params = interop.lm_params_from_numpy(jax_params(arch), "cpu")
    toks = _port_in(_inputs(cfg, 4, s=16))["tokens"]
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
    # the cache holds every step's keys, written in place
    k = cache["b0"]["attn"]["k"]
    assert k.shape == (cfg.num_groups, B, cfg.num_kv_heads, 16,
                       cfg.resolved_head_dim)
    assert bool((k.abs().sum(dim=-1) > 0).all())


@pytest.mark.parametrize("arch", ["qwen2-7b", "starcoder2-7b"])
def test_decode_step_matches_jax(arch, jax_params):
    """Eight decode steps, then one 4-token step (not causal within its
    chunk, in both packages): the port's logits against JAX's, bf16 bound."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    np_params = jax_params(arch)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = interop.lm_params_from_numpy(np_params, "cpu")
    toks = _inputs(tcfg, 5, s=12)["tokens"]
    jc = jmodel.init_decode_cache(jcfg, B, 16)
    tc = tmodel.init_decode_cache(tcfg, B, 16, device="cpu")
    steps = [(t, t + 1) for t in range(8)] + [(8, 12)]
    for a, b in steps:
        jl, jc = jmodel.decode_step(jcfg, jp, jc, jnp.int32(a),
                                    tokens=jnp.asarray(toks[:, a:b]))
        tl, tc = tmodel.decode_step(tcfg, tp, tc, a,
                                    tokens=torch.from_numpy(toks[:, a:b]).long())
        assert tl.shape == (B, b - a, tcfg.vocab_size)
        assert _rel(tl, jl) <= 0.03
    np.testing.assert_allclose(
        tc["b0"]["attn"]["k"][:, :, :, :12].float().numpy(),
        np.asarray(jc["b0"]["attn"]["k"][:, :, :, :12], np.float32),
        rtol=2e-2, atol=2e-2)


def test_causal_lm_is_causal(jax_params):
    """qwen2: flipping the last token leaves every earlier logit unchanged."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True),
                              attn_impl="flash")
    params = interop.lm_params_from_numpy(jax_params("qwen2-7b"), "cpu")
    toks = _port_in(_inputs(cfg, 6, b=1))["tokens"]
    out1 = tmodel.forward(cfg, params, tokens=toks).logits
    toks2 = toks.clone()
    toks2[:, -1] = (toks2[:, -1] + 1) % cfg.vocab_size
    out2 = tmodel.forward(cfg, params, tokens=toks2).logits
    assert torch.equal(out1[:, :-1], out2[:, :-1])
    assert not torch.equal(out1[:, -1], out2[:, -1])


def test_encoder_is_bidirectional(jax_params):
    """hubert: flipping a late frame changes the logits of the first."""
    cfg = dataclasses.replace(tconfigs.get_config("hubert-xlarge", smoke=True),
                              attn_impl="flash")
    params = interop.lm_params_from_numpy(jax_params("hubert-xlarge"), "cpu")
    emb = _port_in(_inputs(cfg, 7, b=1))["embeddings"]
    out1 = tmodel.forward(cfg, params, embeddings=emb).logits
    emb2 = emb.clone()
    emb2[:, -1] = -emb2[:, -1]
    out2 = tmodel.forward(cfg, params, embeddings=emb2).logits
    assert float((out1 - out2)[:, 0].float().abs().max()) > 1e-6


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_unported_archs_raise(arch):
    """The four architectures that raised until their MoE, Mamba and RWKV
    blocks were ported now build and run: their configs equal JAX's, their
    smoke models initialise on the CPU, run a finite forward and one decode
    step from a fresh cache."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    for smoke in (False, True):
        assert dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
    tcfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    params = tparams.init_params(tmodel.model_specs(tcfg),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    toks = _port_in(_inputs(tcfg, 9, s=16))["tokens"]
    out = tmodel.forward(tcfg, params, tokens=toks)
    assert out.logits.shape == (B, 16, tcfg.vocab_size)
    assert bool(torch.isfinite(out.logits.float()).all())
    assert (float(out.aux_loss) > 0.0) == bool(tcfg.num_experts)
    cache = tmodel.init_decode_cache(tcfg, B, 8, device="cpu")
    logits, _ = tmodel.decode_step(tcfg, params, cache, 0, tokens=toks[:, :1])
    assert logits.shape == (B, 1, tcfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_interop_carries_bf16_params_and_configs(jax_params):
    """A bf16 JAX tree (ml_dtypes leaves, which torch.from_numpy refuses)
    crosses through f32 without loss; configs cross as dicts."""
    cfg = dataclasses.replace(jconfigs.get_config("qwen2-7b", smoke=True),
                              param_dtype="bfloat16")
    p = jax.tree.map(np.asarray, jparams.init_params(jmodel.model_specs(cfg),
                                                     jax.random.key(3)))
    assert p["embed"].dtype.name == "bfloat16"
    t = interop.lm_params_from_numpy(p, "cpu")
    assert t["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["embed"].float().numpy(),
                                  p["embed"].astype(np.float32))
    assert t["groups"]["b0"]["mixer"]["wq"].shape == \
        p["groups"]["b0"]["mixer"]["wq"].shape
    f32 = interop.lm_params_from_numpy(p, "cpu", dtype=torch.float32)
    assert f32["embed"].dtype == torch.float32
    back = interop.model_config_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)


def test_lm_module_holds_the_params(jax_params):
    """The thin module gives the same logits as the functions, and its
    decode methods run on the device of its buffers."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True),
                              attn_impl="flash")
    params = interop.lm_params_from_numpy(jax_params("qwen2-7b"), "cpu")
    lm = tmodel.LM(cfg, params)
    assert len(list(lm.buffers())) == len(list(
        tmodel.tree_paths(params)))
    toks = _port_in(_inputs(cfg, 8))["tokens"]
    assert torch.equal(lm(tokens=toks).logits,
                       tmodel.forward(cfg, params, tokens=toks).logits)
    cache = lm.init_decode_cache(B, 4)
    logits, cache = lm.decode_step(cache, 0, tokens=toks[:, :1])
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert lm.params.keys() == params.keys()
