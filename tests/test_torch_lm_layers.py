"""The port's LM layers, configs and parameter specs against the JAX
package's (``repro.models.layers``, ``repro.configs``,
``repro.models.model.model_specs``).

Inputs are numpy arrays from a seed, handed to both packages. Tolerances:
in f32 ≤ 1e-5 (the same operations, with sums and transcendental functions
rounded in another order or by another library: a few ulp); in bf16 one
bf16 ulp of the value (2^-7 relative at most): both packages round after the
same operations (norm and rope once, from f32; the activations after every
op, as XLA does on the CPU), and a few-ulp f32 difference can fall on either
side of a rounding boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams

BF16_ULP = 2.0 ** -7
ARCHS = ("qwen2-7b", "starcoder2-7b", "stablelm-12b", "nemotron-4-340b",
         "llava-next-34b", "hubert-xlarge")
#: The MoE, Mamba and RWKV architectures (their blocks' tests are in
#: tests/test_torch_lm_families.py).
FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m", "rwkv6-1.6b",
                "jamba-1.5-large-398b")


def _cfg(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw))


def _close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_less(
            np.abs(got - want), BF16_ULP * np.abs(want) + 1e-30 + (want == 0))


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind", [("qwen2-7b", "rmsnorm"),
                                       ("starcoder2-7b", "layernorm")])
def test_norm(arch, kind, dtype):
    jcfg, tcfg = _cfg(arch)
    assert tcfg.norm == kind
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, tcfg.d_model)).astype(np.float32) * 3
    scale = rng.normal(size=(tcfg.d_model,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(tcfg.d_model,)).astype(np.float32) * 0.1
    jx, tx = _pair(x, dtype)
    b = bias if kind == "layernorm" else None
    want = jlayers.norm(jcfg, jnp.asarray(scale), jx,
                        None if b is None else jnp.asarray(b))
    got = tlayers.norm(tcfg, torch.from_numpy(scale), tx,
                       None if b is None else torch.from_numpy(b))
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,act", [("qwen2-7b", "silu"),
                                      ("starcoder2-7b", "gelu"),
                                      ("nemotron-4-340b", "relu2")])
def test_activation(arch, act, dtype):
    """gelu is the tanh approximation in both (jax.nn.gelu's default)."""
    jcfg, tcfg = _cfg(arch)
    assert tcfg.activation == act
    x = np.random.default_rng(1).normal(size=(4, 257)).astype(np.float32) * 4
    jx, tx = _pair(x, dtype)
    _close(tlayers.activation(tcfg, tx), jlayers.activation(jcfg, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta, dtype):
    """theta ** (-i/half) in f32 in both; positions up to 63 keep the angle
    difference that a last-ulp frequency difference makes below 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(64), np.arange(64)[::-1]]).astype(np.int32)
    jx, tx = _pair(x, dtype)
    want = jlayers.rope(jx, jnp.asarray(pos), theta)
    got = tlayers.rope(tx, torch.from_numpy(pos), theta)
    _close(got, want, dtype)


@pytest.mark.parametrize("arch", ["qwen2-7b", "starcoder2-7b",
                                  "nemotron-4-340b"])
def test_mlp(arch):
    """Gated (SwiGLU) and plain (GELU, squared ReLU) MLPs in f32."""
    jcfg, tcfg = _cfg(arch)
    rng = np.random.default_rng(3)
    d, f = tcfg.d_model, tcfg.d_ff
    p = {"wi": rng.normal(size=(d, f)) * 0.1, "wo": rng.normal(size=(f, d)) * 0.1}
    if tcfg.gated_mlp:
        p["wg"] = rng.normal(size=(d, f)) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    want = jlayers.mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = tlayers.mlp(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    _close(got, want, "float32")


@pytest.mark.parametrize("s,cache_len", [(1, 1), (1, 23), (4, 40)])
def test_decode_attention(s, cache_len):
    """GQA decode over a 48-entry cache, f32; S > 1 is not causal within
    the chunk in either package (the reference's caveat)."""
    rng = np.random.default_rng(4 + s)
    q = rng.normal(size=(2, 6, s, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 2, 48, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 2, 48, 16)).astype(np.float32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(cache_len),
                                    scale=0.25)
    got = tlayers.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), cache_len, scale=0.25)
    _close(got, want, "float32")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", [
    (2, 6, 2, 256, 64, 64, 64),
    (1, 4, 4, 128, 32, 32, 64),
    (2, 8, 1, 128, 64, 64, 32),
    (1, 2, 2, 192, 16, 64, 64),
])
def test_chunked_attention(causal, b, hq, hkv, s, d, bq, bk):
    """The four shapes of tests/test_flash_attention.py, f32."""
    rng = np.random.default_rng(b + s)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    scale = 1.0 / d ** 0.5
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     q_chunk=bq, kv_chunk=bk, scale=scale)
    got = tlayers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    q_chunk=bq, kv_chunk=bk, scale=scale)
    _close(got, want, "float32")


def test_chunked_attention_bf16_returns_k_dtype():
    """bf16 in, bf16 out (k's dtype, as in JAX), within 2e-2 of JAX's: q·scale
    and p are rounded to bf16 in both, but their f32 sums may round apart."""
    rng = np.random.default_rng(9)
    arrays = [rng.normal(size=sh).astype(np.float32)
              for sh in ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32))]
    want = jlayers.chunked_attention(*[jnp.asarray(a, jnp.bfloat16)
                                       for a in arrays],
                                     causal=True, q_chunk=16, kv_chunk=32,
                                     scale=0.2)
    got = tlayers.chunked_attention(*[torch.from_numpy(a).bfloat16()
                                      for a in arrays],
                                    causal=True, q_chunk=16, kv_chunk=32,
                                    scale=0.2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_configs_equal_field_by_field(arch):
    for smoke in (False, True):
        want = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
        got = dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
        assert got == want
    full = tconfigs.get_config(arch)
    assert full.param_count() == jconfigs.get_config(arch).param_count()
    assert full.active_param_count() == \
        jconfigs.get_config(arch).active_param_count()


def test_qwen2_serving_config_size():
    """The headline configuration: 7.62 B parameters, 15.2 GB in bf16."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-7b"),
                              param_dtype="bfloat16")
    specs = tmodel.model_specs(cfg)
    assert tparams.param_count(specs) == cfg.param_count() == 7_615_616_512
    assert tparams.param_bytes(specs) == 2 * cfg.param_count()


def test_arch_ids_and_shapes_match():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ARCHS:
        for shape in tconfigs.SHAPES.values():
            jshape = jconfigs.SHAPES[shape.name]
            assert tconfigs.applicable(tconfigs.get_config(arch), shape) == \
                jconfigs.applicable(jconfigs.get_config(arch), jshape)


def _spec_leaves(tree):
    return {path: (tuple(s.shape), tuple(s.axes), s.init, s.dtype)
            for path, s in jparams.tree_paths(tree)}


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_model_specs_trees_equal(arch, smoke):
    """Same keys, shapes, axes, init kinds and dtypes, full and smoke."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=smoke),
                                   param_dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=smoke),
                                   param_dtype=dtype)
        want = _spec_leaves(jmodel.model_specs(jcfg))
        got = {path: (tuple(s.shape), tuple(s.axes), s.init, s.dtype)
               for path, s in tparams.tree_paths(tmodel.model_specs(tcfg))}
        assert got == want
        assert tparams.param_count(tmodel.model_specs(tcfg)) == \
            jparams.param_count(jmodel.model_specs(jcfg))


def test_init_params_kinds_and_dtypes():
    """The port's init on the CPU: the tree's keys, shapes and dtypes, zeros
    where the spec says zeros, N(0, 0.02²) and N(0, o_scale²) where it says
    normal and scaled (to 10 % of the std on thousands of draws), and the
    same numbers from the same seed."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-7b", smoke=True),
                              param_dtype="bfloat16")
    specs = tmodel.model_specs(cfg)
    p = tparams.init_params(specs, torch.Generator().manual_seed(0),
                            device="cpu")
    again = tparams.init_params(specs, torch.Generator().manual_seed(0),
                                device="cpu")
    leaves = dict(tparams.tree_paths(p))
    for path, spec in tparams.tree_paths(specs):
        t = leaves[path]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.bfloat16
        assert torch.equal(t, dict(tparams.tree_paths(again))[path])
        kind, _, arg = spec.init.partition(":")
        if kind == "zeros":
            assert not t.any()
        else:
            std = 0.02 if kind == "normal" else float(arg)
            assert abs(t.float().std().item() / std - 1) < 0.1, path


def test_init_params_draws_large_leaves_by_slice(monkeypatch):
    """Past ``SLICED_INIT_ELEMENTS`` a stacked leaf is drawn one leading
    slice at a time (no whole-leaf f32 copy); the numbers keep their law."""
    monkeypatch.setattr(tparams, "SLICED_INIT_ELEMENTS", 1000)
    spec = tparams.ParamSpec((3, 64, 32), (None, None, None), "normal",
                             "bfloat16")
    t = tparams.init_params({"w": spec}, torch.Generator().manual_seed(1),
                            device="cpu")["w"]
    assert t.shape == (3, 64, 32) and t.dtype == torch.bfloat16
    assert abs(t.float().std().item() / 0.02 - 1) < 0.1


def test_init_params_goes_to_the_card_unless_told():
    """No device means the card: without one it raises, never falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path does not apply")
    spec = {"w": tparams.ParamSpec((4,), (None,), "normal")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.init_params(spec, torch.Generator())
