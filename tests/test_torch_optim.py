"""The port's optimizer (``repro_torch.optim``) against the JAX package's
(``repro.optim``), on the CPU.

Inputs are numpy draws from a seed, fed to both packages. Bounds: the
8-bit codes and scales of one input are bitwise JAX's (f32 division and
round-half-to-even on both sides). After each of five AdamW steps the
parameters are within 2 f32 ulp of the leaf's largest magnitude (the
global norm sums in another order, and ``pow`` may round the other way);
the f32 moments within 8 such ulp, since the reference's compiled code
fuses the moment updates' multiply-adds (one rounding where the port
rounds twice) and m cancels (0.9·m + 0.1·g) to values far below the
leaf's largest; bf16 moments within one bf16 ulp of the leaf's largest;
int8 codes equal except where the moment sits within an ulp of a rounding
boundary, counted, and never more than one code apart. The schedules,
eager and jitted, are within 2 ulp of the base rate (XLA's cos is within
an ulp of torch's, and 1 + cos cancels near the end of the decay).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import interop
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import (AdamWConfig, QTensor, adamw_init,
                                     adamw_update, global_norm, state_bytes)

ULP = float(np.finfo(np.float32).eps)
SHAPES = [(17,), (8, 300), (3, 5, 257)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, and the
    tier-1 run shares the cores among several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_codes_and_scales_bitwise(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 3.0
    if x.ndim > 1:  # the first row's first 256-element block all zero
        x.reshape(-1, x.shape[-1])[0, :256] = 0.0
    jq = jadamw._quantize(jnp.asarray(x))
    tq = adamw._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.orig_last == jq.orig_last
    assert (float(tq.scales.reshape(-1)[0]) == 0.0) == (x.ndim > 1)
    back = adamw._dequantize(tq, shape)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jadamw._dequantize(jq, shape)))
    rel = float((back - torch.from_numpy(x)).abs().max()) / np.abs(x).max()
    assert rel < 1.0 / 100  # 8-bit absmax: ≤ ~1/127 of the block max


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 300)).astype(np.float32),
            "b": rng.normal(size=(300,)).astype(np.float32),
            "s": np.asarray(rng.normal(), np.float32)}


def _grads(seed, step):
    rng = np.random.default_rng(1000 * seed + step)
    return {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
            for k, v in _tree(seed).items()}


def _moment_np(x):
    if hasattr(x, "codes"):
        return np.asarray(x.codes), np.asarray(x.scales)
    return (np.asarray(x, np.float32),)


def _close_ulp(got, want, n=2, leaf=False):
    """|got − want| within n f32 ulp of each value, or of the leaf's
    largest magnitude (``leaf=True``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if leaf else np.abs(want)
    assert np.all(np.abs(got - want) <= n * ULP * scale), \
        np.abs(got - want).max()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_five_steps_match_jax(state_dtype):
    cfg = AdamWConfig(learning_rate=0.01, state_dtype=state_dtype)
    jcfg = jadamw.AdamWConfig(learning_rate=0.01, state_dtype=state_dtype)
    jp = _jnp_tree(_tree(0))
    tp = _torch_tree(_tree(0))
    js = jadamw.adamw_init(jp, jcfg)
    ts = adamw_init(tp, cfg)
    assert tuple(ts.m["s"].shape if state_dtype != "int8"
                 else ts.m["s"].codes.shape) in ((1,), (256,))
    ties = 0
    for step in range(5):
        g = _grads(0, step)
        jp, js, jm = jadamw.adamw_update(jp, _jnp_tree(g), js, jcfg)
        tp, ts, tm = adamw_update(tp, _torch_tree(g), ts, cfg)
        _close_ulp(tm["grad_norm"], jm["grad_norm"])
        for k in ("w", "b", "s"):
            _close_ulp(tp[k].numpy(), jp[k], 2, leaf=True)
            for jmom, tmom in ((js.m[k], ts.m[k]), (js.v[k], ts.v[k])):
                if state_dtype == "int8":
                    jc, jsc = _moment_np(jmom)
                    tc, tsc = tmom.codes.numpy(), tmom.scales.numpy()
                    _close_ulp(tsc, jsc, 8, leaf=True)
                    diff = tc.astype(np.int32) - jc
                    assert np.abs(diff).max() <= 1
                    ties += int((diff != 0).sum())
                else:
                    _close_ulp(tmom.float().numpy(), _moment_np(jmom)[0],
                               8 if state_dtype == "float32" else 2 ** 16,
                               leaf=True)
    assert int(ts.step) == int(js.step) == 5
    # A differing code needs a moment within an ulp of a .5 boundary.
    assert ties <= 4, f"{ties} int8 codes differ"


def test_global_norm_clipping_and_state_bytes():
    g = _tree(3)
    jn = jadamw.global_norm(_jnp_tree(g))
    tn = global_norm(_torch_tree(g))
    _close_ulp(float(tn), float(jn), 2)
    cfg = AdamWConfig(learning_rate=1.0, grad_clip_norm=1.0)
    jcfg = jadamw.AdamWConfig(learning_rate=1.0, grad_clip_norm=1.0)
    big = {k: v * 100 for k, v in g.items()}
    _, _, tm = adamw_update(_torch_tree(_tree(0)), _torch_tree(big),
                            adamw_init(_torch_tree(_tree(0)), cfg), cfg)
    _, _, jm = jadamw.adamw_update(_jnp_tree(_tree(0)), _jnp_tree(big),
                                   jadamw.adamw_init(_jnp_tree(_tree(0)),
                                                     jcfg), jcfg)
    _close_ulp(float(tm["clip_factor"]), float(jm["clip_factor"]))
    assert float(tm["clip_factor"]) < 1.0
    for dt in ("float32", "bfloat16", "int8"):
        ts = adamw_init(_torch_tree(_tree(0)), AdamWConfig(state_dtype=dt))
        js = jadamw.adamw_init(_jnp_tree(_tree(0)),
                               jadamw.AdamWConfig(state_dtype=dt))
        assert state_bytes(ts) == jadamw.state_bytes(js)


@pytest.mark.parametrize("name", ["cosine", "warmup_cosine"])
def test_schedules_match_jax(name):
    if name == "cosine":
        jf, tf = jschedule.cosine_lr(3e-4, 50), schedule.cosine_lr(3e-4, 50)
    else:
        jf = jschedule.linear_warmup_cosine(3e-4, 7, 60)
        tf = schedule.linear_warmup_cosine(3e-4, 7, 60)
    steps = np.arange(0, 70, dtype=np.int32)
    got = np.array([float(tf(int(s))) for s in steps], np.float32)
    for run in (jax.vmap(jf), jax.jit(jax.vmap(jf))):
        want = np.asarray(run(jnp.asarray(steps)))
        assert np.abs(want).max() == np.float32(3e-4)
        _close_ulp(got, want, 2, leaf=True)
    batched = tf(torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(batched, got)
    assert batched.dtype == np.float32


def test_interop_carries_adamw_state_across():
    for dt in ("float32", "bfloat16", "int8"):
        jcfg = jadamw.AdamWConfig(state_dtype=dt)
        jp = _jnp_tree(_tree(0))
        js = jadamw.adamw_init(jp, jcfg)
        _, js, _ = jadamw.adamw_update(jp, _jnp_tree(_grads(0, 0)), js, jcfg)
        ts = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, js))
        assert int(ts.step) == 1
        for k in ("w", "b", "s"):
            got = interop.adamw_state_to_numpy(ts).m[k]
            if dt == "int8":
                assert isinstance(ts.m[k], QTensor)
                np.testing.assert_array_equal(got.codes,
                                              np.asarray(js.m[k].codes))
            else:
                assert ts.m[k].dtype == getattr(torch, dt)
                np.testing.assert_array_equal(
                    got, np.asarray(js.m[k]).astype(np.float32))


# The port's counterparts of tests/test_train_substrate.py's optimizer tests.

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_reduces_quadratic_loss(state_dtype):
    params = {"w": torch.tensor([2.0, -3.0, 1.5]), "b": torch.tensor(4.0)}
    cfg = AdamWConfig(learning_rate=0.05, weight_decay=0.0,
                      state_dtype=state_dtype)
    state = adamw_init(params, cfg)

    def loss(p):
        return p["w"].square().sum() + p["b"].square()

    l0 = float(loss(params))
    for _ in range(200):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(live, torch.autograd.grad(loss(live),
                                                   list(live.values()))))
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(loss(params)) < 0.05 * l0


def test_int8_states_are_4x_smaller():
    params = {"w": torch.zeros((256, 1024))}
    s32 = adamw_init(params, AdamWConfig(state_dtype="float32"))
    s8 = adamw_init(params, AdamWConfig(state_dtype="int8"))
    assert state_bytes(s8) < 0.3 * state_bytes(s32)


def test_grad_clipping_caps_update():
    params = {"w": torch.tensor([0.0])}
    cfg = AdamWConfig(learning_rate=1.0, grad_clip_norm=1.0, weight_decay=0.0)
    state = adamw_init(params, cfg)
    _, _, metrics = adamw_update(params, {"w": torch.tensor([1e6])}, state,
                                 cfg)
    assert float(metrics["clip_factor"]) == pytest.approx(1e-6, rel=1e-3)
