"""The port's training path (``repro_torch.train``, the differentiable
``models.forward`` with remat, kernel E's autograd Function, the
checkpoint of train states, the launcher and the examples) against the
JAX package's, on the CPU.

Parameters come from JAX's ``init_params`` and cross with
``interop.lm_params_from_numpy`` (a whole ``TrainState`` with
``interop.train_state_from_numpy``); batches are the data pipeline's,
bitwise the same in both packages. Bounds:

* ``lm_loss`` and its gradients for every smoke architecture are in
  ``tests/test_torch_train_grads.py``.
* ``make_train_step``, three steps in f32 compute: loss, grad norm and lr
  within 1e-5 relative; with f32 moments, carried by each package, the
  parameters within 1e-3·lr (Adam divides tiny gradients by their own
  root mean square, so a 1e-6 gradient difference moves an update by up
  to ~1e-3 of lr); with int8 moments each step starts from JAX's state
  (an element whose v code is 0 and whose gradient is 0 moves by m/eps,
  ~1e4·lr, so a one-ulp scale difference is amplified 1e8 times in the
  next step in both packages: ROADMAP queue 3): parameters within 1e-5 of
  max(1, |p|) and the codes within one, ties counted.
* Remat ``none``/``full``/``dots``: bitwise; the flash Function against
  its plain backward: bitwise.
* Resume after a crash: bitwise a clean run, for f32, bf16 and int8 moments.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.schedule import linear_warmup_cosine as jwarmup
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import model_specs
from repro_torch.models.params import init_params, tree_paths
from repro_torch.optim import AdamWConfig, QTensor
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train import TrainLoopConfig, train_loop
from repro_torch.train import step as tstep

SRC = Path(__file__).resolve().parents[1] / "src"
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, and the
    tier-1 run shares the cores among several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, compute="bfloat16", **kw):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               compute_dtype=compute)
    tcfg = interop.model_config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, dataclasses.replace(tcfg, **kw)


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


def _batches(jcfg, tcfg, step=0, batch=B, seq=S):
    jb = JSyntheticLMData(jcfg, JDataConfig(seed=1, global_batch=batch,
                                            seq_len=seq)).batch(step)
    tb = SyntheticLMData(tcfg, DataConfig(seed=1, global_batch=batch,
                                          seq_len=seq), "cpu").batch(step)
    return jb, tb


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _train_pair(state_dtype, mb, lr=1e-3):
    jcfg, tcfg = _cfgs("qwen2-7b", "float32")
    jp = jparams.init_params(jmodel.model_specs(jcfg), jax.random.key(0))
    jopt = JAdamWConfig(learning_rate=lr, state_dtype=state_dtype)
    topt = AdamWConfig(learning_rate=lr, state_dtype=state_dtype)
    jfn = jstep.make_train_step(jcfg, jopt, jwarmup(lr, 1, 3),
                                num_microbatches=mb, donate=False)
    tfn = tstep.make_train_step(tcfg, topt, linear_warmup_cosine(lr, 1, 3),
                                num_microbatches=mb)
    return jcfg, tcfg, jstep.init_train_state(jcfg, jp, jopt), jfn, tfn


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_train_step_three_steps_match_jax(state_dtype, mb):
    lr = 1e-3
    jcfg, tcfg, js, jfn, tfn = _train_pair(state_dtype, mb, lr)
    ts = interop.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    ties = 0
    for step in range(3):
        jb, tb = _batches(jcfg, tcfg, step, batch=4)
        before = jax.tree.map(np.asarray, js.params)
        if state_dtype == "int8":   # each step from JAX's state
            ts = interop.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                                "cpu")
        js, jm = jfn(js, jb)
        ts, tm = tfn(ts, tb)
        for k in ("loss", "grad_norm", "lr", "ce"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
        assert int(ts.step) == int(js.step) == step + 1
        jn = jax.tree.map(np.asarray, js)
        err2 = upd2 = 0.0
        for path, p in tree_paths(ts.params):
            want = _leaf(jn.params, path)
            err = np.abs(p.numpy() - want)
            err2 += float((err.astype(np.float64) ** 2).sum())
            upd2 += float(((want - _leaf(before, path)).astype(np.float64)
                           ** 2).sum())
            if state_dtype == "float32":
                assert float(err.max()) <= 5e-3 * lr, path
        if state_dtype == "int8":
            assert math.sqrt(err2) <= 1e-4 * math.sqrt(upd2)
            for tree, jtree in ((ts.opt_state.m, jn.opt_state.m),
                                (ts.opt_state.v, jn.opt_state.v)):
                for path, q in _qtensors(tree):
                    jq = jtree
                    for part in path:
                        jq = jq[part]
                    diff = q.codes.numpy().astype(np.int32) - np.asarray(jq.codes)
                    assert np.abs(diff).max() <= 1
                    ties += int((diff != 0).sum())
    assert ties <= 8, f"{ties} int8 codes differ"


def _qtensors(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, QTensor):
            yield prefix + (k,), v
        else:
            yield from _qtensors(v, prefix + (k,))


def test_microbatched_grads_match_full_batch():
    """The port's counterpart of JAX's slow
    ``test_microbatching_matches_full_batch_grads``, on the gradients
    themselves (f32 compute; all labels valid, so the mean of the slices'
    losses is the batch's)."""
    _, cfg = _cfgs("qwen2-7b", "float32")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    batch = SyntheticLMData(cfg, DataConfig(seed=0, global_batch=4,
                                            seq_len=16), "cpu").batch(0)
    full_loss, _, full = tstep.value_and_grad(cfg, params, batch)
    parts = [tstep.value_and_grad(cfg, params,
                                  {k: v[i:i + 2] for k, v in batch.items()})
             for i in (0, 2)]
    assert abs(float(full_loss) - float(sum(p[0] for p in parts) / 2)) < 1e-5
    for path, g in tree_paths(full):
        mean = (_leaf(parts[0][2], path) + _leaf(parts[1][2], path)) / 2
        assert np.abs(g.numpy() - mean).max() <= 1e-5 * max(
            float(g.abs().max()), 1e-12)
    opt = AdamWConfig(learning_rate=0.0)
    norms = []
    for m in (1, 4):
        state = tstep.init_train_state(cfg, {k: v for k, v in params.items()},
                                       opt)
        _, metrics = tstep.make_train_step(cfg, opt, num_microbatches=m)(
            state, batch)
        norms.append(float(metrics["grad_norm"]))
    assert norms[0] == pytest.approx(norms[1], rel=1e-5)


#: One architecture per kind of block: dense attention on kernel E's
#: Function, the non-causal encoder, MoE, RWKV, and the Mamba hybrid.
REMAT_ARCHS = ("qwen2-7b", "hubert-xlarge", "granite-moe-1b-a400m",
               "rwkv6-1.6b", "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_bitwise(arch):
    cfg = get_config(arch, smoke=True)
    if cfg.has_attention:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    batch = SyntheticLMData(cfg, DataConfig(seed=2, global_batch=2,
                                            seq_len=S), "cpu").batch(0)
    runs = {}
    for remat in ("none", "full", "dots"):
        loss, _, grads = tstep.value_and_grad(
            dataclasses.replace(cfg, remat=remat), params, batch)
        runs[remat] = (loss, [g for _, g in tree_paths(grads)])
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(runs[remat][1], runs["none"][1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_backward(dtype):
    """Kernel E's Function (the plain forward and backward on the CPU): its
    gradients bitwise the plain backward's (``ref.flash_attention_bwd`` from
    the plain forward's out and lse), and within 1e-5 (f32) / 0.02 (bf16)
    of max |grad| of ``jax.vjp`` through the reference's
    ``chunked_attention`` (what ``_flash_bwd`` runs)."""
    rng = np.random.default_rng(3)
    b, hq, hkv, s, d = 2, 4, 2, 64, 16
    arrays = [rng.normal(size=(b, h, s, d)).astype(np.float32)
              for h in (hq, hkv, hkv)]
    gout = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    scale = d ** -0.5
    inputs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    before = [c.count for c in fa.FWD_COUNTERS]
    out = fa.flash_attention(*inputs, True, scale, 16, 32)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(gout).to(tdt))
    assert [c.count for c in fa.FWD_COUNTERS] == before
    plain = [torch.from_numpy(a).to(tdt) for a in arrays]
    ref_out, lse = ref.flash_attention(*plain, True, scale, return_lse=True)
    want = ref.flash_attention_bwd(*plain, ref_out, lse,
                                   torch.from_numpy(gout).to(tdt), True, scale)
    for g, w in zip(got, want):
        assert g.dtype == tdt and torch.equal(g, w)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jlayers.chunked_attention(
        q, k, v, causal=True, q_chunk=16, kv_chunk=32, scale=scale),
        *(jnp.asarray(a, jdt) for a in arrays))
    bound = 1e-5 if dtype == "float32" else 0.02
    for g, w in zip(got, vjp(jnp.asarray(gout, jdt))):
        w = np.asarray(w, np.float32)
        assert float(np.abs(g.float().numpy() - w).max()) <= \
            bound * float(np.abs(w).max())


def test_checkpoint_round_trips_bf16_and_qtensor(tmp_path):
    x = torch.randn(5, 300, generator=torch.Generator().manual_seed(0))
    from repro_torch.optim.adamw import _quantize
    tree = {"bf16": x.bfloat16(), "scalar_bf16": x[0, 0].bfloat16(),
            "q": _quantize(x), "f32": x, "step": torch.tensor(3, dtype=torch.int32)}
    for async_save in (False, True):
        mgr = CheckpointManager(str(tmp_path / str(async_save)),
                                async_save=async_save)
        mgr.save(1, tree)
        like = {"bf16": torch.zeros(5, 300, dtype=torch.bfloat16),
                "scalar_bf16": torch.zeros((), dtype=torch.bfloat16),
                "q": QTensor(torch.zeros(5, 512, dtype=torch.int8),
                             torch.zeros(5, 2), 0),
                "f32": torch.zeros(5, 300),
                "step": torch.tensor(0, dtype=torch.int32)}
        restored, at = mgr.restore(like)
        assert at == 1
        assert isinstance(restored["q"], QTensor)
        assert restored["q"].orig_last == 300
        for key in ("bf16", "scalar_bf16", "f32", "step"):
            assert restored[key].dtype == tree[key].dtype
            assert torch.equal(restored[key].view(-1).view(torch.int16)
                               if tree[key].dtype == torch.bfloat16
                               else restored[key],
                               tree[key].view(-1).view(torch.int16)
                               if tree[key].dtype == torch.bfloat16
                               else tree[key])
        assert torch.equal(restored["q"].codes, tree["q"].codes)
        assert torch.equal(restored["q"].scales, tree["q"].scales)


def _loop(tmp_path, state_dtype, **kw):
    cfg = get_config("qwen2-7b", smoke=True)
    data = DataConfig(seed=3, global_batch=4, seq_len=16)
    return cfg, data, TrainLoopConfig(steps=5, checkpoint_every=2,
                                      log_every=100, base_lr=1e-3,
                                      warmup_steps=2, state_dtype=state_dtype,
                                      **kw)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_crash_and_resume_is_bitwise_a_clean_run(tmp_path, state_dtype):
    ckpt = str(tmp_path / "ckpt")
    cfg, data, loop = _loop(tmp_path, state_dtype, checkpoint_dir=ckpt,
                            async_checkpoint=True)

    class Boom(RuntimeError):
        pass

    def bomb(step):
        if step == 3:
            raise Boom()

    quiet = dict(log_fn=lambda s: None, device="cpu")
    with pytest.raises(Boom):
        train_loop(cfg, data, loop, failure_hook=bomb, **quiet)
    assert latest_step(ckpt) == 2
    resumed, _ = train_loop(cfg, data, loop, resume=True, **quiet)
    clean, _ = train_loop(cfg, data, dataclasses.replace(
        loop, checkpoint_dir=None), **quiet)
    assert int(resumed.step) == int(clean.step) == 5
    flat_r = interop.train_state_to_numpy(resumed)
    flat_c = interop.train_state_to_numpy(clean)
    leaves_r, leaves_c = _np_leaves(flat_r), _np_leaves(flat_c)
    assert len(leaves_r) == len(leaves_c) > 20
    for a, b in zip(leaves_r, leaves_c):
        np.testing.assert_array_equal(a, b)
    moment = resumed.opt_state.m["embed"]
    if state_dtype == "int8":
        assert isinstance(moment, QTensor)
    else:
        assert moment.dtype == getattr(torch, state_dtype)


def _np_leaves(node):
    if isinstance(node, dict):
        return [x for k in sorted(node) for x in _np_leaves(node[k])]
    if isinstance(node, tuple):
        return [x for v in node for x in _np_leaves(v)]
    return [np.asarray(node)]


def test_train_loop_loss_decreases():
    cfg = get_config("qwen2-7b", smoke=True)
    loop = TrainLoopConfig(steps=30, checkpoint_every=1000, log_every=1,
                           base_lr=1e-2, warmup_steps=5)
    _, history = train_loop(cfg, DataConfig(seed=0, global_batch=4,
                                            seq_len=16), loop,
                            log_fn=lambda s: None, device="cpu")
    first = np.mean([h["loss"] for h in history[:3]])
    last = np.mean([h["loss"] for h in history[-3:]])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_train_cli_runs_on_the_cpu_when_asked():
    # A small batch and one thread: the tier-1 run shares the cores.
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-7b", "--smoke", "--steps", "3", "--global-batch", "2",
         "--seq-len", "32", "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "[train] step=0 loss=" in out.stdout
    assert "[train] step=2 loss=" in out.stdout


def test_examples_run_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import expert_placement, train_lm

    history = train_lm.main(["--preset", "tiny", "--steps", "12", "--seq",
                             "32", "--batch", "4", "--device", "cpu",
                             "--log-every", "4", "--checkpoint-dir",
                             str(tmp_path / "ck"), "--checkpoint-every", "5"])
    assert len(history) == 4 and history[-1]["loss"] < history[0]["loss"]
    assert latest_step(str(tmp_path / "ck")) == 12
    result = expert_placement.main(["--device", "cpu", "--steps", "300"])
    assert sorted(set(result.assignment.tolist())) == [0, 1, 2, 3]
    assert "snowball placement traffic" in capsys.readouterr().out
