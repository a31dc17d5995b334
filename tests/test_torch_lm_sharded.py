"""The port's LM sharding on a gloo world of 4 (``repro_torch.models``
under ``use_sharding``, ``train.make_train_step`` with shardings, the
mesh-agnostic checkpoint) against the JAX package on one device.

One world (``torch_worlds.lm_sharded_world``) runs every sharded case on
the (data 2, model 2) and (data 1, model 4) meshes from JAX's parameters
(carried by ``interop.lm_params_from_numpy`` and split by
``shard_params``), while this process computes JAX's unsharded
references. Each rank's block of the logits is held to the same block of
JAX's. Bounds:

* forward: f32 within 1e-4, bf16 within JAX's own 0.05
  (``tests/test_distributed.py``); the MoE losses within 1e-5 relative,
  the expert load within 1e-6;
* the seq-sharded decode (``kv_heads=None, cache_seq="model"``): 32 steps
  in bf16 within 0.05, as JAX's test;
* the train step, three steps in f32 with ``param_shardings`` and
  ``gathered_shardings``: loss, grad norm, ce and lr within 1e-5 relative
  (``tests/test_torch_train.py``'s f32 bounds); the parameters within 1e-4
  of the update's norm (its bound for steps whose tiny gradients Adam
  amplifies) and each within 0.05·lr (Adam moves an element whose
  gradient is near ``eps`` by up to ~1e-2·lr when the sharded sums round a
  1e-9 gradient otherwise);
* the Mamba and RWKV families (rwkv6, jamba) data-parallel on (4, 1) and
  split over model on (2, 2) in f32: within 1e-4 of max |logit| of JAX's
  forward (the families' f32 bound, ``tests/test_torch_lm_families.py``);
* the checkpoint: saved on (2, 2) and restored on (1, 4) exactly, with one
  whole leaf at most alive at a time while the blocks are gathered.
"""
import concurrent.futures
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_worlds as tw
from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.schedule import linear_warmup_cosine as jwarmup
from repro.train import step as jstep
from repro_torch.distributed.world import run_world

ARCHS = ("qwen2-7b", "granite-moe-1b-a400m", "rwkv6-1.6b",
         "jamba-1.5-large-398b")
FORWARD = [(shape, arch, dt) for shape in tw.LM_MESHES
           for arch, dt in (("qwen2-7b", "float32"), ("qwen2-7b", "bfloat16"),
                            ("granite-moe-1b-a400m", "float32"))]
TOL = {"float32": 1e-4, "bfloat16": 0.05}


def _jcfg(arch, compute):
    return dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               compute_dtype=compute)


def _jax_refs(jp: dict) -> dict:
    """JAX's unsharded forward, decode and train step on the same inputs."""
    params = {a: jax.tree.map(jnp.asarray, p) for a, p in jp.items()}
    toks = jnp.asarray(tw.lm_tokens(512, (tw.LM_B, tw.LM_S)))
    out = {"forward": {}}
    for _, arch, dt in FORWARD[:3]:
        res = jmodel.forward(_jcfg(arch, dt), params[arch], tokens=toks)
        out["forward"][(arch, dt)] = {
            "logits": np.asarray(res.logits, np.float32),
            "aux": float(res.aux_loss),
            "load": None if res.expert_load is None
            else np.asarray(res.expert_load)}

    rtoks = jnp.asarray(tw.lm_tokens(512, (tw.LM_B, tw.RECURRENT_S)))
    out["recurrent"] = {
        arch: np.asarray(jmodel.forward(_jcfg(arch, "float32"), params[arch],
                                        tokens=rtoks).logits, np.float32)
        for arch in ARCHS[2:]}

    cfg = _jcfg("qwen2-7b", "bfloat16")
    dtoks = jnp.asarray(tw.lm_tokens(512, (tw.DECODE_B, tw.DECODE_L)))
    cache = jmodel.init_decode_cache(cfg, tw.DECODE_B, tw.DECODE_L)
    step = jax.jit(lambda p, c, t, tok: jmodel.decode_step(cfg, p, c, t,
                                                           tokens=tok))
    out["decode"] = []
    for t in range(tw.DECODE_L):
        lg, cache = step(params["qwen2-7b"], cache, jnp.int32(t),
                         dtoks[:, t:t + 1])
        out["decode"].append(np.asarray(lg, np.float32))

    cfg = _jcfg("qwen2-7b", "float32")
    opt = JAdamWConfig(learning_rate=tw.TRAIN_LR)
    fn = jstep.make_train_step(cfg, opt, jwarmup(tw.TRAIN_LR, 1,
                                                 tw.TRAIN_STEPS),
                               donate=False)
    state = jstep.init_train_state(cfg, params["qwen2-7b"], opt)
    data = JSyntheticLMData(cfg, JDataConfig(seed=1, global_batch=tw.LM_B,
                                             seq_len=tw.LM_S))
    out["train"] = []
    for i in range(tw.TRAIN_STEPS):
        before = jax.tree.map(np.asarray, state.params)
        state, m = fn(state, data.batch(i))
        out["train"].append({"metrics": {k: float(v) for k, v in m.items()},
                             "params": jax.tree.map(np.asarray, state.params),
                             "before": before})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 and JAX's references, run at the same time."""
    jp = {a: jax.tree.map(np.asarray, jparams.init_params(
        jmodel.model_specs(jconfigs.get_config(a, smoke=True)),
        jax.random.key(0))) for a in ARCHS}
    run_dir = str(tmp_path_factory.mktemp("lm_sharded"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_refs, jp)
        ranks = run_world("torch_worlds:lm_sharded_world", 4,
                          args=(jp, run_dir), timeout=900)
        return ranks, ref.result()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("shape,arch,dtype", FORWARD)
def test_sharded_forward_matches_jax(runs, shape, arch, dtype):
    ranks, ref = runs
    want = ref["forward"][(arch, dtype)]
    for rank in ranks:
        got = rank["forward"][(shape, arch, dtype)]
        blk, sl = got["logits"]
        err = float(np.abs(blk.numpy() - want["logits"][sl]).max())
        assert err < TOL[dtype], (rank, err)
        assert abs(got["aux"] - want["aux"]) <= 1e-5 * max(abs(want["aux"]),
                                                           1e-6)
        if want["load"] is not None:
            assert np.abs(got["load"].numpy() - want["load"]).max() <= 1e-6
    # The ranks hold the whole logits between them.
    assert sum(r["forward"][(shape, arch, dtype)]["logits"][0].numel()
               for r in ranks) == want["logits"].size


@pytest.mark.parametrize("shape", tw.LM_MESHES)
def test_seq_sharded_decode_matches_jax(runs, shape):
    ranks, ref = runs
    for rank in ranks:
        got = rank["decode"][shape]
        # The cache holds every kv head and a quarter or half of the length.
        assert got["cache"][2:4] == (2, tw.DECODE_L // shape[1])
        for t, (blk, sl) in enumerate(got["steps"]):
            err = float(np.abs(blk.numpy() - ref["decode"][t][sl]).max())
            assert err < 0.05, (t, err)


@pytest.mark.parametrize("shape", tw.LM_MESHES)
def test_sharded_train_step_matches_jax(runs, shape):
    ranks, ref = runs
    lr = tw.TRAIN_LR
    for rank in ranks:
        for want, got in zip(ref["train"], rank["train"][shape]):
            for k in ("loss", "grad_norm", "ce", "lr"):
                assert abs(got["metrics"][k] - want["metrics"][k]) <= \
                    1e-5 * abs(want["metrics"][k]), k
            err2 = upd2 = 0.0
            for path, (blk, sl) in got["params"].items():
                w = _leaf(want["params"], path)[sl]
                err = np.abs(blk.numpy() - w)
                assert float(err.max()) <= 0.05 * lr, path
                err2 += float((err.astype(np.float64) ** 2).sum())
                upd2 += float(((w - _leaf(want["before"], path)[sl])
                               .astype(np.float64) ** 2).sum())
            assert math.sqrt(err2) <= 1e-4 * math.sqrt(upd2)


def test_collectives_present_in_sharded_forward_and_step(runs):
    """The (2, 2) mesh gathers the FSDP blocks over data and reduces the
    tensor-parallel partial sums over model; its train step sums the
    gradients over data. The (1, 4) mesh has no data collective."""
    ranks, _ = runs
    for rank in ranks:
        fwd = rank["collectives"][((2, 2), "qwen2-7b", "float32")]
        assert fwd[("broadcast", "data")] > 0
        assert fwd[("all_reduce_sum", "model")] > 0
        step = rank["train"][(2, 2)][0]["collectives"]
        assert step[("all_reduce_sum", "data")] > 0
        tp = rank["collectives"][((1, 4), "qwen2-7b", "float32")]
        assert not any(dim == "data" for _, dim in tp)


@pytest.mark.parametrize("shape", tw.LM_MESHES)
def test_global_norm_equals_unsharded(runs, shape):
    for rank in runs[0]:
        got, want, collectives = rank["norm"][shape]
        assert abs(got - want) <= 1e-6 * want
        # One all-reduce per dim of each set of dims the leaves split over
        # ({data}, {model}, {data, model}: at most 4), none per leaf.
        assert 0 < collectives <= 4


def test_checkpoint_saved_on_2x2_restores_on_1x4(runs):
    for rank in runs[0]:
        ck = rank["checkpoint"]
        assert ck["step"] == tw.TRAIN_STEPS
        assert ck["params"] and ck["moments"] and ck["meta"] and ck["blocks"]


@pytest.mark.parametrize("arch", ARCHS[2:])
def test_recurrent_families(runs, arch):
    """Data-parallel on (4, 1): each rank's rows of the logits within the
    families' f32 bound (1e-4 of max |logit|, ``test_torch_lm_families``)
    of JAX's unsharded forward on the same tokens, and within 1e-5 of the
    port's own unsharded forward; split over model on (2, 2) (the
    ``ssm_inner``, ``rwkv_heads`` and ``ffn`` dims), each rank's block
    within the same bound of JAX's."""
    ranks, ref = runs
    want = ref["recurrent"][arch]
    scale = float(np.abs(want).max())
    for rank in ranks:
        got = rank["recurrent"][arch]
        blk, sl = got["block"]
        err = float(np.abs(blk.numpy() - want[sl]).max())
        assert err <= 1e-4 * scale, (err, scale)
        assert got["plain"] <= 1e-5
        blk, sl = got["split"]
        err = float(np.abs(blk.numpy() - want[sl]).max())
        assert err <= 1e-4 * scale, (err, scale)
    assert sum(r["recurrent"][arch]["block"][0].numel() for r in ranks) == \
        want.size


def test_checkpoint_gathers_one_leaf_at_a_time(runs):
    """Saving the (2, 2) state holds one whole leaf at most at a time."""
    for rank in runs[0]:
        assert rank["ckpt_whole_leaves"] == 1


def test_meshes(runs):
    for rank in runs[0]:
        assert rank["mesh_names"] == {(2, 2): ("data", "model"),
                                      (1, 4): ("data", "model")}
        assert rank["pod_mesh"] == (("pod", "data", "model"), (2, 1, 2))


@pytest.mark.parametrize("case,match", [
    ("tp3", "not divisible"), ("production", "needs 256 ranks"),
    ("int8", "quantization block"), ("res_seq", "shares a batch dim"),
    ("device", "device type"), ("no_context", "use_sharding")])
def test_errors(runs, case, match):
    for rank in runs[0]:
        assert match in rank["errors"][case], rank["errors"][case]
