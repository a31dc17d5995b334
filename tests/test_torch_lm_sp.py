"""The Mamba and RWKV blocks split over ``model`` and sequence parallelism
(``res_seq``, ``embed_act``) on a gloo world of 4, against the JAX
package on one device.

One world (``torch_worlds.lm_sp_world``) runs every case on the (data 2,
model 2) and (data 1, model 4) meshes from JAX's parameters, while this
process computes JAX's unsharded references. Bounds:

* rwkv6 and jamba split over model (``ssm_inner``, ``rwkv_heads``,
  ``ffn``) in f32: each rank's block of the logits within 1e-4 of max
  |logit| of JAX's forward (the families' f32 bound,
  ``tests/test_torch_lm_families.py``), and of JAX's 16 decode steps with
  the caches split alike;
* the Mamba scan's pieces: a channel planted in the last rank's block
  spans more than ``ssm.SCAN_LOG_SPAN`` over a chunk, and every rank scans
  in the unsharded run's pieces;
* ``res_seq`` and ``embed_act`` on qwen2, granite and jamba: bitwise the
  same mesh's run without the rule, and that run within 1e-4 of JAX's;
  ``seq`` splits only the logits that the forward returns;
* the storage layouts (``layers``, and ``lora``, ``ssm_state``, ``conv``,
  ``dt_rank``, ``head_dim``): the forward and 4 decode steps (the cache
  stored alike) within 1e-4 of JAX's;
* jamba's dry-run train hint (``embed_act="model"``, int8 moments): three
  steps against JAX's, loss, grad norm and ce within 1e-5 relative and
  the parameters within 1e-4 of the update's norm (the bounds of
  ``tests/test_torch_lm_sharded.py``).
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
JAMBA = "jamba-1.5-large-398b"
CASES = [(shape, arch) for shape in tw.LM_MESHES for arch in tw.SPLIT_ARCHS]


def _jcfg(arch):
    return dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               compute_dtype="float32")


def _jax_refs(jp: dict) -> dict:
    params = {a: jax.tree.map(jnp.asarray, p) for a, p in jp.items()}
    rtoks = jnp.asarray(tw.lm_tokens(512, (tw.LM_B, tw.SPLIT_S)))
    toks = jnp.asarray(tw.lm_tokens(512, (tw.LM_B, tw.LM_S)))
    dtoks = jnp.asarray(tw.lm_tokens(512, (tw.DECODE_B, tw.SPLIT_DECODE)))
    out = {"split": {}, "decode": {}, "sp": {}}
    for arch in ("qwen2-7b",) + tw.SPLIT_ARCHS:
        out["split"][arch] = np.asarray(jmodel.forward(
            _jcfg(arch), params[arch], tokens=rtoks).logits, np.float32)
    for arch in tw.SPLIT_ARCHS:
        cfg = _jcfg(arch)
        cache = jmodel.init_decode_cache(cfg, tw.DECODE_B, tw.SPLIT_DECODE)
        step = jax.jit(lambda p, c, t, tok, cfg=cfg: jmodel.decode_step(
            cfg, p, c, t, tokens=tok))
        steps = []
        for t in range(tw.SPLIT_DECODE):
            lg, cache = step(params[arch], cache, jnp.int32(t),
                             dtoks[:, t:t + 1])
            steps.append(np.asarray(lg, np.float32))
        out["decode"][arch] = steps
    for arch in tw.SP_ARCHS:
        out["sp"][arch] = np.asarray(jmodel.forward(
            _jcfg(arch), params[arch], tokens=toks).logits, np.float32)

    return out


def _jax_train(jp: dict) -> list:
    """JAX's three int8 steps of jamba: ``[(state before, params after,
    metrics)]``, the states with numpy leaves."""
    cfg = _jcfg(JAMBA)
    opt = JAdamWConfig(learning_rate=tw.TRAIN_LR, state_dtype="int8")
    fn = jstep.make_train_step(cfg, opt, jwarmup(tw.TRAIN_LR, 1,
                                                 tw.TRAIN_STEPS),
                               donate=False)
    state = jstep.init_train_state(cfg, jax.tree.map(jnp.asarray, jp[JAMBA]),
                                   opt)
    data = JSyntheticLMData(cfg, JDataConfig(seed=1, global_batch=tw.LM_B,
                                             seq_len=tw.LM_S))
    out = []
    for i in range(tw.TRAIN_STEPS):
        before = jax.tree.map(np.asarray, state)
        state, m = fn(state, data.batch(i))
        out.append((before, jax.tree.map(np.asarray, state.params),
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.fixture(scope="module")
def runs():
    jp = {a: jax.tree.map(np.asarray, jparams.init_params(
        jmodel.model_specs(jconfigs.get_config(a, smoke=True)),
        jax.random.key(0))) for a in ARCHS}
    train = _jax_train(jp)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_refs, jp)
        ranks = run_world("torch_worlds:lm_sp_world", 4,
                          args=(jp, [t[0] for t in train]), timeout=600)
        out = ref.result()
    out["train"] = train
    return ranks, out


def _within(block, want, scale=None):
    blk, sl = block
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(blk.numpy() - want[sl]).max())
    return err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("shape,arch", CASES)
def test_split_forward_matches_jax(runs, shape, arch):
    ranks, ref = runs
    want = ref["split"][arch]
    for rank in ranks:
        got = rank["split"][(shape, arch)]
        ok, why = _within(got["logits"], want)
        assert ok, why
        # The block's own dims are split: its partial sums are reduced
        # over model.
        assert got["collectives"][("all_reduce_sum", "model")] > 0
    # The ranks hold the whole logits between them (rows by data, the
    # vocab by model).
    assert sum(r["split"][(shape, arch)]["logits"][0].numel()
               for r in ranks) == want.size


@pytest.mark.parametrize("shape,arch", CASES)
def test_split_decode_matches_jax(runs, shape, arch):
    ranks, ref = runs
    m = shape[1]
    for rank in ranks:
        got = rank["decode"][(shape, arch)]
        for t, block in enumerate(got["steps"]):
            ok, why = _within(block, ref["decode"][arch][t])
            assert ok, (t, why)
        cache = got["cache"]
        b = tw.DECODE_B // shape[0]
        if arch == JAMBA:
            cfg = jconfigs.get_config(arch, smoke=True)
            assert cache["b0/mamba/conv"] == (cfg.num_groups, b,
                                             cfg.d_inner // m,
                                             cfg.ssm_conv_width - 1)
            assert cache["b0/mamba/ssm"][2] == cfg.d_inner // m
        else:
            cfg = jconfigs.get_config(arch, smoke=True)
            heads = cfg.d_model // cfg.rwkv_head_dim
            assert cache["b0/rwkv/wkv"] == (cfg.num_groups, b, heads // m,
                                           cfg.rwkv_head_dim,
                                           cfg.rwkv_head_dim)
            assert cache["b0/rwkv/shift"] == (cfg.num_groups, b, cfg.d_model)


def test_scan_pieces_are_the_unsharded_runs(runs):
    """A channel of the last rank's block forces a shorter piece there:
    every rank, on (1, 4), scans in the unsharded run's pieces."""
    for rank in runs[0]:
        got = rank["planted"]
        assert got["pieces"] == got["plain_pieces"]
        assert got["plain_pieces"][0] < jconfigs.get_config(
            JAMBA, smoke=True).ssm_chunk
        assert got["finite"]
        assert got["err"] <= 1e-4 * got["scale"], (got["err"], got["scale"])


@pytest.mark.parametrize("shape,arch", [(s, a) for s in tw.LM_MESHES
                                        for a in tw.SP_ARCHS])
@pytest.mark.parametrize("rule", tuple(tw.SP_RULES))
def test_sequence_parallel_is_bitwise(runs, shape, arch, rule):
    ranks, ref = runs
    for rank in ranks:
        got = rank["sp"][(shape, arch)]
        assert got[rule]["same"]
        ok, why = _within(got["base"], ref["sp"][arch])
        assert ok, why
        # The rule adds the cut of each reduced sum to the rank's block
        # and its gather back: more collectives on model than without.
        assert got[rule]["collectives"].get(("broadcast", "model"), 0) > 0


@pytest.mark.parametrize("shape", tw.LM_MESHES)
def test_seq_rule_splits_only_the_logits(runs, shape):
    """``seq="model"``: each rank's block of the logits is its sequence
    block (the vocab whole), within 1e-4 of JAX's."""
    ranks, ref = runs
    for rank in ranks:
        blk, sl = rank["seq"][shape]
        assert blk.shape[1] == tw.LM_S // shape[1]
        assert blk.shape[2] == ref["sp"]["qwen2-7b"].shape[2]
        ok, why = _within((blk, sl), ref["sp"]["qwen2-7b"])
        assert ok, why


@pytest.mark.parametrize("layout", tuple(tw.STORAGE_RULES))
@pytest.mark.parametrize("arch", ("qwen2-7b",) + tw.SPLIT_ARCHS)
def test_storage_layouts(runs, layout, arch):
    ranks, ref = runs
    for rank in ranks:
        got = rank["storage"][(layout, arch)]
        ok, why = _within(got["logits"], ref["split"][arch])
        assert ok, why
        assert got["model_split"]
        for t, block in enumerate(got["decode"]):
            ok, why = _within(block, ref["decode"][arch][t])
            assert ok, (t, why)
    if arch in tw.SPLIT_ARCHS:
        assert len(ranks[0]["storage"][(layout, arch)]["decode"]) == \
            tw.STORAGE_DECODE


@pytest.mark.parametrize("shape", tw.LM_MESHES)
def test_jamba_train_hint_matches_jax(runs, shape):
    """Each int8 step from JAX's state before it, as
    ``tests/test_torch_train.py`` compares int8 steps: the metrics on every
    rank, and the whole parameters (the ranks' blocks, each counted once)
    within 1e-4 of the update's norm."""
    ranks, ref = runs
    for i, (before, after, metrics) in enumerate(ref["train"]):
        err2 = upd2 = 0.0
        seen = set()
        for rank in ranks:
            got = rank["train"][shape][i]
            for k in ("loss", "grad_norm", "ce"):
                assert abs(got["metrics"][k] - metrics[k]) <= \
                    1e-5 * abs(metrics[k]), k
            for path, (blk, sl) in got["params"].items():
                key = (path, tuple((x.start, x.stop) for x in sl))
                if key in seen:
                    continue
                seen.add(key)
                w = _leaf(after, path)[sl]
                err2 += float(((blk.numpy() - w).astype(np.float64)
                               ** 2).sum())
                upd2 += float(((w - _leaf(before.params, path)[sl])
                               .astype(np.float64) ** 2).sum())
        assert math.sqrt(err2) <= 1e-4 * math.sqrt(upd2), i


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("case,match", [("batch_dim", "shares a batch dim"),
                                        ("embed_w", "outside the batch dims")])
def test_refusals(runs, case, match):
    for rank in runs[0]:
        assert match in rank["errors"][case], rank["errors"][case]
