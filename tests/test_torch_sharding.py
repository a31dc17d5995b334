"""The port's sharding rules (``repro_torch.models.sharding``) as pure
functions against the JAX package's, and the sharded model on a world of
1 against the unsharded one.

* ``ShardingRules.spec``: the cases of ``tests/test_distributed.py`` and a
  sweep of names × mesh axes × rules, equal to JAX's spec entry for entry.
* ``param_shardings`` / ``make_sharding``: every leaf of the ten smoke
  architectures on the (2, 4) and (2, 2, 2) meshes equal to JAX's
  ``NamedSharding.spec`` (JAX on 8 forced CPU devices in one subprocess;
  the port reads only the mesh's dim names and shape, a ``MeshShape``).
* On a world of 1 (gloo, in this process) a sharded forward, decode and
  train step are bitwise the unsharded ones (a mesh dim of size 1 issues
  no collective); without a context every constraint is the identity.
"""
import dataclasses
import itertools
import json

import pytest
import torch
import torch.distributed as dist

from conftest import run_with_forced_devices
from repro.models.sharding import ShardingRules as JRules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import mesh as M
from repro_torch.models import (MeshShape, ShardingRules, abstract_params,
                                decode_step, forward, init_decode_cache,
                                init_params, logical_constraint, make_sharding,
                                model_specs, param_shardings, shard_params,
                                use_sharding)
from repro_torch.models import sharding
from repro_torch.models.params import tree_paths

NAMES = tuple(f.name for f in dataclasses.fields(ShardingRules)) + (None,)
MESH_AXES = (None, ("data", "model"), ("pod", "data", "model"), ("model",),
             ("data",))
RULES = ({}, {"kv_heads": None, "cache_seq": "model"},
         {"embed_w": ("pod", "data"), "batch": ("data",)},
         {"experts": ("data", "model"), "heads": ("model", "pod")})
MESHES = {(2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}


def _plain(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_spec_dedup_and_mesh_filter():
    rules = ShardingRules()
    spec = rules.spec("batch", "seq", "embed_w",
                      mesh_axes=("pod", "data", "model"))
    assert spec[0] == ("pod", "data")
    assert spec[2] is None  # embed_w -> data already used
    assert rules.spec("batch", mesh_axes=("data", "model")) == ("data",)


@pytest.mark.parametrize("mesh_axes,rules", list(itertools.product(
    MESH_AXES, RULES)))
def test_spec_equals_jax(mesh_axes, rules):
    port, jax_rules = ShardingRules(**rules), JRules(**rules)
    cases = [(n,) for n in NAMES] + list(itertools.product(NAMES, repeat=2))
    cases += [("batch", "seq", "heads", None), ("embed_w", "vocab"),
              ("batch", "kv_heads", "cache_seq", None),
              ("experts", "embed_w", None), ("batch", "res_seq", "embed_act")]
    for names in cases:
        assert _plain(port.spec(*names, mesh_axes=mesh_axes)) == _plain(
            tuple(jax_rules.spec(*names, mesh_axes=mesh_axes))), names


@pytest.fixture(scope="module")
def jax_specs():
    """JAX's ``param_shardings`` spec of every smoke leaf on both meshes."""
    out = run_with_forced_devices(f"""
        import json, jax
        from repro.configs import get_config
        from repro.models import model_specs, param_shardings
        from repro.models.params import tree_paths
        out = {{}}
        for shape, axes in {list(MESHES.items())!r}:
            mesh = jax.make_mesh(tuple(shape), tuple(axes))
            for arch in {list(ARCH_IDS)!r}:
                specs = model_specs(get_config(arch, smoke=True))
                sh = param_shardings(specs, mesh)
                for path, _ in tree_paths(specs):
                    s = sh
                    for k in path:
                        s = s[k]
                    out["|".join([str(shape), arch] + list(path))] = [
                        list(e) if isinstance(e, tuple) else e
                        for e in s.spec]
        print("SPECS" + json.dumps(out))
    """, n_devices=8)
    line = next(x for x in out.splitlines() if x.startswith("SPECS"))
    return json.loads(line[len("SPECS"):])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_equal_jax(jax_specs, arch):
    specs = model_specs(get_config(arch, smoke=True))
    for shape, axes in MESHES.items():
        mesh = MeshShape(axes, shape)
        sh = param_shardings(specs, mesh)
        abstract = abstract_params(specs, mesh)
        for path, spec in tree_paths(specs):
            got = sh
            meta = abstract
            for k in path:
                got, meta = got[k], meta[k]
            want = jax_specs["|".join([str(shape), arch] + list(path))]
            want += [None] * (len(spec.shape) - len(want))
            assert _plain(got.spec) == want, (shape, path)
            assert got == make_sharding(spec.axes, mesh, shape=spec.shape)
            assert meta.is_meta and tuple(meta.shape) == spec.shape
            assert sharding.sharding_of(meta) == got


def test_no_context_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert logical_constraint(x, "batch", "seq", "heads") is x
    assert sharding.current() is None
    assert make_sharding(("embed_w", "vocab")) is None


@pytest.fixture(scope="module")
def world1():
    M.init_world("gloo", rank=0, world_size=1, device_type="cpu")
    try:
        from repro_torch.launch.mesh import make_host_mesh
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_world_of_one_is_bitwise_unsharded(world1, arch):
    """Forward, decode and two train steps on the (1, 1) mesh: bitwise the
    unsharded functions, with no collective."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import step as tstep
    import torch_worlds as tw

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    specs = model_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tw.lm_tokens(cfg.vocab_size, (2, 32))).long()
    shardings = param_shardings(specs, world1)
    sp = shard_params(params, shardings)
    M.COLLECTIVES.reset()
    with torch.no_grad():
        want = forward(cfg, params, tokens=toks)
        with use_sharding(world1):
            got = forward(cfg, sp, tokens=toks)
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.aux_loss, want.aux_loss)
        cache = init_decode_cache(cfg, 2, 8, device="cpu")
        want, _ = decode_step(cfg, params, cache, 0, tokens=toks[:, :8])
        with use_sharding(world1):
            cache = init_decode_cache(cfg, 2, 8, device="cpu")
            got, _ = decode_step(cfg, sp, cache, 0, tokens=toks[:, :8])
        assert torch.equal(got, want)
    opt = AdamWConfig(learning_rate=1e-3)
    plain = tstep.make_train_step(cfg, opt)
    fn = tstep.make_train_step(cfg, opt, param_shardings=shardings)
    a = tstep.init_train_state(cfg, params, opt)
    b = tstep.init_train_state(
        cfg, shard_params(init_params(specs, torch.Generator().manual_seed(0),
                                      "cpu"), shardings), opt)
    for i in range(2):
        batch = tw.lm_train_batch(cfg, i)
        a, ma = plain(a, batch)
        with use_sharding(world1):
            b, mb = fn(b, batch)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_paths(a.params), tree_paths(b.params)))
    assert M.COLLECTIVES.total == 0


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recompute_runs_under_the_forward_context(world1, remat):
    """On the card autograd runs the backward (and so a checkpointed
    group's recompute) on its device thread, where the caller's context
    variable is unset. The recompute must still take the sharded path: a
    backward on another thread gives the same-thread gradients."""
    import threading

    from repro_torch.train import step as tstep
    import torch_worlds as tw

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              compute_dtype="float32", remat=remat)
    specs = model_specs(cfg)
    sp = shard_params(init_params(specs, torch.Generator().manual_seed(0),
                                  "cpu"), param_shardings(specs, world1))
    batch = tw.lm_train_batch(cfg, 0)

    def grads(other_thread: bool):
        live = tstep._with_grad(sp)
        leaves = [t for _, t in tree_paths(live)]
        with use_sharding(world1):
            loss, _ = tstep.lm_loss(cfg, live, batch)
        if not other_thread:
            return torch.autograd.grad(loss, leaves)
        out = []
        t = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, leaves)))
        t.start()
        t.join()
        assert out, "the backward on another thread raised"
        return out[0]

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)
