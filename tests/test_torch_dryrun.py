"""The port's dry run (``repro_torch.launch.abstracts``, ``.dryrun``) and
``launch.mesh.nccl_performance_env``.

* The abstract inputs against the JAX package's: ``rules_for`` equal for
  every shape; every leaf's ``PartitionSpec`` and per-rank shape from
  ``input_specs``, ``abstract_cache`` and ``abstract_train_state`` equal
  to JAX's on a (2, 2, 2) ``("pod", "data", "model")`` mesh (a JAX
  ``AbstractMesh``; the port's rules read only the dim names and sizes, a
  ``MeshShape``), for every smoke architecture.
* The dry run in subprocesses with a timeout, each one rank of a "fake"
  process group: the cells of ``tests/test_dryrun_small.py`` on a world of
  8 (qwen2 train, prefill and decode on (2, 2, 2); granite, jamba, rwkv6
  and hubert on (2, 4); qwen2's train step with wire bytes above 0), and
  the CLI on one production cell, qwen2-7b ``train_4k`` on the 16 × 16 pod
  (a world of 256), under 80 GB a rank.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.shapes import InputShape as JInputShape
from repro.launch import abstracts as jabs
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import abstracts
from repro_torch.launch.mesh import nccl_performance_env
from repro_torch.models import MeshShape
from repro_torch.models.sharding import sharding_of
from repro_torch.optim import AdamWConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("pod", "data", "model")
SMALL = [("train", 64, 8, "train"), ("prefill", 64, 8, "prefill"),
         ("decode", 64, 8, "decode")]


def _run(code: str, args=(), timeout: int = 110) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable] + (["-c", textwrap.dedent(code)] if code
                              else []) + list(args)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, f"subprocess failed:\n{proc.stderr[-4000:]}"
    return proc.stdout


SMALL_CELLS = """
    import json
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import fake_world, measure

    out = {}
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        cfg = get_config("qwen2-7b", smoke=True)
        for name, s, b, kind in %r:
            rep, cost = measure(cfg, InputShape(name, s, b, kind), mesh,
                                True, "test")
            out["qwen2/" + name] = [rep.t_compute, rep.t_memory,
                                    rep.bottleneck, rep.memory_per_device]
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        for arch in ("granite-moe-1b-a400m", "jamba-1.5-large-398b",
                     "rwkv6-1.6b", "hubert-xlarge"):
            cfg = get_config(arch, smoke=True)
            shapes = [InputShape("train", 32, 8, "train")]
            if cfg.causal:
                shapes.append(InputShape("decode", 64, 8, "decode"))
            for shape in shapes:
                rep, cost = measure(cfg, shape, mesh, False, "test")
                out[arch + "/" + shape.name] = [rep.t_compute, rep.t_memory,
                                                rep.bottleneck,
                                                rep.memory_per_device]
        rep, cost = measure(get_config("qwen2-7b", smoke=True),
                            InputShape("train", 64, 8, "train"), mesh, False,
                            "test")
        out["collectives"] = [cost.wire_bytes, cost.collective_bytes_by_op]
    print("JSON" + json.dumps(out))
""" % (SMALL,)


@pytest.fixture(scope="module")
def dry():
    """The small cells and the production cell, run at the same time."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        small = pool.submit(_run, SMALL_CELLS)
        prod = pool.submit(_run, None, ["-m", "repro_torch.launch.dryrun",
                                        "--arch", "qwen2-7b", "--shape",
                                        "train_4k"], 300)
        s = small.result()
        line = next(ln for ln in s.splitlines() if ln.startswith("JSON"))
        return json.loads(line[4:]), prod.result()


def test_nccl_performance_env():
    env = nccl_performance_env()
    names = [name for name, _, _ in env]
    assert len(set(names)) == len(names) >= 3
    assert "CUDA_DEVICE_MAX_CONNECTIONS" in names
    for name, value, reason in env:
        assert isinstance(value, str) and reason
    assert not any(os.environ.get(n) == v for n, v, _ in env
                   if n not in os.environ)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", tuple(SHAPES))
def test_rules_for_equal_jax(shape, multi_pod):
    got = abstracts.rules_for(SHAPES[shape], multi_pod)
    want = jabs.rules_for(jconfigs.SHAPES[shape], multi_pod)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _norm(spec, ndim):
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _jleaves(tree):
    import jax

    return {tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in p): l
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


#: A QTensor's fields as JAX's tree flattening names them.
_QFIELDS = {"codes": "0", "scales": "1"}


def _pleaves(tree):
    return {tuple(_QFIELDS.get(k, k) for k in p): l
            for p, l in abstracts.leaves(tree)}


def _compare(port, jax_tree):
    got, want = _pleaves(port), _jleaves(jax_tree)
    assert len(got) == len(want)
    jmap = {tuple(k for k in path if k not in ("params", "opt_state")): v
            for path, v in want.items()}
    for path, t in got.items():
        key = tuple(k for k in path if k not in ("params", "opt_state"))
        w = jmap[key]
        s = sharding_of(t)
        assert tuple(t.shape) == tuple(w.shape), path
        assert _norm(s.spec, t.dim()) == _norm(w.sharding.spec, t.dim()), path
        assert s.shard_shape(t.shape) == tuple(
            w.sharding.shard_shape(w.shape)), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstracts_equal_jax(arch):
    jmesh = AbstractMesh((2, 2, 2), AXES)
    pmesh = MeshShape(AXES, (2, 2, 2))
    cfg, jcfg = get_config(arch, smoke=True), jconfigs.get_config(arch,
                                                                  smoke=True)
    for name, s, b, kind in SMALL:
        shape, jshape = InputShape(name, s, b, kind), JInputShape(name, s, b,
                                                                  kind)
        rules = abstracts.rules_for(shape, True)
        jrules = jabs.rules_for(jshape, True)
        _compare(abstracts.input_specs(cfg, shape, pmesh, rules),
                 jabs.input_specs(jcfg, jshape, jmesh, jrules))
        if kind == "decode" and cfg.causal:
            _compare(abstracts.abstract_cache(cfg, shape, pmesh, rules),
                     jabs.abstract_cache(jcfg, jshape, jmesh, jrules))
    for dtype in ("float32", "int8"):
        rules = abstracts.rules_for(InputShape(*SMALL[0]), True)
        _compare(abstracts.abstract_train_state(
            cfg, AdamWConfig(state_dtype=dtype), pmesh, rules),
            jabs.abstract_train_state(jcfg, JAdamWConfig(state_dtype=dtype),
                                      jmesh, jabs.rules_for(
                                          JInputShape(*SMALL[0]), True)))


def test_local_blocks_are_the_shard_shapes():
    pmesh = MeshShape(AXES, (2, 2, 2))
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    shape = InputShape(*SMALL[2])
    tree = abstracts.abstract_cache(cfg, shape, pmesh,
                                    abstracts.rules_for(shape, True))
    # A MeshShape has no ranks: the block's shape is what the rules give.
    for path, t in abstracts.leaves(tree):
        s = sharding_of(t)
        assert t.is_meta and len(s.shard_shape(t.shape)) == t.dim()


def test_small_cells_run(dry):
    cells, _ = dry
    want = {"qwen2/train", "qwen2/prefill", "qwen2/decode",
            "granite-moe-1b-a400m/train", "granite-moe-1b-a400m/decode",
            "jamba-1.5-large-398b/train", "jamba-1.5-large-398b/decode",
            "rwkv6-1.6b/train", "rwkv6-1.6b/decode", "hubert-xlarge/train"}
    assert want <= set(cells)
    for name in want:
        t_comp, t_mem, bottleneck, mem = cells[name]
        assert t_comp > 0 and t_mem > 0, name
        assert bottleneck in ("compute", "memory", "collective")
        assert mem["peak"] >= mem["arguments"] > 0


def test_collectives_present_in_sharded_train(dry):
    """The (2, 4) train step communicates: FSDP gathers over data and the
    tensor-parallel sums over model."""
    wire, by_op = dry[0]["collectives"]
    assert wire > 0
    assert set(by_op) & {"all-reduce", "broadcast"}


def test_production_cell_fits_a_card(dry):
    _, out = dry
    line = next(ln for ln in out.splitlines() if ln.startswith("== "))
    assert " ok " in line, line
    mem = next(ln for ln in out.splitlines() if "memory per rank" in ln)
    peak = int(mem.split("'peak': ")[1].rstrip("}"))
    assert 0 < peak < 80e9, mem
