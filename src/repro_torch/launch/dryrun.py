"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture × input shape) cell, one rank of the production
mesh runs the step on the meta device: the single pod's (16, 16) mesh (a
world of 256) and the two pods' (2, 16, 16) (512). The rank is one process
in a ``"fake"`` process group of that world (``torch.distributed``'s
``FakeStore``): the collectives return at once and move nothing, so the
step's every op, every collective and every tensor the rank would hold run
as shapes. ``roofline.count_costs`` counts them: the rank's argument bytes
and the peak of what is live, its flops, bytes and wire bytes, and the
roofline terms on the H100's peaks. A failing cell is an error, not a skip.

A meta tensor has no value to read. The Mamba scan's piece length (the
path's one host read) takes the config's ``ssm_chunk`` there, and the MoE
dispatch's count of kept (token, expert) pairs (a ``nonzero``) takes every
pair as kept, the most it could be; the report's note says so.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, applicable, get_config
from ..configs.shapes import InputShape
from ..device import meta_device
from ..models import (abstract_params, decode_step, forward, model_specs,
                      param_shardings)
from ..models.config import ModelConfig
from ..models.sharding import use_sharding
from ..optim import AdamWConfig
from ..roofline import analyze, count_costs
from ..train.step import init_train_state, make_train_step
from .abstracts import (abstract_cache, abstract_train_state, input_specs,
                        local_blocks, rules_for)
from .mesh import make_production_mesh

# Per-arch dry-run hints (the JAX package's). train_microbatches sizes the
# saved residual carries; "rules" overrides shard the residual stream
# (Megatron-style) for the largest models.
HINTS: dict[str, dict] = {
    "starcoder2-7b": {"train_microbatches": 16},
    "stablelm-12b": {"train_microbatches": 16},
    "nemotron-4-340b": {"train_microbatches": 16, "state_dtype": "int8",
                        "rules": {"embed_act": "model"}},
    "qwen2-7b": {"train_microbatches": 8},
    "llava-next-34b": {"train_microbatches": 16, "rules": {"embed_act": "model"}},
    "phi3.5-moe-42b-a6.6b": {"train_microbatches": 8},
    "granite-moe-1b-a400m": {"train_microbatches": 4},
    "hubert-xlarge": {"train_microbatches": 8},
    "rwkv6-1.6b": {"train_microbatches": 4},
    "jamba-1.5-large-398b": {"train_microbatches": 8, "state_dtype": "int8",
                             "rules": {"embed_act": "model"}},
}

#: The notes of a cell whose path reads a value on the host.
META_NOTES = {"mamba": "meta: the Mamba scan took ssm_chunk as its piece "
                       "length",
              "moe": "meta: the MoE dispatch took every pair as kept"}


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a ``"fake"`` process group of
    ``world_size`` ranks (collectives return at once), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool):
    """One cell as this rank's step on meta blocks: ``(run, arguments,
    rules, model_flops)``; ``run()`` runs the step under the rules' context,
    ``arguments`` are the rank's blocks it takes (the parameters, the
    optimizer state or the cache, the rank's rows of the batch)."""
    hints = HINTS.get(cfg.name, {})
    rules = rules_for(shape, multi_pod)
    if shape.kind == "train" and hints.get("rules"):
        rules = dataclasses.replace(rules, **hints["rules"])
    n_active = cfg.active_param_count()
    tokens_global = shape.global_batch * (shape.seq_len
                                          if shape.kind != "decode" else 1)
    with use_sharding(mesh, rules):
        batch = input_specs(cfg, shape, mesh, rules)
        rows = {k: local_blocks(v) for k, v in batch.items()}
        if shape.kind == "train":
            opt = AdamWConfig(state_dtype=hints.get("state_dtype", "float32"))
            params = local_blocks(abstract_train_state(cfg, opt, mesh,
                                                       rules).params)
            state = init_train_state(cfg, params, opt)
            step = make_train_step(
                cfg, opt, num_microbatches=hints.get("train_microbatches", 1),
                param_shardings=param_shardings(model_specs(cfg), mesh,
                                                rules))
            return ((lambda: step(state, batch)), (state, rows), rules,
                    6.0 * n_active * tokens_global)
        serve_cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                        remat="none")
        params = local_blocks(abstract_params(model_specs(serve_cfg), mesh,
                                              rules))
        if shape.kind == "prefill":
            def run():
                with torch.no_grad():
                    return forward(serve_cfg, params, **batch)
            return run, (params, rows), rules, 2.0 * n_active * tokens_global
        # decode: one new token against a seq_len-deep cache, at its end
        cache = local_blocks(abstract_cache(serve_cfg, shape, mesh, rules))
        return ((lambda: decode_step(serve_cfg, params, cache,
                                     shape.seq_len - 1, **batch)),
                (params, cache, rows), rules, 2.0 * n_active * tokens_global)


def measure(cfg: ModelConfig, shape: InputShape, mesh, multi_pod: bool,
            mesh_name: str):
    """Run one cell's step on this rank's meta blocks under the cost
    counter: ``(CellReport, OpCost)``."""
    run, arguments, rules, model_flops = build_cell(cfg, shape, mesh,
                                                    multi_pod)
    from torch.fx.experimental import _config as fx_config

    with use_sharding(mesh, rules), count_costs(arguments=arguments) as c, \
            meta_device(), \
            fx_config.patch(meta_nonzero_assume_all_nonzero=True):
        run()
    note = "; ".join(text for kind, text in META_NOTES.items()
                     if any(kind in e for e in cfg.block_pattern))
    report = analyze(c.cost, arch=cfg.name, shape=shape.name,
                     mesh_name=mesh_name, num_devices=mesh.size(),
                     model_flops=model_flops, note=note)
    return report, c.cost


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    multi_pod = mesh_kind == "multipod"
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            report, cost = measure(cfg, shape, mesh, multi_pod, mesh_kind)
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_kind}] memory per rank: "
                  f"{report.memory_per_device}")
            print(f"[{arch} × {shape_name} × {mesh_kind}] flops="
                  f"{cost.flops:.4g} bytes={cost.bytes:.4g} wire="
                  f"{cost.wire_bytes:.4g} ops={cost.ops}")
        out = dataclasses.asdict(report)
        out.update(status="ok", run_s=round(time.time() - t0, 1),
                   step_time=report.step_time, mfu=report.mfu)
        return out
    except Exception as e:  # a failing cell is a bug in the system
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, action="append")
    ap.add_argument("--shape", choices=tuple(SHAPES), action="append")
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="merge the results into this JSON file")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else args.arch
    shapes = list(SHAPES) if (args.all or not args.shape) else args.shape
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    results = []
    failed = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                r = run_cell(arch, shape_name, mesh_kind)
                status = r["status"]
                extra = (f"bottleneck={r.get('bottleneck')} "
                         f"mfu={100 * r.get('mfu', 0):.1f}% peak/rank="
                         f"{r['memory_per_device']['peak'] / 2**30:.2f} GiB "
                         f"run={r.get('run_s')}s" if status == "ok"
                         else r.get("reason", r.get("error", "")))
                print(f"== {arch:24s} {shape_name:12s} {mesh_kind:8s} "
                      f"{status:8s} {extra}", flush=True)
                results.append(r)
                failed += status == "error"
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as fh:
                existing = json.load(fh)
        key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
        merged = {key(r): r for r in existing}
        merged.update({key(r): r for r in results})
        with open(args.out, "w") as fh:
            json.dump(list(merged.values()), fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
