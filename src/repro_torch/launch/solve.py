"""Snowball solve launcher on the card (port of ``repro.launch.solve``).

    PYTHONPATH=src python -m repro_torch.launch.solve --instance k2000 --mode rwa
    PYTHONPATH=src python -m repro_torch.launch.solve --instance sparse16384 \
        --coupling-format bitplane_hbm --steps 65536
    PYTHONPATH=src python -m repro_torch.launch.solve --instance sparse16384 \
        --flip-mode colored --coupling-format bitplane_hbm --steps 704
    PYTHONPATH=src python -m repro_torch.launch.solve --gset path/to/G6 \
        --mode rsa --tts-threshold 11000

Runs the fused engine (``--engine fused``, the default), the reference
engine (``--engine scan``: plain PyTorch, no kernel) or the graph-colored
one (``--flip-mode colored``: one color class per step), and prints the
best cut and the time per step; the colored run also prints the coloring,
flips per step and rows fetched. ``sw<N>`` is the Watts–Strogatz small
world (degree 12), ``torus<side>`` the side × side periodic grid,
``sparse<N>`` the dense-J-free G(N, 8N) ±1 edge list, solved on a plane
tier, and ``--gset`` reads a Gset-format file. ``--tts-threshold`` prints
TTS(0.99) at that cut with the JAX CLI's convention: every replica is a
run, each taking ``wall / replicas``.

Long solves run under the resilient supervisor (snapshots, budgets,
bitwise resume; ``core.resilience.run_resilient``): any flag of the
resilience group routes there, and colored solves always do. A supervised
run prints its store or plan build apart (``build_seconds``); its us/step
is the steps alone.

    PYTHONPATH=src python -m repro_torch.launch.solve --instance k2000 \
        --run-dir runs/k2000 --deadline-seconds 3600
    # after a crash or a preemption, the same command resumes where it
    # stopped

``--engine sharded`` row-shards the planes over a mesh of ranks (always
supervised): one process per rank under ``torch.distributed.run``, NCCL on
the card and gloo on the CPU, ``--mesh-shape 4`` for 1-D row sharding or
``2x2`` for 2 replica groups × 2 row shards (``bitplane_sharded_2d``);
rank 0 prints, with the mesh, the collectives per step and each rank's
plane bytes.

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.solve --engine sharded --mesh-shape 2x2 \
        --instance sparse1024 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.snowball import default_solver
from ..core.coupling import COUPLING_FORMATS
from ..core.resilience import BudgetConfig, run_resilient
from ..core import tts
from ..core.solver import solve
from ..device import resolve_device
from ..graphs import (MaxCutInstance, complete_bipolar, erdos_renyi,
                      maxcut_edges_to_ising, maxcut_to_ising, parse_gset,
                      small_world, sparse_bipolar_edges, torus_grid)


def build_instance(name: str, seed: int, gset=None):
    """A dense ``MaxCutInstance`` (the Gset file ``gset`` when given), or
    for ``sparse<N>`` an ``EdgeList`` of weights."""
    if gset:
        return parse_gset(gset, name=gset)
    name = name.lower()
    if name.startswith("sparse") and name[6:].isdigit():
        n = int(name[6:])
        return sparse_bipolar_edges(n, 8 * n, seed=seed)
    if name.startswith("k") and name[1:].isdigit():
        return complete_bipolar(int(name[1:]), seed=seed)
    if name.startswith("er") and name[2:].isdigit():
        n = int(name[2:])
        return erdos_renyi(n, n * 24, seed=seed)
    if name.startswith("sw") and name[2:].isdigit():
        return small_world(int(name[2:]), 12, seed=seed)
    if name.startswith("torus") and name[5:].isdigit():
        side = int(name[5:])
        return torus_grid(side, side, seed=seed)
    raise SystemExit(f"unknown instance {name!r}: expected k<N> (complete "
                     "bipolar), er<N> (Erdős–Rényi, 24·N edges), sw<N> "
                     "(small-world, degree 12), torus<side> (side×side "
                     "grid) or sparse<N> (edge list, 8·N edges), e.g. "
                     "k2000, er500, sw1000, torus32 or sparse16384 — or "
                     "pass a Gset-format file via --gset instead")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instance", default="k2000",
                    help="k<N>|er<N>|sw<N>|torus<side>|sparse<N>")
    ap.add_argument("--gset", default=None, help="path to a Gset-format file")
    ap.add_argument("--mode", choices=("rsa", "rwa"), default="rwa")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("scan", "fused", "sharded"),
                    default="fused",
                    help="scan = the reference engine (plain PyTorch, one "
                    "flip per step, no kernel); fused = the sweep kernel; "
                    "sharded = spin-row-sharded planes over a mesh of ranks "
                    "(see --mesh-shape; always supervised)")
    ap.add_argument("--mesh-shape", default=None,
                    help="the mesh of --engine sharded: '4' shards spin rows "
                    "over 4 ranks; '2x2' runs 2 replica groups × 2 row "
                    "shards (bitplane_sharded_2d); default: every rank on "
                    "one dim")
    ap.add_argument("--coupling-format", choices=COUPLING_FORMATS,
                    default="auto", help="the J store (auto: by N and J)")
    ap.add_argument("--flip-mode", choices=("single", "colored"),
                    default="single",
                    help="single-spin sweeps, or one color class per step "
                    "(always supervised)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--tts-threshold", type=float, default=None,
                    help="cut value for TTS(0.99) estimation")
    res = ap.add_argument_group(
        "resilience", "crash-safe supervised solve (any of these flags "
        "routes the run through repro_torch.core.resilience.run_resilient)")
    res.add_argument("--run-dir", default=None,
                     help="snapshot directory; rerunning with the same "
                     "arguments resumes bitwise from the last intact "
                     "snapshot")
    res.add_argument("--no-resume", action="store_true",
                     help="ignore snapshots already in --run-dir")
    res.add_argument("--deadline-seconds", type=float, default=None,
                     help="wall-clock budget, checked between chunks")
    res.add_argument("--target-energy", type=float, default=None,
                     help="stop once the ensemble best reaches this energy")
    res.add_argument("--max-steps", type=int, default=None,
                     help="step budget (may stop before --steps)")
    res.add_argument("--chunk-steps", type=int, default=256,
                     help="snapshot and budget granularity")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sharded = args.engine == "sharded"
    if sharded and args.flip_mode == "colored":
        raise SystemExit("--engine sharded is single-flip only; drop "
                         "--flip-mode colored")
    mesh = None
    if sharded:
        from ..distributed.mesh import build_mesh, init_world
        init_world(device_type=dev.type)
        mesh = build_mesh(args.mesh_shape, dev.type)
        dev = resolve_device(args.device)   # a CUDA rank's own card
    inst = build_instance(args.instance, args.seed, args.gset)
    if isinstance(inst, MaxCutInstance):
        problem = maxcut_to_ising(inst, device=dev)
        label = (f"instance={inst.name} |V|={inst.num_vertices} "
                 f"|E|={inst.num_edges}")
        total = inst.total_weight
    else:
        problem = maxcut_edges_to_ising(inst)
        label = (f"instance={args.instance.lower()} |V|={inst.num_spins} "
                 f"|E|={inst.nnz} (edge list)")
        total = float(inst.weights.sum())
    cfg = dataclasses.replace(
        default_solver(problem.num_spins, args.steps, mode=args.mode,
                       num_replicas=args.replicas),
        coupling_format=args.coupling_format, flip_mode=args.flip_mode)
    colored = args.flip_mode == "colored"
    resilient = (colored or sharded or args.run_dir is not None
                 or args.deadline_seconds is not None
                 or args.target_energy is not None
                 or args.max_steps is not None)
    backend = ("colored" if colored
               else ("sharded_2d" if mesh.ndim > 1 else "sharded") if sharded
               else "reference" if args.engine == "scan" else "fused")
    built = []   # the supervisor's runner builds: (seconds, runner)

    def on_event(kind, info):
        if kind == "build":
            built.append((info["seconds"], info["runner"]))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if sharded:
        from ..distributed.mesh import COLLECTIVES
        COLLECTIVES.reset()
    t0 = time.perf_counter()
    if resilient:
        rr = run_resilient(
            problem, args.seed, cfg, run_dir=args.run_dir, backend=backend,
            budget=BudgetConfig(deadline_seconds=args.deadline_seconds,
                                max_steps=args.max_steps,
                                target_energy=args.target_energy),
            chunk_steps=args.chunk_steps, resume=not args.no_resume,
            on_event=on_event, device=dev, mesh=mesh)
        result = rr.result
        steps_done = rr.steps_done
        # Steps run in this process: a resumed run skips the restored ones.
        runner = built[-1][1]
        steps_run = steps_done - sum(runner.unit_len(k) for k in range(
            rr.resumed_from_chunk or 0))
    else:
        result = solve(problem, args.seed, cfg, backend, device=dev)
        steps_done = steps_run = args.steps
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if sharded:
        import torch.distributed as dist
        collectives = COLLECTIVES.total
        lead = dist.get_rank() == 0
        if not lead:
            dist.destroy_process_group()
            return
    # A supervised run's store or plan build is timed apart from its steps.
    build_seconds = sum(sec for sec, _ in built)
    run_seconds = wall - build_seconds
    cuts = (total - result.best_energy.cpu().numpy()) / 2.0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    per_step = run_seconds / max(steps_run, 1)
    print(f"{label} device={name}")
    build = (f" build_seconds={build_seconds:.3f} (host; not in us/step)"
             if resilient else "")
    print(f"mode={args.mode} engine={args.engine} "
          f"coupling_format={args.coupling_format} steps={args.steps} "
          f"replicas={args.replicas} wall={wall:.3f}s "
          f"us/step={per_step * 1e6:.2f}{build} (host clock around one "
          f"solve: includes CUDA start-up and the first call's kernel "
          f"build or load)")
    if resilient:
        resumed = ("" if rr.resumed_from_chunk is None
                   else f" resumed_from_chunk={rr.resumed_from_chunk}")
        downgraded = ("" if not rr.downgrades else
                      " tier_downgrades=" + ",".join(
                          f"{a}->{b}@{c}" for a, b, c in rr.downgrades))
        print(f"stop_reason={rr.stop_reason} steps_done={rr.steps_done}/"
              f"{args.steps} chunks={rr.chunks_done}/{rr.total_chunks}"
              f"{resumed}{downgraded}")
    print(f"best cut = {cuts.max():.0f}  (per-replica: "
          f"{np.sort(cuts)[::-1][:8]})")
    if sharded:
        from ..distributed.mesh import mesh_desc
        planes = runner.planes
        rows = float(result.rows_fetched.sum())
        print(f"engine=sharded backend={backend} mesh={mesh_desc(mesh)} "
              f"backend_pg={dist.get_backend()} plane_bytes_per_rank="
              f"{planes.nbytes} (B={planes.num_planes}, "
              f"{planes.pos.shape[1]} of N={problem.num_spins} rows, "
              f"W={planes.num_words})")
        print(f"collectives/step={collectives / max(steps_run, 1):.2f} "
              f"(rank 0, the init's and the result's included) "
              f"rows_fetched={rows:.0f} ({rows / max(steps_done, 1):.2f} "
              f"rows/step vs {args.replicas}/step uncoalesced)")
        dist.destroy_process_group()
    if colored:
        plan = runner.plan
        col = plan.coloring
        flips = float(result.num_flips.sum())
        rows = float(result.rows_fetched.sum())
        print(f"flip_mode=colored coupling_format={plan.store.fmt} "
              f"color_classes={col.num_classes} "
              f"max_class={col.max_class_size} "
              f"mean_class={col.num_spins / col.num_classes:.1f} "
              f"window={plan.window} plan_seconds={build_seconds:.3f} "
              f"(host: coloring, permutation, encode)")
        # A resumed run's flips include the restored steps'.
        rate = (f"{flips / run_seconds:.4e}" if steps_run == steps_done
                else "n/a (resumed)")
        print(f"flips/step={flips / max(steps_done, 1):.1f} (ensemble, "
              f"{args.replicas} replicas) flips/s={rate} "
              f"rows_fetched={rows:.0f} "
              f"({rows / max(steps_done, 1):.2f} rows/step)")
    if args.tts_threshold:
        r = tts.estimate(-cuts, threshold=-args.tts_threshold,
                         time_per_run=wall / args.replicas * 1e3)
        print(f"TTS(0.99) @ cut≥{args.tts_threshold:.0f}: {r.tts:.2f} ms "
              f"(P_a={r.success_probability:.2f})")

if __name__ == "__main__":
    main()
