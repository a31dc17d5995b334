"""Snowball solve launcher on the card (port of ``repro.launch.solve``).

    PYTHONPATH=src python -m repro_torch.launch.solve --instance k2000 --mode rwa
    PYTHONPATH=src python -m repro_torch.launch.solve --instance sparse16384 \
        --coupling-format bitplane_hbm --steps 65536
    PYTHONPATH=src python -m repro_torch.launch.solve --instance sparse16384 \
        --flip-mode colored --coupling-format bitplane_hbm --steps 704

Runs the fused engine (``--flip-mode single``) or the graph-colored one
(``--flip-mode colored``: one color class per step) and prints the best cut
and the time per step; the colored run also prints the coloring, flips per
step and rows fetched. ``sparse<N>`` is the dense-J-free G(N, 8N) ±1 edge
list, solved on a plane tier. The JAX CLI's other flags (engines, Gset
files, resilience, TTS) wait for their slices of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.snowball import default_solver
from ..core.coupling import COUPLING_FORMATS
from ..device import resolve_device
from ..graphs import (MaxCutInstance, complete_bipolar, erdos_renyi,
                      maxcut_edges_to_ising, maxcut_to_ising,
                      sparse_bipolar_edges)
from ..kernels.ops import colored_anneal, colored_plan, fused_anneal


def build_instance(name: str, seed: int):
    """A dense ``MaxCutInstance``, or for ``sparse<N>`` an ``EdgeList`` of
    weights."""
    name = name.lower()
    if name.startswith("sparse") and name[6:].isdigit():
        n = int(name[6:])
        return sparse_bipolar_edges(n, 8 * n, seed=seed)
    if name.startswith("k") and name[1:].isdigit():
        return complete_bipolar(int(name[1:]), seed=seed)
    if name.startswith("er") and name[2:].isdigit():
        n = int(name[2:])
        return erdos_renyi(n, n * 24, seed=seed)
    raise SystemExit(f"unknown instance {name!r}: expected k<N> (complete "
                     "bipolar), er<N> (Erdős–Rényi, 24·N edges) or "
                     "sparse<N> (edge list, 8·N edges), e.g. k2000, er500 "
                     "or sparse16384")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instance", default="k2000",
                    help="k<N>|er<N>|sparse<N>")
    ap.add_argument("--mode", choices=("rsa", "rwa"), default="rwa")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coupling-format", choices=COUPLING_FORMATS,
                    default="auto", help="the J store (auto: by N and J)")
    ap.add_argument("--flip-mode", choices=("single", "colored"),
                    default="single",
                    help="single-spin sweeps, or one color class per step")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    inst = build_instance(args.instance, args.seed)
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
    if colored:
        t0 = time.perf_counter()
        plan = colored_plan(problem, args.coupling_format)
        plan_seconds = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if colored:
        result = colored_anneal(problem, args.seed, cfg, plan=plan,
                                device=dev)
    else:
        result = fused_anneal(problem, args.seed, cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    cuts = (total - result.best_energy.cpu().numpy()) / 2.0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{label} device={name}")
    print(f"mode={args.mode} coupling_format={args.coupling_format} "
          f"steps={args.steps} replicas={args.replicas} "
          f"wall={wall:.3f}s us/step={wall / args.steps * 1e6:.2f} "
          f"(host clock around one solve: includes CUDA start-up and the "
          f"first call's kernel build or load)")
    print(f"best cut = {cuts.max():.0f}  (per-replica: "
          f"{np.sort(cuts)[::-1][:8]})")
    if colored:
        col = plan.coloring
        flips = float(result.num_flips.sum())
        rows = float(result.rows_fetched.sum())
        print(f"flip_mode=colored coupling_format={plan.store.fmt} "
              f"color_classes={col.num_classes} "
              f"max_class={col.max_class_size} "
              f"mean_class={col.num_spins / col.num_classes:.1f} "
              f"window={plan.window} plan_seconds={plan_seconds:.3f} (host)")
        print(f"flips/step={flips / args.steps:.1f} (ensemble, "
              f"{args.replicas} replicas) flips/s={flips / wall:.4e} "
              f"rows_fetched={rows:.0f} "
              f"({rows / args.steps:.2f} rows/step)")


if __name__ == "__main__":
    main()
