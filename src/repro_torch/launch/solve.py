"""Snowball solve launcher on the card (port of ``repro.launch.solve``).

    PYTHONPATH=src python -m repro_torch.launch.solve --instance k2000 --mode rwa

Runs the fused engine and prints the best cut and the time per step. The
JAX CLI's other flags (engines, Gset files, resilience, TTS) wait for their
slices of the port.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.snowball import default_solver
from ..device import resolve_device
from ..graphs import complete_bipolar, cut_from_energy, erdos_renyi, maxcut_to_ising
from ..kernels.ops import fused_anneal


def build_instance(name: str, seed: int):
    name = name.lower()
    if name.startswith("k") and name[1:].isdigit():
        return complete_bipolar(int(name[1:]), seed=seed)
    if name.startswith("er") and name[2:].isdigit():
        n = int(name[2:])
        return erdos_renyi(n, n * 24, seed=seed)
    raise SystemExit(f"unknown instance {name!r}: expected k<N> (complete "
                     "bipolar) or er<N> (Erdős–Rényi, 24·N edges), e.g. "
                     "k2000 or er500")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instance", default="k2000", help="k<N>|er<N>")
    ap.add_argument("--mode", choices=("rsa", "rwa"), default="rwa")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    inst = build_instance(args.instance, args.seed)
    problem = maxcut_to_ising(inst, device=dev)
    cfg = default_solver(inst.num_vertices, args.steps, mode=args.mode,
                         num_replicas=args.replicas)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    result = fused_anneal(problem, args.seed, cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    cuts = cut_from_energy(inst, result.best_energy.cpu().numpy())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"instance={inst.name} |V|={inst.num_vertices} "
          f"|E|={inst.num_edges} device={name}")
    print(f"mode={args.mode} steps={args.steps} replicas={args.replicas} "
          f"wall={wall:.3f}s us/step={wall / args.steps * 1e6:.2f} "
          f"(host clock around one solve: includes CUDA start-up and the "
          f"first call's kernel build or load)")
    print(f"best cut = {cuts.max():.0f}  (per-replica: "
          f"{np.sort(cuts)[::-1][:8]})")


if __name__ == "__main__":
    main()
