"""Max-Cut benchmark walkthrough: Gset-family instance, all engines, TTS.
Counterpart of ``examples/maxcut_benchmark.py``.

Compares the reference engine (RSA/RWA, PWL logistic), the exact-sigmoid
SA baseline ("Neal") and the fused sweep kernel, then estimates TTS(0.99)
from independent runs (paper Eq. 32).

    PYTHONPATH=src python -m repro_torch.examples.maxcut_benchmark \\
        [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs.snowball import default_solver
from ..core import tts
from ..core.solver import solve, solve_many
from ..device import resolve_device
from ..graphs import cut_from_energy, erdos_renyi, maxcut_to_ising


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    inst = erdos_renyi(200, 4800, seed=6, name="G6-mini")  # G6 family, ÷4 scale
    problem = maxcut_to_ising(inst, device=dev)
    steps, replicas = 5000, 8

    def config(mode):
        return default_solver(200, steps, mode, replicas)

    engines = {
        "neal (exact sigmoid RSA)": lambda: solve(
            problem, 0, dataclasses.replace(config("rsa"), use_pwl=False),
            "reference", device=dev),
        "snowball RSA (pwl)": lambda: solve(problem, 0, config("rsa"),
                                            "reference", device=dev),
        "snowball RWA (pwl)": lambda: solve(problem, 0, config("rwa"),
                                            "reference", device=dev),
        "snowball RWA (fused kernel)": lambda: solve(
            problem, 0, config("rwa"), "fused", device=dev),
    }
    for name, fn in engines.items():
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        dt = time.perf_counter() - t0
        cut = float(cut_from_energy(inst, float(res.best_energy.min())))
        print(f"{name:32s} cut={cut:7.0f}  wall={dt:6.2f}s")

    # TTS(0.99): 16 independent RWA runs, threshold = 97% of best seen.
    cfg = default_solver(200, steps, "rwa", num_replicas=1)
    sync()
    t0 = time.perf_counter()
    runs = solve_many(problem, np.arange(16), cfg, device=dev)
    sync()
    per_run_ms = (time.perf_counter() - t0) / 16 * 1e3
    cuts = cut_from_energy(inst, runs.best_energy.reshape(-1).cpu().numpy())
    report = tts.estimate(-cuts, threshold=-0.97 * cuts.max(),
                          time_per_run=per_run_ms)
    print(f"TTS(0.99) = {report.tts:.1f} ms  (P_a="
          f"{report.success_probability:.2f}, t_a={per_run_ms:.1f} ms, "
          f"{report.num_runs} runs)")


if __name__ == "__main__":
    main()
