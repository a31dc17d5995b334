"""Read where "auto"'s coupling tiers cross on the card, and the thresholds
that the rule of ``repro_torch.core.coupling`` draws from the readings.

For each N of ``--sizes`` two inputs, each on every tier that can serve it:

* the dense integer J of ``complete_bipolar(N, seed=N)`` (on the card, as
  ``maxcut_to_ising`` leaves it): ``dense``, ``bitplane``, ``bitplane_hbm``;
* the edge list ``sparse_bipolar_edges(N, 8·N, seed=N)`` (on the host):
  ``bitplane``, ``bitplane_hbm`` (an edge list never goes dense).

Per tier: ``CouplingStore.build`` from the input to a store on the card,
in seconds (host clock, synchronised; the host encode included) and its
peak traced host bytes (the median of 3 builds of an edge list, one of a
dense J's planes). Per tier and mode (RSA and RWA, R = 8, PWL):
kernel A's ms per 256-step launch by CUDA events (the mean of 10), and the
µs/step of a ``--steps``-step ``solve`` by host clock ending in
``torch.cuda.synchronize()`` (the median of 5 after a warm-up, the tiers
interleaved).

The rule (``coupling.py``'s docstring): a tier's cost for a mode is its
build seconds plus 20,000 (the main paths' budget) × its µs/step. A lower
tier wins at N where it costs no more than the tiers above it. A mode's
crossover is the largest N read at which the lower tier wins, as it does at
every N read below it; the threshold is the smaller of the RSA and RWA
crossovers. ``dense`` against the cheaper plane tier on the dense J, capped
by ``coupling.DENSE_MEMORY_MAX_N``; ``bitplane`` against ``bitplane_hbm``
on every input where "auto" can pick a plane tier (every edge list, a
dense J past the dense threshold).

    python scripts/tier_crossover.py [--out build/tier_crossover.json]

It prints one JSON object (the readings, the winners, the thresholds, the
thresholds in force, and the card's name and power limit); progress goes to
standard error. ``--device cpu --sizes 64 96 --steps 256`` runs the plain
versions at toy sizes (host clock for the kernel too), to check the script.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SIZES = (4096, 6144, 8192, 10240, 12288, 14481, 16384, 24576, 32768)
MODES = ("rsa", "rwa")
BUDGET_STEPS = 20_000
SEED = 0
T = 256
KERNEL_REPS = 10
REPS = 5            # timed solves a tier and mode, after one warm-up
BUILD_REPS = 3      # builds of a store, where one is cheap
REPLICAS = 8
DENSE_TIERS = ("dense", "bitplane", "bitplane_hbm")
PLANE_TIERS = ("bitplane", "bitplane_hbm")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def kernel_ms(torch, device, run) -> float:
    """Mean ms per call: CUDA events on the card, the host clock on the
    CPU; after one warm-up call."""
    run()
    sync(torch, device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(KERNEL_REPS):
            run()
        return (time.perf_counter() - t0) * 1e3 / KERNEL_REPS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(KERNEL_REPS):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / KERNEL_REPS


def crossover(wins: dict):
    """The largest N read at which the lower tier wins, as it does at every
    N read below it; None where it loses at the first N read."""
    last = None
    for n in sorted(wins):
        if not wins[n]:
            break
        last = n
    return last


def thresholds(readings: list, dense_memory_max_n: int) -> dict:
    """The rule on ``readings``: per mode each tier's cost, the winners, the
    crossovers and the two thresholds."""
    cost = {}
    for r in readings:
        for mode, m in r["modes"].items():
            cost[(r["input"], r["n"], r["tier"], mode)] = m["cost_s"]
    ns = sorted({r["n"] for r in readings})
    dense_wins = {mode: {n: cost[("dense_j", n, "dense", mode)] <= min(
        cost[("dense_j", n, t, mode)] for t in PLANE_TIERS) for n in ns}
        for mode in MODES}
    dense_cross = {mode: crossover(w) for mode, w in dense_wins.items()}
    dense_max = (None if None in dense_cross.values()
                 else min(*dense_cross.values(), dense_memory_max_n))

    def plane_inputs(n):
        return ("edges",) + (("dense_j",) if dense_max is None
                             or n > dense_max else ())

    plane_wins = {mode: {n: all(
        cost[(inp, n, "bitplane", mode)] <= cost[(inp, n, "bitplane_hbm",
                                                  mode)]
        for inp in plane_inputs(n)) for n in ns} for mode in MODES}
    plane_cross = {mode: crossover(w) for mode, w in plane_wins.items()}
    plane_max = (None if None in plane_cross.values()
                 else min(plane_cross.values()))
    return {"dense_wins": {m: {str(n): w for n, w in d.items()}
                           for m, d in dense_wins.items()},
            "dense_crossover": dense_cross,
            "bitplane_wins": {m: {str(n): w for n, w in d.items()}
                              for m, d in plane_wins.items()},
            "bitplane_crossover": plane_cross,
            "DENSE_COUPLING_MAX_N": dense_max,
            "BITPLANE_L2_MAX_N": plane_max}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    from repro_torch.configs.snowball import default_solver
    from repro_torch.core import coupling, ising, rng
    from repro_torch.core.coupling import CouplingStore, measure_host_build
    from repro_torch.core.solver import solve
    from repro_torch.graphs import (complete_bipolar, maxcut_to_ising,
                                    sparse_bipolar_edges)
    from repro_torch.kernels import ops, sweep

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("tier_crossover: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = rng.fold_in(rng.key(0), SEED)
    base_words = rng.words(base)

    def build(source, fmt, reps):
        runs = []
        for _ in range(reps):
            def thunk():
                store = CouplingStore.build(source, fmt).to(device)
                sync(torch, device)
                return store
            store, stats = measure_host_build(thunk)
            runs.append(stats)
        secs = sorted(s["seconds"] for s in runs)
        return store, {"build_s": statistics.median(secs),
                       "build_s_all": secs,
                       "build_peak_bytes": max(s["peak_bytes"]
                                               for s in runs)}

    def read(label, n, prob, stores):
        """Kernel A per launch and the solve's µs/step on every store."""
        out = {fmt: {} for fmt in stores}
        for mode in MODES:
            cfgs = {fmt: dataclasses.replace(
                default_solver(n, args.steps, mode=mode, num_replicas=REPLICAS),
                coupling_format=fmt) for fmt in stores}
            some = next(iter(cfgs.values()))
            tbl = ops.solver_pwl_table(some, device=device)
            temps = ops.chunk_temps(some, 0, T, T, device)
            for fmt, store in stores.items():
                u, s, e = ops.fused_init_state(prob, base.to(device), REPLICAS,
                                               planes=store.planes)[:3]
                ms = kernel_ms(torch, device, lambda: sweep.mcmc_sweep_keyed(
                    store.kernel_operand, u, s, e, base_words, 0, temps, tbl,
                    mode=mode, coupling=fmt))
                solve(prob, SEED, cfgs[fmt], store=store, device=device)
                out[fmt][mode] = {"kernel_ms": ms, "us_step_all": []}
            for _ in range(REPS):
                for fmt, store in stores.items():
                    sync(torch, device)
                    t0 = time.perf_counter()
                    solve(prob, SEED, cfgs[fmt], store=store, device=device)
                    sync(torch, device)
                    out[fmt][mode]["us_step_all"].append(
                        (time.perf_counter() - t0) / args.steps * 1e6)
            for fmt in stores:
                m = out[fmt][mode]
                m["us_step"] = statistics.median(m["us_step_all"])
                log(f"[{label} N={n}] {fmt:12s} {mode}: kernel "
                    f"{m['kernel_ms']:.4f} ms a launch, solve "
                    f"{m['us_step']:.3f} us/step")
        return out

    readings = []

    def record(inp, n, fmt, stats, store, modes, auto):
        for mode, m in modes.items():
            m["cost_s"] = stats["build_s"] + BUDGET_STEPS * m["us_step"] * 1e-6
        readings.append({"input": inp, "n": n, "tier": fmt, **stats,
                         "store_bytes": store.nbytes, "auto_in_force": auto,
                         "modes": modes})

    t_all = time.perf_counter()
    for n in args.sizes:
        t_n = time.perf_counter()
        inst = complete_bipolar(n, seed=n)
        prob = maxcut_to_ising(inst, device=device)
        del inst
        gc.collect()
        auto = coupling.resolve_format("auto", prob.couplings, n)
        stores, stats = {}, {}
        for fmt in DENSE_TIERS:
            stores[fmt], stats[fmt] = build(prob.couplings, fmt,
                                            1 if fmt != "dense" else
                                            BUILD_REPS)
            log(f"[dense_j N={n}] {fmt:12s} build {stats[fmt]['build_s']:.4f}"
                f" s, peak {stats[fmt]['build_peak_bytes']} B")
        modes = read("dense_j", n, prob, stores)
        for fmt in DENSE_TIERS:
            record("dense_j", n, fmt, stats[fmt], stores[fmt], modes[fmt],
                   auto)
        del prob, stores
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        edges = sparse_bipolar_edges(n, 8 * n, seed=n)
        prob = ising.IsingProblem.create_sparse(edges, device=device)
        auto = coupling.resolve_format("auto", edges, n)
        stores, stats = {}, {}
        for fmt in PLANE_TIERS:
            stores[fmt], stats[fmt] = build(edges, fmt, BUILD_REPS)
            log(f"[edges N={n}] {fmt:12s} build {stats[fmt]['build_s']:.4f}"
                f" s, peak {stats[fmt]['build_peak_bytes']} B")
        modes = read("edges", n, prob, stores)
        for fmt in PLANE_TIERS:
            record("edges", n, fmt, stats[fmt], stores[fmt], modes[fmt],
                   auto)
        del prob, stores, edges
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        log(f"[N={n}] {time.perf_counter() - t_n:.1f} s")

    out = {"sizes": args.sizes, "solve_steps": args.steps, "reps": REPS,
           "build_reps": BUILD_REPS, "replicas": REPLICAS,
           "budget_steps": BUDGET_STEPS,
           "device": str(device), "torch": torch.__version__,
           "dense_memory_max_n": coupling.DENSE_MEMORY_MAX_N,
           "in_force": {"DENSE_COUPLING_MAX_N": coupling.DENSE_COUPLING_MAX_N,
                        "BITPLANE_L2_MAX_N": coupling.BITPLANE_L2_MAX_N},
           "rule": thresholds(readings, coupling.DENSE_MEMORY_MAX_N),
           "readings": readings,
           "seconds": time.perf_counter() - t_all}
    if device.type == "cuda":
        out["total_memory"] = torch.cuda.get_device_properties(0).total_memory
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    rule = out["rule"]
    log(f"[rule] DENSE_COUPLING_MAX_N {rule['DENSE_COUPLING_MAX_N']} "
        f"(crossovers {rule['dense_crossover']}, memory cap "
        f"{coupling.DENSE_MEMORY_MAX_N}), BITPLANE_L2_MAX_N "
        f"{rule['BITPLANE_L2_MAX_N']} (crossovers "
        f"{rule['bitplane_crossover']}); in force {out['in_force']}")
    print(line)


if __name__ == "__main__":
    main()
