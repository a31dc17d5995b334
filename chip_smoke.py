"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version at the shapes of the main path (K2000:
N=2000, R=8, 256-step chunks), then drives the main path — ``solve(K2000,
seed, default_solver(2000, 20000, mode), backend="fused")`` in RSA and RWA
mode — and checks its results. Prints the card, the build, every check, a
``{"kernels": [...]}`` line with times and bounds, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and exits
nonzero. Without a CUDA device it exits nonzero before printing a result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

from repro_torch.configs.snowball import K2000, default_solver  # noqa: E402
from repro_torch.core import ising, rng  # noqa: E402
from repro_torch.core.schedules import linear  # noqa: E402
from repro_torch.core.solver import SolverConfig, solve  # noqa: E402
from repro_torch.graphs import (complete_bipolar, cut_from_energy,  # noqa: E402
                                maxcut_to_ising)
from repro_torch.kernels import _build, common, local_field, ops, ref, sweep  # noqa: E402
from repro_torch.kernels.parity import roulette_near_tie  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 rate outside the
#: tensor cores. The bounds below use them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: Floating-point operations of one PWL flip probability: divide, max, min,
#: subtract, multiply, fused multiply-add (2).
PWL_FLOPS = 7

SEED = 0
R, N, T = 8, K2000.num_vertices, 256
STEPS = 20000


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")
    print(f"  ok: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a_list, b_list) -> float:
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               for a, b in zip(a_list, b_list))


def sweep_inputs(problem, r: int, t: int, temps_row, seed: int):
    """Random ±1 spins, their exact u and e, and JAX-stream uniforms."""
    key = rng.fold_in(rng.key(0, device="cuda"), seed)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(r, device="cuda")),
                            (problem.num_spins,)).to(torch.float32)
    u0 = ref.local_field_init(s0, problem.couplings, problem.fields)
    e0 = ising.energy(problem, s0)
    unif = rng.uniform01(rng.stream(key, rng.Salt.SWEEP, 0), (t, r, 4))
    temps = temps_row.to("cuda")[:, None].expand(t, r).contiguous()
    return u0, s0, e0, unif, temps


def sweep_bytes_flops(mode: str, r: int, n: int, t: int, flips: int,
                      segs: int):
    """What one sweep must move and compute for these inputs: u0, s0, e0,
    uniforms, temps and the table in; u, s, best_s, e, best_e, num_flips and
    rows_fetched out; one J row per accepted flip (a rejected step needs no
    row). RSA evaluates one flip probability a step, RWA all N."""
    nbytes = 4 * (2 * r * n + r + t * r * 4 + t * r + 3 * (segs + 1)
                  + 3 * r * n + 4 * r) + 4 * flips * n
    evals = t * r * (n if mode == "rwa" else 1)
    flops = evals * (PWL_FLOPS + (1 if mode == "rwa" else 0)) + 2 * flips * n
    return nbytes, flops


def invariants(problem, out, t: int, label: str):
    u, s, e, be, bs, nf, rf = out
    check(torch.equal(u, ref.local_field_init(s, problem.couplings,
                                              problem.fields)),
          f"{label}: u == J s + h exactly")
    check(torch.equal(e, ising.energy(problem, s)),
          f"{label}: e == energy(s) exactly")
    check(torch.equal(be, ising.energy(problem, bs)),
          f"{label}: best_e == energy(best_s) exactly")
    check(int(rf.sum()) == rf.numel() * t, f"{label}: sum(rows_fetched) == R*T")
    check(bool(((s == 1) | (s == -1)).all()), f"{label}: spins are ±1")


def profile_main_path(problem, config) -> None:
    """Device time by kernel and the device's busy share of the host wall
    time, over one solve. Prints "not measured" if the trace has no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(problem, SEED, config, backend="fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    rows = sorted(((device_us(ev), ev.count, ev.key)
                   for ev in prof.key_averages()), reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    if busy <= 0:
        print("[profile] device time not measured (no device events)")
        return
    print(f"[profile] wall {wall:.4f} s (profiled), device busy "
          f"{busy:.4f} s = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
    for us, count, key in rows[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def main() -> None:
    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {kind} count={count} nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("[build] nvcc, one process per source, in parallel")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall")
    for b in built.values():
        print(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    inst = complete_bipolar(N, seed=SEED)
    problem = maxcut_to_ising(inst, device="cuda")
    cfg = {m: default_solver(N, STEPS, mode=m) for m in ("rsa", "rwa")}
    temps0 = cfg["rsa"].schedule(torch.arange(T, dtype=torch.int32))
    tbl = ops.solver_pwl_table(cfg["rsa"], device="cuda")
    segs = tbl.shape[0] - 1
    rows = []

    print("[kernels] local_field_init against its plain version (K2000, R=8)")
    u0, s0, e0, unif, temps = sweep_inputs(problem, R, T, temps0, SEED)
    got = local_field.local_field_init(s0, problem.couplings, problem.fields)
    want = ref.local_field_init(s0, problem.couplings, problem.fields)
    check(torch.equal(got, want), "local_field_init bit-equal to plain")
    lf = {"err": max_abs_err([got], [want])}
    lf["ms"] = cuda_ms(lambda: local_field.local_field_init(
        s0, problem.couplings, problem.fields), 50)
    lf["plain_ms"] = cuda_ms(lambda: ref.local_field_init(
        s0, problem.couplings, problem.fields), 50)
    lf["library_ms"] = cuda_ms(lambda: torch.addmm(
        problem.fields, s0, problem.couplings.T), 50)
    lf["bound"] = bound(4 * (N * N + R * N + N + R * N), 2 * R * N * N)

    sw = {}
    print("[kernels] mcmc_sweep RSA + PWL against its plain version "
          f"(R={R}, N={N}, T={T})")
    args = (problem.couplings, u0, s0, e0, unif, temps, tbl)
    got = sweep.mcmc_sweep(*args, mode="rsa")
    want = ref.mcmc_sweep(*args, mode="rsa")
    names = ("u", "s", "e", "best_e", "best_s", "num_flips", "rows_fetched")
    for name, a, b in zip(names, got, want):
        check(torch.equal(a, b), f"rsa+pwl {name} bit-equal to plain")
    invariants(problem, got, T, "rsa+pwl kernel")
    sw["rsa"] = {"err": max_abs_err(got, want), "flips": int(got[5].sum())}

    variants = {"rwa": dict(mode="rwa", pwl=True, uniformized=False),
                "rwa-uniformized": dict(mode="rwa", pwl=True,
                                        uniformized=True),
                "rwa-exact-sigmoid": dict(mode="rwa", pwl=False,
                                          uniformized=False)}
    for label, v in variants.items():
        print(f"[kernels] mcmc_sweep {label}: invariants over T={T}, then "
              "per-step picks from 512 states")
        table = tbl if v["pwl"] else None
        got = sweep.mcmc_sweep(problem.couplings, u0, s0, e0, unif, temps,
                               table, mode="rwa",
                               uniformized=v["uniformized"])
        invariants(problem, got, T, f"{label} kernel")
        flips = int(got[5].sum())
        # One step from 512 random states at temperatures across the anneal.
        ru = 512
        all_temps = cfg["rwa"].schedule(
            torch.linspace(0, STEPS - 1, ru).to(torch.int32))
        pu0, ps0, pe0, punif, _ = sweep_inputs(problem, ru, 1, temps0[:1],
                                               SEED + 1)
        ptemps = all_temps.to("cuda")[None, :].contiguous()
        a = sweep.mcmc_sweep(problem.couplings, pu0, ps0, pe0, punif, ptemps,
                             table, mode="rwa", uniformized=v["uniformized"])
        b = ref.mcmc_sweep(problem.couplings, pu0, ps0, pe0, punif, ptemps,
                           table, mode="rwa", uniformized=v["uniformized"])
        p_all = common.flip_probability(2.0 * ps0 * pu0, ptemps[0][:, None],
                                        table)
        tie = roulette_near_tie(p_all, punif[0, :, 2], punif[0, :, 3],
                                v["uniformized"])
        keep = ~tie
        for name, x, y in zip(names, a, b):
            check(torch.equal(x[keep], y[keep]),
                  f"{label} {name} equal on {int(keep.sum())} of {ru} "
                  f"states ({int(tie.sum())} near ties)")
        sw[label] = {"err": max_abs_err([x[keep] for x in a[:5]],
                                        [y[keep] for y in b[:5]]),
                     "flips": flips, "pwl": v["pwl"],
                     "uniformized": v["uniformized"]}

    print("[reference] small input: the card's solve against the CPU's "
          "(N=250, RSA + PWL, linear schedule)")
    small = maxcut_to_ising(complete_bipolar(250, seed=3))
    small_cfg = SolverConfig(num_steps=1024, schedule=linear(16.0, 0.05, 1024),
                             mode="rsa", trace_every=256)
    on_card = solve(small, 7, small_cfg, backend="fused", device="cuda")
    on_cpu = solve(small, 7, small_cfg, backend="fused", device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        check(torch.equal(a.cpu(), b), f"N=250 solve {name}: card == CPU")

    print("[reference] K2000 itself, a 1024-step RSA solve: "
          "the card's solve against the CPU's")
    short = default_solver(N, 1024, mode="rsa")
    on_card = solve(problem, SEED, short, backend="fused")
    on_cpu = solve(problem, SEED, short, backend="fused", device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        check(torch.equal(a.cpu(), b), f"K2000 1024-step solve {name}: "
              "card == CPU")

    print(f"[main] solve(K2000, seed={SEED}, default_solver(2000, {STEPS}, "
          f"mode), backend='fused'), R={R}")
    solve(problem, SEED, default_solver(N, 512, mode="rwa"), backend="fused")
    main_runs = {}
    for mode in ("rsa", "rwa"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sweep.counter.reset()
        local_field.counter.reset()
        t0 = time.perf_counter()
        res = solve(problem, SEED, cfg[mode], backend="fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"sweep": sweep.counter.count,
                    "init": local_field.counter.count}
        peak = torch.cuda.max_memory_allocated()
        cuts = cut_from_energy(inst, res.best_energy.cpu().numpy())
        flips = int(res.num_flips.sum())
        print(f"[main] {mode}: best cut {cuts.max():.0f} (per replica "
              f"{sorted(cuts.tolist(), reverse=True)}), "
              f"{wall / STEPS * 1e6:.3f} us/step, {flips / wall:.4e} flips/s, "
              f"wall {wall:.4f} s, peak device memory {peak / 2**20:.1f} MiB, "
              f"launches sweep={launches['sweep']} init={launches['init']}")
        check(launches["sweep"] == math.ceil(STEPS / 256),
              f"{mode}: sweep launched ceil({STEPS}/256) = 79 times")
        check(launches["init"] == 1, f"{mode}: local_field_init launched once")
        check(tuple(res.best_spins.shape) == (R, N)
              and bool(torch.isfinite(res.best_energy).all()),
              f"{mode}: results have shape (R, N) and are finite")
        check(torch.equal(res.best_energy,
                          ising.energy(problem, res.best_spins)),
              f"{mode}: best_energy == energy(best_spins) exactly")
        check(int(res.rows_fetched.sum()) == R * STEPS,
              f"{mode}: sum(rows_fetched) == R*steps")
        if mode == "rwa":
            check(flips == R * STEPS, "rwa: rejection-free, one flip a step")
        check(cuts.max() > 0, f"{mode}: best cut positive")
        main_runs[mode] = launches

    print("[profile] torch.profiler over one RWA main-path solve")
    profile_main_path(problem, cfg["rwa"])

    print("[timing] CUDA events at the main path's shapes")
    for label, entry in sw.items():
        mode = "rsa" if label == "rsa" else "rwa"
        table = tbl if entry.get("pwl", True) else None
        uni = entry.get("uniformized", False)
        run = (lambda table=table, mode=mode, uni=uni: sweep.mcmc_sweep(
            problem.couplings, u0, s0, e0, unif, temps, table, mode=mode,
            uniformized=uni))
        entry["ms"] = cuda_ms(run, 20)
        entry["plain_ms"] = cuda_ms(lambda table=table, mode=mode, uni=uni:
                                    ref.mcmc_sweep(problem.couplings, u0, s0,
                                                   e0, unif, temps, table,
                                                   mode=mode,
                                                   uniformized=uni), 2)
        entry["bound"] = bound(*sweep_bytes_flops(
            mode, R, N, T, entry["flips"], segs if table is not None else 0))
        print(f"[timing] mcmc_sweep {label}: {entry['ms']:.4f} ms "
              f"({entry['ms'] / T * 1e3:.3f} us/step), plain "
              f"{entry['plain_ms']:.2f} ms, bound {entry['bound'][0]:.5f} ms")
    print(f"[timing] local_field_init: {lf['ms']:.5f} ms, plain "
          f"{lf['plain_ms']:.5f} ms, torch.addmm {lf['library_ms']:.5f} ms, "
          f"bound {lf['bound'][0]:.5f} ms")

    src = "src/repro_torch/kernels/csrc/"
    line = {"kernels": []}
    # The main path runs the sweep's RSA + PWL and RWA + PWL instances; the
    # uniformized and exact-sigmoid instances are checked and timed above.
    for label in ("rsa", "rwa"):
        entry = sw[label]
        mode = label
        line["kernels"].append({
            "name": f"mcmc_sweep[{label}]", "route": "cuda",
            "source": src + "sweep.cu",
            "replaces": "src/repro/kernels/sweep.py:555",
            "launches": main_runs[mode]["sweep"],
            "max_abs_err": entry["err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound"][0],
            "bound_by": entry["bound"][1], "library_ms": None})
    line["kernels"].append({
        "name": "local_field_init", "route": "cuda",
        "source": src + "local_field.cu",
        "replaces": "src/repro/kernels/local_field.py:42",
        "launches": main_runs["rsa"]["init"] + main_runs["rwa"]["init"],
        "max_abs_err": lf["err"], "ms": lf["ms"], "plain_ms": lf["plain_ms"],
        "bound_ms": lf["bound"][0], "bound_by": lf["bound"][1],
        "library_ms": lf["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
