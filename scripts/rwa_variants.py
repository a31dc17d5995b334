"""Measure design variants of kernel A's RWA step on the card.

Builds ``scripts/rwa_variants.cu`` (which includes
``src/repro_torch/kernels/csrc/sweep_rwa.cu``) with ``nvcc``, once per
variant, all at once: the kernel at 256, 512 and 1,024 threads a block,
with its waits spinning on ``test_wait``, and with clock64 stamps at the
step's phase boundaries. On each shape (K2000 dense, K4096 ``bitplane``,
the sparse N=16384 and N=14,481 ``bitplane_hbm`` instances; R=8, 256-step
launches of the keyed sweep, PWL) it prints, per variant and cluster
width, the ms per launch by CUDA events (the mean of 10 after a warm-up)
beside the main build's, after checking that the variant's seven outputs
equal the main build's bitwise; the latency floor of a step (two
exchanges and the row read, no arithmetic: ``snowball_rwa_floor``) at
each width, on ``bitplane_hbm`` also with the row's words brought in by
``cp.async.bulk`` (``snowball_rwa_floor_bulk``); and the stamps' split of
a step (SM clocks a step of replica 0's rank 0 and the mean over its
ranks, and µs at the SM clock ``nvidia-smi`` reads after the run) at the
width the rule picks.

    python scripts/rwa_variants.py [--shapes k2000 k4096 n16384 n14481]

One JSON object a line on standard output, progress on standard error;
the card's name and power limit on the first line. Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.snowball import default_solver  # noqa: E402
from repro_torch.core import ising, rng  # noqa: E402
from repro_torch.core.bitplane import pack_spins  # noqa: E402
from repro_torch.core.coupling import CouplingStore  # noqa: E402
from repro_torch.graphs import (complete_bipolar, maxcut_to_ising,  # noqa: E402
                                sparse_bipolar_edges)
from repro_torch.kernels import _build, ops, ref, sweep  # noqa: E402

R, T, REPS = 8, 256, 10
OUT = ROOT / "build" / "rwa_variants"
VARIANTS = {"t256": ("-DSNOWBALL_RWA_THREADS=256",),
            "t512": ("-DSNOWBALL_RWA_THREADS=512",),
            "t1024": ("-DSNOWBALL_RWA_THREADS=1024",),
            "test_wait": ("-DRWA_TEST_WAIT",),
            "stamps": ("-DRWA_STAMPS",)}
PHASES = ("exchange 1", "descend", "exchange 2", "row read",
          "apply + evaluate", "block barrier", "subtree + post")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS["sweep_rwa"]]
    procs = {}
    for name, extra in VARIANTS.items():
        cmd = [_build.nvcc_path(), *flags, *extra, "-I", str(_build.CSRC),
               "-o", str(OUT / f"{name}.so"), str(ROOT / "scripts" /
                                                   "rwa_variants.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        spills = [line for line in out.splitlines() if "spill" in line]
        log(f"[build] {name}: " + "; ".join(sorted(set(
            line.split("ptxas info    : ")[-1] for line in spills))))
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def entry(lib):
    fn = lib.snowball_sweep_rwa
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 4 + [w] * 2 + [i] * 2
                   + [p] * 2 + [i] + [p] * 9 + [i] * 6 + [p])
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def shapes(names):
    for name in names:
        if name == "k2000":
            prob = maxcut_to_ising(complete_bipolar(2000, seed=0),
                                   device="cuda")
            yield name, prob, prob.couplings, "dense"
        elif name == "k4096":
            prob = maxcut_to_ising(complete_bipolar(4096, seed=4096),
                                   device="cuda")
            store = CouplingStore.build(prob.couplings, "bitplane").to("cuda")
            yield name, prob, store.planes, "bitplane"
        else:
            n = int(name[1:])
            edges = sparse_bipolar_edges(n, 8 * n, seed=n)
            prob = ising.IsingProblem.create_sparse(edges, device="cuda")
            store = CouplingStore.build(edges, "bitplane_hbm").to("cuda")
            yield name, prob, store.planes, "bitplane_hbm"


def inputs(prob, operand, fmt):
    n = prob.num_spins
    key = rng.fold_in(rng.key(0, device="cuda"), 0)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(R, device="cuda")),
                            (n,)).to(torch.float32)
    if fmt == "dense":
        u0 = ref.local_field_init(s0, prob.couplings, prob.fields)
        e0 = ising.energy(prob, s0)
    else:
        uj = ref.bitplane_field_init(operand.pos, operand.neg,
                                     pack_spins(s0, operand.num_words))
        e0 = ising.energy_from_fields(uj, s0, prob.fields)
        u0 = uj + prob.fields
    cfg = default_solver(n, 20000, mode="rwa")
    temps = cfg.schedule(torch.arange(T, dtype=torch.int32)).to("cuda")
    return (u0, s0, e0, temps[:, None].expand(T, R).contiguous(),
            ops.solver_pwl_table(cfg, device="cuda"))


def stamp_split(lib, run, width) -> dict:
    buf = (ctypes.c_ulonglong * (16 * 8))()
    lib.rwa_read_stamps(buf, 1)
    run()
    torch.cuda.synchronize()
    if lib.rwa_read_stamps(buf, 1):
        raise RuntimeError("stamps not read")
    clocks = [[buf[q * 8 + k] / T for k in range(8)] for q in range(width)]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    rank0 = {PHASES[k - 1]: clocks[0][k] for k in range(1, 8)}
    mean = {PHASES[k - 1]: sum(c[k] for c in clocks) / width
            for k in range(1, 8)}
    return {"width": width, "sm_mhz": mhz, "rank0_clocks": rank0,
            "mean_clocks": mean,
            "mean_us": {k: v / mhz for k, v in mean.items()},
            "step_us": sum(mean.values()) / mhz}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+",
                    default=["k2000", "k4096", "n16384", "n14481"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rwa_variants: needs the card")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}), flush=True)
    t0 = time.perf_counter()
    main_log = _build.build(["sweep_rwa"])["sweep_rwa"].log
    libs = build()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    words = rng.words(rng.fold_in(rng.key(0), 0))
    main_fn = sweep._rwa_fn()
    for name, prob, operand, fmt in shapes(args.shapes):
        u0, s0, e0, temps, tbl = inputs(prob, operand, fmt)
        n = prob.num_spins
        segs = tbl.shape[0] - 1
        fits = sweep.widths(n, 1, segs, True)
        rule = sweep.cluster_width(n, 1, segs, True, fmt != "dense", R)

        def run(c, fn=None):
            if fn is not None:
                sweep._rwa_fn = lambda: fn
            try:
                return sweep.mcmc_sweep_at_width(
                    c, operand, u0, s0, e0, temps, tbl, base_words=words,
                    chunk=0, mode="rwa", coupling=fmt)
            finally:
                sweep._rwa_fn = lambda: main_fn

        row = {"shape": name, "n": n, "fmt": fmt, "rule": rule,
               "main": {c: cuda_ms(lambda c=c: run(c)) for c in fits}}
        for var in ("t256", "t512", "t1024", "test_wait"):
            fn = entry(libs[var])
            want = run(rule)
            got = run(rule, fn)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name}: variant {var} differs from "
                                     "the main build")
            row[var] = {c: cuda_ms(lambda c=c, fn=fn: run(c, fn))
                        for c in fits}
        floor = libs["t256"].snowball_rwa_floor
        p, i = ctypes.c_void_p, ctypes.c_int
        floor.argtypes = [p] * 3 + [i] * 6 + [p] * 2
        out = torch.empty((R, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        if fmt == "dense":
            store = (operand.data_ptr(), None, None, 0, 0)
        else:
            store = (None, operand.pos.data_ptr(), operand.neg.data_ptr(),
                     operand.num_planes, operand.num_words)

        def run_floor(c):
            rc = floor(*store, R, n, T, c, out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"floor launch failed: {rc}")
        row["floor"] = {c: cuda_ms(lambda c=c: run_floor(c)) for c in fits}
        if fmt == "bitplane_hbm":
            bulk = libs["t256"].snowball_rwa_floor_bulk
            bulk.argtypes = [p] * 2 + [i] * 6 + [p] * 2

            def run_bulk(c):
                rc = bulk(*store[1:], R, n, T, c, out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"bulk floor launch failed: {rc}")
            row["floor_bulk"] = {c: cuda_ms(lambda c=c: run_bulk(c))
                                 for c in fits}
        stamped = entry(libs["stamps"])
        row["split"] = stamp_split(libs["stamps"],
                                   lambda: run(rule, stamped), rule)
        print(json.dumps(row), flush=True)
        log(f"[{name}] done {time.perf_counter() - t0:.1f} s")
    regs = [line for line in main_log.splitlines() if "registers" in line]
    print(json.dumps({"ptxas": sorted(set(
        line.split("ptxas info    : ")[-1] for line in regs))}), flush=True)


if __name__ == "__main__":
    main()
