"""Measure design variants of kernel A's RSA step on the card.

Builds ``scripts/rsa_variants.cu`` (which includes
``src/repro_torch/kernels/csrc/sweep_rsa.cu``) through the kernels' build
cache, once with clock64 stamps at the step's phase boundaries
(``rsa_stamps``) and once with the ring filled by ``cp.async.bulk``
(``rsa_bulk``). On each shape (K2000 dense, K4096 ``bitplane``, the sparse
N=16384, N=14,481 and N=20,011 ``bitplane_hbm`` instances; R=8, 256-step
launches of the keyed sweep, PWL) it prints, as one JSON object:

* ``main``: the kernel's device ms per launch at every cluster width (10
  launches replayed as one CUDA graph); ``main_host``: the same calls
  back to back from the host by CUDA events (host dispatch included where
  it outlasts a launch);
* ``floor``: the latency floor of a step (the one exchange, sent by the
  thread that owns the next site as soon as the decision reaches it, and
  the window's flow: ``snowball_rsa_floor``) at each width;
* ``split``: after checking that the stamped build's seven outputs equal
  the kernel's bitwise, the stamps' split of a step at the width the rule
  picks (thread 0's SM clocks a phase a step, the mean over the ranks of
  replica 0, µs at the SM clock ``nvidia-smi`` reads after the run; and
  thread 32's);
* ``bulk``: at c = 1, 2 and 8, the kernel (the warps' ``cp.async``
  copies) and the bulk-fill build in turns (kernel, bulk, bulk, kernel;
  device ms by graph replay),
  the bulk build's outputs checked bitwise against the kernel's (shapes
  whose rows are 16-byte aligned);
* ``spread``: the card's occupancy (clusters it holds at once) at every
  width; at the rule's width and the next, 200 back-to-back launches each
  timed by its own events (quantiles), 200 replays of a one-launch CUDA
  graph each timed (quantiles), 10 launches each the first after
  the host idled 50 ms, and the stamped build's launches, 32 each after a
  sync and 10 each after 50 ms idle, each timed and its stamps read:
  thread 0's loop on ``%globaltimer`` and in SM clocks (their ratio the
  clock rate the loop ran at), the launch's time outside the loop, and the
  phases' clocks (the means of the faster and slower halves of the 32,
  and of the 10).

    python scripts/rsa_variants.py [--shapes k2000 k4096 n16384 n14481 n20011]

One JSON object a line on standard output, progress on standard error; the
card's name and power limit on the first line. Needs the card.
``chip_smoke.py`` takes the floor and the split through :data:`VARIANTS`,
:func:`load` and :func:`measure`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, sweep  # noqa: E402

R, T, REPS = 8, 256, 10
SOURCE = ROOT / "scripts" / "rsa_variants.cu"
#: The measurement builds (``_build.build``'s ``variants``).
VARIANTS = {"rsa_stamps": (SOURCE, "sweep_rsa", ("-DRSA_STAMPS",)),
            "rsa_bulk": (SOURCE, "sweep_rsa", ("-DRSA_BULK_FILL",))}
#: The widths of the bulk-fill comparison.
BULK_WIDTHS = (1, 2, 8)
#: The phases of a step: thread 0 (warp 0 decides) and thread 32 (warp 1
#: applies) each stamp them.
PHASES = ("exchange wait", "ring wait + apply", "block barrier",
          "window flow", "decide + post / fill")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(built: dict) -> dict:
    """The loaded libraries of the variants in ``built`` (what
    ``_build.build(..., variants=VARIANTS)`` returned), by name."""
    return {name: ctypes.CDLL(str(built[name].path)) for name in VARIANTS
            if name in built}


def entry(lib):
    fn = lib.snowball_sweep_rsa
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = ([p] * 3 + [i] * 2 + [p] * 4 + [w] * 2 + [i] * 2
                   + [p] * 2 + [i] + [p] * 9 + [i] * 5 + [p])
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


def graph_of(fn, reps: int):
    """``reps`` calls of ``fn`` captured in one CUDA graph (after a warm-up
    call off the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return graph


def graph_ms(fn) -> float:
    """Device ms per call: :data:`REPS` calls replayed as one CUDA graph,
    timed by CUDA events after a warm-up replay (no host dispatch between
    the launches)."""
    graph = graph_of(fn, REPS)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def each_ms(fn, n: int, after=None, warm: bool = True) -> list:
    """The ms of each of ``n`` launches (an event pair each), after one
    untimed launch where ``warm``; ``after(k)`` runs on the host after
    launch k has finished, when given."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    if warm:
        fn()
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(ev):
        a.record()
        fn()
        b.record()
        if after is not None:
            torch.cuda.synchronize()
            after(k)
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def quantiles(ms: list) -> dict:
    xs = sorted(ms)
    q = statistics.quantiles(xs, n=10)
    return {"n": len(xs), "min": xs[0], "p10": q[0], "p50": q[4],
            "p90": q[8], "max": xs[-1],
            "over_1.5x_min": sum(x > 1.5 * xs[0] for x in xs)}


def sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])


def read_stamps(lib) -> list:
    buf = (ctypes.c_ulonglong * (16 * 2 * 8))()
    if lib.rsa_read_stamps(buf, 1):
        raise RuntimeError("stamps not read")
    return list(buf)


def stamp_split(lib, run, width, t) -> dict:
    read_stamps(lib)
    run()
    torch.cuda.synchronize()
    buf = read_stamps(lib)
    mhz = sm_mhz()
    out = {"width": width, "sm_mhz": mhz}
    for who, name in ((0, "thread0"), (1, "thread32")):
        mean = {PHASES[k - 1]: sum(buf[(q * 2 + who) * 8 + k] / t
                                   for q in range(width)) / width
                for k in range(1, 6)}
        out[name] = {"mean_clocks": mean,
                     "mean_us": {k: v / mhz for k, v in mean.items()},
                     "step_us": sum(mean.values()) / mhz}
    return out


class Shape:
    """One shape's operands and its RSA launches at a width, by the
    kernel's route or by a measurement build's entry (not counted)."""

    def __init__(self, operand, fmt: str, args, tbl, words):
        self.operand, self.fmt = operand, fmt
        self.tbl, self.words = tbl, words
        self.u0, self.s0, self.e0, self.temps = args
        self.r, self.n = self.u0.shape
        self.t = self.temps.shape[0]
        self.segs = tbl.shape[0] - 1
        self.planes = 0 if fmt == "dense" else operand.num_planes
        self.fits = sweep.widths(self.n, 1, self.segs, False,
                                 num_planes=self.planes)
        self.rule = sweep.cluster_width(self.n, 1, self.segs, False,
                                        fmt != "dense", self.r,
                                        num_planes=self.planes)
        self.lane, self.coalesce = sweep._check_call(
            operand, self.u0, "rsa", "dynamic", fmt, None, True)

    def run(self, c: int, fn=None):
        return sweep._launch(
            self.operand, self.u0, self.s0, self.e0, self.temps, self.tbl,
            uniforms=None, key=(self.words, 0, None), mode="rsa",
            uniformized=False, block_r=8, lane=self.lane,
            coalesce=self.coalesce, width=c, entry=fn)

    def aligned(self) -> bool:
        if self.fmt == "dense":
            return self.n % 4 == 0
        return self.operand.num_words % 4 == 0

    def same(self, c: int, fn, what: str) -> None:
        if not all(torch.equal(a, b)
                   for a, b in zip(self.run(c, fn), self.run(c))):
            raise AssertionError(f"N={self.n} {self.fmt} c={c}: {what} "
                                 "differs from the kernel")


def measure(libs: dict, name: str, operand, fmt: str, args, tbl, words,
            main: bool = True) -> dict:
    """One shape's row: the floor at every width and the stamped split at
    the rule's width; with ``main``, the kernel at every width too. ``args``
    = (u0, s0, e0, temps) at R replicas and T steps."""
    sh = Shape(operand, fmt, args, tbl, words)
    row = {"shape": name, "n": sh.n, "fmt": fmt, "r": sh.r, "t": sh.t,
           "rule": sh.rule}
    if main:
        row["main"] = {c: graph_ms(lambda c=c: sh.run(c)) for c in sh.fits}
        row["main_host"] = {c: cuda_ms(lambda c=c: sh.run(c))
                            for c in sh.fits}
    floor = libs["rsa_stamps"].snowball_rsa_floor
    p, i = ctypes.c_void_p, ctypes.c_int
    floor.argtypes = [i] * 4 + [p] * 2
    sink = torch.empty(sh.r * 16, dtype=torch.int32, device=sh.u0.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run_floor(c):
        rc = floor(sh.r, sh.n, sh.t, c, sink.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"floor launch failed: CUDA error {rc}")
    row["floor"] = {c: cuda_ms(lambda c=c: run_floor(c)) for c in sh.fits}
    stamped = entry(libs["rsa_stamps"])
    sh.same(sh.rule, stamped, "the stamped build")
    row["split"] = stamp_split(libs["rsa_stamps"],
                               lambda: sh.run(sh.rule, stamped), sh.rule,
                               sh.t)
    return row


def bulk(libs: dict, sh: Shape) -> dict:
    """The kernel and the bulk-fill build at :data:`BULK_WIDTHS`, in turns
    (kernel, bulk, bulk, kernel), outputs checked bitwise."""
    fn = entry(libs["rsa_bulk"])
    out = {}
    for c in BULK_WIDTHS:
        if c not in sh.fits:
            continue
        sh.same(c, fn, "the bulk-fill build")
        k1 = graph_ms(lambda c=c: sh.run(c))
        b1 = graph_ms(lambda c=c: sh.run(c, fn))
        b2 = graph_ms(lambda c=c: sh.run(c, fn))
        k2 = graph_ms(lambda c=c: sh.run(c))
        out[c] = {"kernel_ms": [k1, k2], "bulk_ms": [b1, b2]}
    return out


def spread(libs: dict, sh: Shape) -> dict:
    """Occupancy at every width, and the launch-time distribution at the
    rule's width and the next (see the module's docstring)."""
    occ = libs["rsa_stamps"].snowball_rsa_max_clusters
    occ.argtypes = [ctypes.c_int] * 5
    out = {"clusters_held": {c: occ(sh.n, sh.planes, sh.segs, c, sh.r)
                             for c in sh.fits}}
    lib = libs["rsa_stamps"]
    stamped = entry(lib)
    for c in [w for w in sh.fits if w >= sh.rule][:2]:
        one = graph_of(lambda: sh.run(c), 1)
        row = {"hot": quantiles(each_ms(lambda: sh.run(c), 200)),
               "graph_each": quantiles(each_ms(one.replay, 200))}
        cold = []
        for _ in range(10):
            torch.cuda.synchronize()
            time.sleep(0.05)
            cold += each_ms(lambda: sh.run(c), 1, warm=False)
        row["after_idle_ms"] = cold
        sh.run(c, stamped)
        torch.cuda.synchronize()
        read_stamps(lib)
        loops = []

        def take(k):
            buf = read_stamps(lib)
            ns = sum(buf[q * 16 + 6] for q in range(c)) / c
            clk = sum(buf[q * 16 + 7] for q in range(c)) / c
            loops.append({"loop_us": ns / 1e3, "loop_mhz": clk / ns * 1e3,
                          "phase_clocks_a_step": {
                              PHASES[ph - 1]: sum(buf[q * 16 + ph]
                                                  for q in range(c))
                              / c / sh.t for ph in range(1, 6)}})
        ms = each_ms(lambda: sh.run(c, stamped), 32, after=take, warm=False)
        for _ in range(10):
            time.sleep(0.05)
            ms += each_ms(lambda: sh.run(c, stamped), 1, after=take,
                          warm=False)
        runs = [{"ms": m, **x} for m, x in zip(ms, loops)]
        synced = sorted(runs[:32], key=lambda x: x["ms"])
        row["stamped"] = {
            "after_a_sync": {"fast": _mean(synced[:16]),
                             "slow": _mean(synced[16:])},
            "after_idle": _mean(runs[32:]),
            "after_idle_each": [(x["ms"], x["loop_us"], x["loop_mhz"])
                                for x in runs[32:]]}
        out[c] = row
    return out


def _mean(runs: list) -> dict:
    """The mean launch ms, loop µs, loop MHz and phase clocks of ``runs``,
    with the launch's time outside the loop."""
    out = {k: statistics.fmean(x[k] for x in runs)
           for k in ("ms", "loop_us", "loop_mhz")}
    out["outside_loop_us"] = out["ms"] * 1e3 - out["loop_us"]
    out["phase_clocks_a_step"] = {
        ph: statistics.fmean(x["phase_clocks_a_step"][ph] for x in runs)
        for ph in PHASES}
    return out


def shapes(names):
    from repro_torch.core import ising
    from repro_torch.core.coupling import CouplingStore
    from repro_torch.graphs import (complete_bipolar, maxcut_to_ising,
                                    sparse_bipolar_edges)
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
    from repro_torch.configs.snowball import default_solver
    from repro_torch.core import ising, rng
    from repro_torch.core.bitplane import pack_spins
    from repro_torch.kernels import ops, ref
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
    cfg = default_solver(n, 20000, mode="rsa")
    temps = cfg.schedule(torch.arange(T, dtype=torch.int32)).to("cuda")
    return ((u0, s0, e0, temps[:, None].expand(T, R).contiguous()),
            ops.solver_pwl_table(cfg, device="cuda"))


def main() -> None:
    from repro_torch.core import rng
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+",
                    default=["k2000", "k4096", "n16384", "n14481",
                             "n20011"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rsa_variants: needs the card")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}), flush=True)
    t0 = time.perf_counter()
    built = _build.build(["sweep_rsa"], variants=VARIANTS)
    libs = load(built)
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    words = rng.words(rng.fold_in(rng.key(0), 0))
    for name, prob, operand, fmt in shapes(args.shapes):
        sargs, tbl = inputs(prob, operand, fmt)
        row = measure(libs, name, operand, fmt, sargs, tbl, words)
        sh = Shape(operand, fmt, sargs, tbl, words)
        if sh.aligned():
            row["bulk"] = bulk(libs, sh)
        row["spread"] = spread(libs, sh)
        print(json.dumps(row), flush=True)
        log(f"[{name}] done {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, b in built.items():
        out[name] = sorted({line.split("ptxas info    : ")[-1]
                            for line in b.log.splitlines()
                            if "registers" in line or "spill" in line})
    print(json.dumps({"ptxas": out}), flush=True)


if __name__ == "__main__":
    main()
