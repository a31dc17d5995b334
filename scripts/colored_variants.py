"""Measure kernel D, the colored sweep, on the card: its route and the
earlier kernel side by side, the route's latency floor, and clock64
stamps of each design's step.

Builds ``scripts/colored_variants.cu`` through the kernels' build cache
twice with clock64 stamps at the step's phase boundaries: once around
``src/repro_torch/kernels/csrc/colored_sweep_hopper.cu`` (``colored_stamps``,
which also holds the floor and the occupancy query) and once around the
earlier ``colored_sweep.cu`` (``colored_stamps17``). The stamped builds
launch through ``sweep._colored_launch(..., entry=...)``, which counts
nothing. On each shape (:func:`shape`: the sparse N=16384, χ=11 anchor on
``bitplane_hbm`` at R=8 and 32 and on the dense tier, a 32×32 torus and
sparse N=4096 on ``bitplane_hbm``; 256-step keyed launches, PWL,
temperatures across the anneal) it prints, as one JSON object:

* ``route`` / ``pr17``: device ms per launch of the route at every width
  and of the earlier kernel at every width of its own (10 launches
  replayed as one CUDA graph), each launch's outputs checked bitwise
  against the plain version's;
* ``floor``: the route's latency floor (one exchange and the block
  barrier a step: ``snowball_colored_floor``) at every width;
* ``clusters_held``: the card's occupancy (clusters of the route's kernel
  it holds at once) at every width;
* ``stamps`` / ``stamps17``: after checking that the stamped build's seven
  outputs equal its kernel's bitwise, the split of a step at the rule's
  width (threads 0's and 32's SM clocks a phase a step, the mean over the
  ranks of replica 0, µs at the SM clock the loop ran at, from
  %globaltimer).

    python scripts/colored_variants.py [--shapes anchor torus32 dense]
        [--main route pr17]

One JSON object a line on standard output, progress on standard error; the
card's name and power limit on the first line. Needs the card.
``chip_smoke.py`` takes the floor and the stamps through :data:`VARIANTS`,
:func:`load` and :func:`measure`.
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

from repro_torch.kernels import _build, ref, sweep  # noqa: E402

R, T, REPS = 8, 256, 10
SOURCE = ROOT / "scripts" / "colored_variants.cu"
#: The measurement builds (``_build.build``'s ``variants``).
VARIANTS = {"colored_stamps": (SOURCE, "colored_sweep_hopper",
                               ("-DCOLORED_STAMPS",)),
            "colored_stamps17": (SOURCE, "colored_sweep",
                                 ("-DCOLORED_STAMPS", "-DCOLORED_PR17"))}
#: The phases of a step each design stamps (threads 0 and 32 alike).
PHASES = {"colored_stamps": ("accept pass + posts", "mail wait",
                             "e, flips, best_s", "rows copied and in",
                             "apply + block barrier", "-"),
          "colored_stamps17": ("accept pass + block barrier",
                               "partials + cluster barrier",
                               "e + compaction", "row loads + apply",
                               "best_s", "block barrier")}
NAMES = ("u", "s", "e", "best_e", "best_s", "num_flips", "rows_fetched")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(built: dict) -> dict:
    """The loaded libraries of the variants in ``built`` (what
    ``_build.build(..., variants=VARIANTS)`` returned), by name."""
    return {name: ctypes.CDLL(str(built[name].path)) for name in VARIANTS
            if name in built}


def entry(lib, name: str):
    """The colored sweep's entry of a measurement build."""
    return sweep.colored_entry(lib, sweep.COLORED_ENTRIES[
        "colored_sweep" if name == "colored_stamps17"
        else "colored_sweep_hopper"])


def graph_ms(fn) -> float:
    """Device ms per call: :data:`REPS` calls replayed as one CUDA graph,
    timed by CUDA events after a warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


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


def read_stamps(lib) -> list:
    buf = (ctypes.c_ulonglong * (16 * 2 * 12))()
    if lib.colored_read_stamps(buf, 1):
        raise RuntimeError("stamps not read")
    return list(buf)


class Shape:
    """One shape's operands and its keyed colored launches at a width, by
    a route or by a measurement build's entry (not counted)."""

    def __init__(self, plan, fmt: str, args, tbl, words, plain=None):
        self.plan, self.fmt, self.tbl, self.words = plan, fmt, tbl, words
        self.op = plan.store.kernel_operand
        self.u0, self.s0, self.e0, self.unif, self.temps, self.sched = args
        self.r, self.n = self.u0.shape
        self.t = self.temps.shape[0]
        self.win = plan.window
        self.segs = tbl.shape[0] - 1
        self.dense = fmt == "dense"
        self.planes = 0 if self.dense else self.op.num_planes
        kw = dict(num_planes=max(self.planes, 1))
        self.fits = sweep.colored_widths(self.n, self.win, self.segs,
                                         self.dense, **kw)
        self.fits17 = sweep.colored_widths(self.n, self.win, self.segs,
                                           self.dense, pr17=True, **kw)
        self.rule = sweep.colored_width(self.n, self.win, self.segs, self.r,
                                        self.dense, **kw)
        self.rule17 = sweep.colored_width(self.n, self.win, self.segs,
                                          self.r, self.dense, pr17=True, **kw)
        self._plain = plain

    def run(self, c: int, fn=None, pr17: bool = False):
        return sweep._colored_launch(
            self.op, self.u0, self.s0, self.e0, self.temps, self.sched,
            self.tbl, uniforms=None, key=(self.words, 0), window=self.win,
            block_r=8, width=c, pr17=pr17, entry=fn)

    def plain(self):
        """The plain version on the uniforms the keyed launch draws."""
        if self._plain is None:
            self._plain = ref.colored_sweep(self.op, self.u0, self.s0,
                                            self.e0, self.unif, self.temps,
                                            self.sched, self.tbl)
        return self._plain

    def check(self, got, what: str) -> None:
        bad = [nm for nm, a, b in zip(NAMES, got, self.plain())
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"N={self.n} {self.fmt}: {what} differs "
                                 f"from the plain version in {bad}")


def stamp_split(lib, name: str, run, width: int, t: int) -> dict:
    read_stamps(lib)
    run()
    torch.cuda.synchronize()
    buf = read_stamps(lib)
    out = {"width": width}
    names = PHASES[name]
    for who, key in enumerate(("thread0", "thread32")):
        at = lambda q, k: buf[(q * 2 + who) * 12 + k]  # noqa: E731
        ns = sum(at(q, 10) for q in range(width)) / width
        clk = sum(at(q, 11) for q in range(width)) / width
        mhz = clk / ns * 1e3 if ns else 0.0
        mean = {names[k - 1]: sum(at(q, k) for q in range(width)) / width / t
                for k in range(1, len(names) + 1)}
        out[key] = {"loop_mhz": mhz, "mean_clocks": mean,
                    "mean_us": {k: v / mhz if mhz else 0.0
                                for k, v in mean.items()},
                    "step_us": ns / 1e3 / t}
    return out


def measure(libs: dict, name: str, sh: Shape,
            main=("route", "pr17")) -> dict:
    """One shape's row: the floor and the occupancy at every width of the
    route and the stamped splits at the rules' widths (of the builds in
    ``libs``); the designs named in ``main`` at every width, checked
    bitwise."""
    row = {"shape": name, "n": sh.n, "fmt": sh.fmt, "r": sh.r, "t": sh.t,
           "window": sh.win, "rule": sh.rule, "rule17": sh.rule17,
           "ring": {c: sweep.colored_ring(sh.n, sh.win, sh.segs, c,
                                          sh.dense, max(sh.planes, 1))
                    for c in sh.fits}}
    if "route" in main:
        row["route"] = {}
        for c in sh.fits:
            sh.check(sh.run(c), f"the route at C={c}")
            row["route"][c] = graph_ms(lambda c=c: sh.run(c))
    if "pr17" in main:
        row["pr17"] = {}
        for c in sh.fits17:
            sh.check(sh.run(c, pr17=True), f"the earlier kernel at C={c}")
            row["pr17"][c] = graph_ms(lambda c=c: sh.run(c, pr17=True))
    lib = libs.get("colored_stamps")
    if lib is None:
        return _stamps(libs, sh, row)
    floor = lib.snowball_colored_floor
    p, i = ctypes.c_void_p, ctypes.c_int
    floor.argtypes = [i] * 3 + [p] * 2
    sink = torch.empty(sh.r * 16, dtype=torch.int32, device=sh.u0.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run_floor(c):
        rc = floor(sh.r, sh.t, c, sink.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"floor launch failed: CUDA error {rc}")
    row["floor"] = {c: cuda_ms(lambda c=c: run_floor(c)) for c in sh.fits}
    occ = lib.snowball_colored_max_clusters
    occ.argtypes = [i] * 6
    row["clusters_held"] = {c: occ(sh.n, sh.win, sh.segs, c, sh.planes,
                                   sh.r) for c in sh.fits}
    return _stamps(libs, sh, row)


def _stamps(libs: dict, sh: Shape, row: dict) -> dict:
    for var, pr17, c, key in (
            ("colored_stamps", False, sh.rule, "stamps"),
            ("colored_stamps17", True, sh.rule17, "stamps17")):
        if var not in libs:
            continue
        fn = entry(libs[var], var)
        sh.check(sh.run(c, fn, pr17), f"the stamped build {var} at C={c}")
        row[key] = stamp_split(
            libs[var], var, lambda fn=fn, c=c, pr17=pr17: sh.run(c, fn, pr17),
            c, sh.t)
    return row


def make_shape(edges, fmt: str, words, t: int = T, r: int = R) -> Shape:
    """The plan of ``edges`` (greedy coloring) on tier ``fmt`` and keyed
    inputs of ``r`` replicas and ``t`` steps on the card: the solve's init,
    PWL, temperatures across an anneal of 64·χ steps."""
    from repro_torch.configs.snowball import default_solver
    from repro_torch.core import ising, rng
    from repro_torch.graphs import greedy_coloring
    from repro_torch.kernels import ops
    prob = ising.IsingProblem.create_sparse(edges, device="cuda")
    if fmt == "dense":
        prob = ising.IsingProblem(torch.from_numpy(edges.to_dense()).to(
            "cuda"), prob.fields)
    plan = ops.ColoredPlan(greedy_coloring(edges), prob, fmt).to("cuda")
    chi = plan.coloring.num_classes
    cfg = default_solver(prob.num_spins, 64 * chi, mode="rsa")
    tbl = ops.solver_pwl_table(cfg, device="cuda")
    temps = cfg.schedule(torch.linspace(0, 64 * chi - 1, t).to(
        torch.int32)).to("cuda", torch.float32)[:, None].expand(t, r)
    base = rng.from_words(*words).to("cuda")
    u0, s0, e0, *_ = ops.fused_init_state(plan.problem, base, r,
                                          planes=plan.store.planes)
    unif = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, 0),
                         (t, r, plan.window))
    sched = ops.colored_class_schedule(plan.wstarts, plan.offsets, plan.sizes,
                                       torch.arange(t, device="cuda"))
    return Shape(plan, fmt, (u0, s0, e0, unif, temps.contiguous(), sched),
                 tbl, words)


def shape(name: str, words) -> Shape:
    """The named shape: ``anchor`` (the sparse N=16384 instance on
    ``bitplane_hbm``), ``anchor32`` (the same at R=32), ``dense`` (the
    anchor on the dense tier), ``torus32`` (a 32×32 torus on
    ``bitplane_hbm``) or ``n4096`` (sparse N=4096 on ``bitplane_hbm``)."""
    from repro_torch.graphs import sparse_bipolar_edges, torus_grid_edges
    if name == "torus32":
        edges = torus_grid_edges(32, 32, seed=1)
    elif name == "n4096":
        edges = sparse_bipolar_edges(4096, 8 * 4096, seed=4096)
    else:
        edges = sparse_bipolar_edges(16384, 8 * 16384, seed=16384)
    return make_shape(edges, "dense" if name == "dense" else "bitplane_hbm",
                      words, r=32 if name == "anchor32" else R)


def main() -> None:
    from repro_torch.core import rng
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+",
                    default=["anchor", "torus32", "dense"])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--main", nargs="*", default=["route", "pr17"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("colored_variants: needs the card")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}), flush=True)
    t0 = time.perf_counter()
    kernels = (["colored_sweep_hopper"] if "route" in args.main else []) \
        + ["colored_sweep"]
    built = _build.build(kernels, variants={k: VARIANTS[k]
                                            for k in args.variants})
    libs = load(built)
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    words = rng.words(rng.fold_in(rng.key(0), 0))
    for name in args.shapes:
        row = measure(libs, name, shape(name, words), args.main)
        print(json.dumps(row), flush=True)
        log(f"[{name}] done {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ptxas": {
        name: sorted({line.split("ptxas info    : ")[-1]
                      for line in b.log.splitlines()
                      if "registers" in line or "spill" in line})
        for name, b in built.items()}}), flush=True)


if __name__ == "__main__":
    main()
