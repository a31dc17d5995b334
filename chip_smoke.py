"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version at the shapes of the main paths, drives
each main path with the launch counts zeroed just before it, and checks the
results:

* the dense tier on K2000 (N=2000, R=8, 256-step chunks): ``solve(K2000,
  seed, default_solver(2000, 20000, mode), backend="fused")``, RSA and RWA,
  with the local-field init timed by CUDA-graph replay beside
  ``torch.addmm``; the keyed sweep's device draw against ``rng.uniform01``
  and the keyed sweep against the reading one; for every single-flip
  main path its device idle share, launches per chunk (at most 8) and
  fixed cost, and kernel A's cluster-width sweep (c = 1, 2, 4, 8) beside
  its earlier one-block design's times;
* the ``bitplane`` tier on K4096 (``complete_bipolar(4096, seed=4096)``,
  20,000 steps) and the dense-J-free ``bitplane_hbm`` tier on the sparse
  N=16384 instance (``sparse_bipolar_edges(16384, 8·16384, seed=16384)`` →
  ``IsingProblem.create_sparse``, 65,536 steps), RSA and RWA, with the
  popcount init; plus the cross-tier check (dense, ``bitplane`` and
  ``bitplane_hbm`` trajectories bitwise equal at both sizes) and per-tier
  timings;
* the colored path on the same sparse N=16384 instance (greedy coloring,
  χ = 11): ``solve(P, 0, replace(default_solver(16384, 64·χ, mode="rsa"),
  flip_mode="colored", coupling_format="bitplane_hbm"), backend="colored")``,
  704 steps, with the colored sweep held against its plain version on all
  three tiers, on a χ=2 torus and at N=20,000 (a shorter last slice) at
  every cluster width, the keyed sweep against the reading one and the
  draw's plain version against ``rng.uniform01``, the width sweeps (R=8
  and 32, small N), the exact sigmoid's near ties counted,
  launches per chunk (6), the three tiers' colored trajectories bitwise
  equal, the card's small colored solves and a sparse N=32768 one equal
  to the CPU's;
* parallel tempering (``[tempering]``): kernel A with a distinct
  temperature column per replica (a ladder, a random table) against its
  plain version on every tier at 1 block and 8, T = 1, 10, 256; K2000
  ``solve_tempering(TemperingConfig(20000, 0.05, sqrt(2000), 8 rungs, a
  swap every 10 steps, backend="fused"))``, RSA + PWL, bitwise the CPU's
  over a 2,000-step prefix round by round, then in full with its launches
  per round, and under ``run_resilient`` after a crash; sparse N=16384
  ``bitplane_hbm`` RWA tempering with its invariants;
* time to solution (``[tts]``): K2000 at Table III's 33,000 cut, RSA and
  RWA over 4 seeds x R=8 at 2,000, 5,000 and 20,000 steps beside
  tempering at 20,000: P_a, t_a and TTS(0.99);
* the workloads (``[workloads]``): the CLI on the card on a torus, a small
  world and two Gset files, and ``greedy_descent`` on the TTS runs' best
  spins against the CPU's;
* the solver service (``[serve]``): a 15-request burst through
  ``SolverService(device="cuda")`` (8 seed-free K2000 RWA tenants stacked
  into one 64-replica launch, 4 seed-pinned ones on the "vmap" lane, 2 on
  the sparse N=16384 edge list, one colored), with batching and without,
  kernels A, B and C against their plain versions on the operands the
  drain gave them (N=2048 with its zero rows, R=64, 8 and 16; kernel A
  step by step with RWA near ties masked), its lanes held bitwise
  against solo solves, every span's energy exact on
  the unpadded instance, a repeat tenant on the store cache (no encode,
  no J copied to the card), a met target answered with no launch, a
  budgeted request, and the anchor burst on the card bitwise the CPU's;
* the LM serving path: qwen2-7b at full width and depth in bf16 with
  weights made on the card from a seed, ``forward(cfg, params,
  tokens=(4, 4096))`` through the flash-attention kernel's tensor-core
  entry (28 launches, none of the f32 entry), held against the chunked
  path (bf16 layer by layer, and f32), then ``decode_step`` one token at a
  time from ``init_decode_cache``, with both entries against their plain
  version and the bf16 one beside ``scaled_dot_product_attention``;
* the MoE, Mamba and RWKV families (``[lm-families]``): granite-moe-1b-a400m
  and rwkv6-1.6b at full width and depth, a 4 x 4,096 prefill each and
  decode (rwkv6's decode against its forward in f32 compute and in bf16;
  granite's flash path against the chunked one, its MoE losses
  and loads, kernel E at D=64 against its plain version and SDPA), jamba's
  smoke model on the card against the CPU, and one Mamba block at jamba's
  full width (a 1,024-token prefill, decode, the card against the CPU).

Prints the card, the build, every check and each phase's seconds, a
``{"kernels": [...]}`` line with times and bounds, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and exits
nonzero. Without a CUDA device it exits nonzero before printing a result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

import numpy as np  # noqa: E402

from repro_torch.configs.snowball import K2000, default_solver  # noqa: E402
from repro_torch.core import ising, rng  # noqa: E402
from repro_torch.core.bitplane import pack_spins  # noqa: E402
from repro_torch.core.coupling import (CouplingStore,  # noqa: E402
                                       measure_host_build)
from repro_torch.core.schedules import linear  # noqa: E402
from repro_torch.core.solver import SolverConfig, solve  # noqa: E402
from repro_torch.graphs import (complete_bipolar, cut_from_energy,  # noqa: E402
                                greedy_coloring, maxcut_to_ising,
                                sparse_bipolar_edges, torus_grid_edges)
from repro_torch.kernels import (_build, bitplane_field, common,  # noqa: E402
                                 local_field, ops, ref, sweep)
from repro_torch.kernels.parity import roulette_near_tie  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_cache, init_params, model_specs)
from repro_torch.models import model as lm_model  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 rate outside the
#: tensor cores. The bounds below use them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: Dense bf16 tensor-core peak (NVIDIA data sheet): the attention bound.
BF16_FLOP_PER_S = 989e12
#: Floating-point operations of one PWL flip probability: divide, max, min,
#: subtract, multiply, fused multiply-add (2).
PWL_FLOPS = 7
#: Popcounts a clock per SM on compute capability 9.0, a quarter of the
#: integer add rate (the CUDA C++ Programming Guide's arithmetic-throughput
#: table). Kernel C's bound counts them at the card's top SM clock.
POPC_PER_CLOCK_SM = 16
#: Integer operations of one threefry2x32 uniform (counted at the f32 rate):
#: 20 rounds of add, rotate and xor, five key injections of three adds, the
#: two initial adds, the xor of the two words, the conversion and the scale.
THREEFRY_OPS = 80
#: CUDA API calls that put work on the device from the host (a CUDA-graph
#: replay is one), counted in a profile beside device events.
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")

#: Kernel A's ms per 256-step launch in its earlier design (one block per
#: replica, uniforms drawn on the host; PERF.md §6 rows 1, 1b, 1c, on an H100
#: 80GB HBM3 at 700 W), printed beside this run's.
ONE_BLOCK_SWEEP_MS = {("dense", "rsa"): 1.1015, ("dense", "rwa"): 2.3083,
                 ("bitplane", "rsa"): 1.2422, ("bitplane", "rwa"): 2.3177,
                 ("bitplane_hbm", "rsa"): 1.5700,
                 ("bitplane_hbm", "rwa"): 6.9444}
#: The RSA main paths' best cuts (PERF.md §5). RSA + PWL on integer J is
#: bitwise the JAX trajectory, so no design of the kernel may move them.
RSA_MAIN_CUT = {"dense": 31271, "bitplane": 81663, "bitplane_hbm": 17592}
#: Most device launches a single-flip chunk may take (the sweep, the merge).
MAX_CHUNK_LAUNCHES = 8
#: Device launches of a colored chunk: the keyed sweep, the four ops of the
#: best merge and the rows_fetched add (no host RNG, no schedule work).
COLORED_CHUNK_LAUNCHES = 6
#: Kernel D's ms per 256-step launch in its earlier design (one block per
#: replica, uniforms drawn on the host; PERF.md §6 row 2, an H100 80GB HBM3
#: at 700 W), printed beside this run's.
ONE_BLOCK_COLORED_MS = {"bitplane_hbm": 127.4532, "bitplane": 127.1380,
                        "dense": 1377.7280}
#: The colored main path's trajectory (PERF.md §5): PWL on integer J, and
#: the keyed kernel draws the same words, so no design may move them.
COLORED_MAIN = {"cut": 23163, "flips": 1927656, "rows_fetched": 615118}
#: The sparse colored solve past one block's old ceiling (~18.8k spins), and
#: its steps (three 16-step chunks: the CPU's plain version takes ~1 s a
#: step at this N).
COLORED_BIG_N = 32768
COLORED_BIG_STEPS = 48
#: Replicas of the colored width sweep's wide line, and the N of its
#: unequal-slice check (no width splits 20,000 into equal words).
COLORED_WIDE_R = 32
UNEVEN_N = 20000
#: Cluster widths of the width sweep.
SWEEP_WIDTHS = (1, 2, 4, 8)

SEED = 0
R, N, T = 8, K2000.num_vertices, 256
STEPS = 20000

#: The plane tiers' two instances (the JAX package's BITPLANE_N and its
#: sparse-ingest anchor, benchmarks/bench_solver_perf.py).
K_PLANE_N = 4096
SPARSE_N = 16384
SPARSE_EDGES = 8 * SPARSE_N
SPARSE_STEPS = 4 * SPARSE_N        # four sweeps' worth of steps
#: Kernel C's ms per launch in its earlier design (two popcounts per replica
#: and word, 8 replicas' spin words staged in shared memory), by CUDA events
#: from the host at R=8 (PERF.md §6 row 4, an H100 80GB HBM3 at 700 W),
#: printed beside this run's.
STAGED_FIELD_MS = {K_PLANE_N: 0.04483, SPARSE_N: 0.04925}
#: Replica counts kernel C is held at on the main paths' planes; the widest
#: is timed beside the main path's R.
FIELD_RS = (1, 8, 32)
#: Kernel C on random plane words, pos and neg overlapping: (B, rows, W, R).
#: W=7,265 is one word past the earlier design's shared-memory ceiling, not a
#: multiple of 4 (4-byte loads); the widest W is a colored solve's at its
#: ceiling, sweep.colored_max_n(256) / 32 = 9,552.
FIELD_WORD_SHAPES = ((3, K_PLANE_N, 128, 8), (1, 64, 7265, 8),
                     (1, 64, None, 8), (3, 64, None, 32), (2, 64, None, 13))
#: Steps of the cross-tier solves, and of the short full-width kernel checks.
TIER_STEPS = 4096
CHECK_T = 64
#: Steps of the colored cross-tier solves.
COLORED_TIER_STEPS = 256

#: The LM serving path: qwen2-7b at full width and depth in the dry run's
#: serving precision, on the prefill_32k cell cut to one card (batch 32 -> 4,
#: sequence 32,768 -> 4,096: the cell's own logits would be 319 GB), then
#: one-token decode over the first prompt tokens and a few greedy ones.
LM_ARCH = "qwen2-7b"
LM_BATCH, LM_SEQ = 4, 4096
LM_LONG_SEQ = 32768            # prefill_32k's sequence, timed at batch 1
DECODE_PROMPT, DECODE_NEW = 64, 16
#: max |a - b| / max |b| allowed between two bf16 paths of one model, on
#: the two-layer smoke configs (tests/test_arch_smoke.py:96).
BF16_PATH_BOUND = 0.03
#: The same two paths in f32 compute (tests/test_torch_lm_model.py).
F32_PATH_BOUND = 1e-4
#: Flash against chunked logits at full depth (max |Δ| / max |logit|) when
#: bf16 inputs went through the f32 CUDA-core kernel (q·scale and p in f32),
#: measured on an H100 80GB HBM3; the tensor-core kernel's cast points are
#: those of the chunked path.
CUDA_CORE_LOGIT_GAP = 0.051517


def depth_bound(num_layers: int) -> float:
    """The bf16 path bound at full depth. Every layer adds its own
    independent bf16 rounding differences to the residual stream, so the
    gap grows like a random walk: the two-layer bound times sqrt(layers / 2)
    (0.112 at 28 layers). ``lm_slice`` shows the growth layer by layer and
    that the same two paths agree within ``F32_PATH_BOUND`` in f32."""
    return BF16_PATH_BOUND * math.sqrt(num_layers / 2)

#: Kernel against its plain version: f32 sums the same products in another
#: order (JAX's own flash-against-chunked bound, 2e-5); bf16 outputs may
#: round apart by one bf16 ulp, 2^-7 at |out| < 2 (JAX's bf16 bound, 2e-2).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

#: flips/s of the single-flip bitplane_hbm main path at N=16384, by mode,
#: printed beside the colored main path's (one run, one card).
SINGLE_FLIP_RATE: dict = {}
#: Each single-flip main path's host-clock µs/step, flips/s, best cut,
#: launches per chunk and profile, by (tier, mode): the summary lines.
MAIN_PATHS: dict = {}


def check(cond, msg: str, quiet: bool = False) -> None:
    """Raise on a failed check; print a passed one unless ``quiet``."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")
    if not quiet:
        print(f"  ok: {msg}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@functools.cache
def popc_per_s() -> tuple:
    """The card's popcount rate: ``POPC_PER_CLOCK_SM`` on every SM at the
    top SM clock ``nvidia-smi`` reports. Returns (rate, MHz)."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_SM * sms * mhz * 1e6, mhz


#: Builtin types of the Itanium mangling that kernel templates take.
MANGLED_BUILTINS = {"j": "unsigned", "i": "int", "f": "float", "b": "bool"}


def template_args(rest: str) -> list:
    """The template arguments at the head of a mangled name's tail
    (``ILi8E5uint4E...`` -> ``['8', 'uint4']``): integer and bool literals,
    named types and builtin types; [] where there are none or they are of
    another form."""
    if not rest.startswith("I"):
        return []
    i, args = 1, []
    while i < len(rest) and rest[i] != "E":
        lit = re.match(r"L[ib](\d+)E", rest[i:])
        named = re.match(r"(\d+)", rest[i:])
        if lit:
            args.append(lit.group(1))
            i += lit.end()
        elif named:
            start = i + named.end()
            args.append(rest[start:start + int(named.group(1))])
            i = start + int(named.group(1))
        elif rest[i] in MANGLED_BUILTINS:
            args.append(MANGLED_BUILTINS[rest[i]])
            i += 1
        else:
            return []
    return args


def kernel_name(mangled: str) -> str:
    """``flash_tc_kernel<128>`` or ``bitplane_field_kernel<8,uint4>`` from a
    mangled kernel name: the identifier ending in ``kernel`` whose length
    prefix fits, and its template arguments."""
    for m in re.finditer(r"(?=(\d{1,3})([A-Za-z_]\w*))", mangled):
        n = int(m.group(1))
        ident = m.group(2)[:n]
        if len(ident) == n and ident.endswith("kernel"):
            args = template_args(m.group(2)[n:])
            return f"{ident}<{','.join(args)}>" if args else ident
    return mangled


def ptxas_summary(log: str) -> list:
    """One line per kernel from ``nvcc -Xptxas -v``: its name with its
    template arguments, registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name, spill = None, ""
    return out


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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of the device work alone: ``reps`` calls
    captured in one CUDA graph and replayed, timed by CUDA events. For a
    kernel of a few microseconds, back-to-back calls from Python time the
    host's dispatch instead (``cuda_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
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
    """What one keyed sweep must move and compute for these inputs: u0, s0,
    e0, temps and the table in; u, s, best_s, e, best_e, num_flips and
    rows_fetched out; one J row per accepted flip (a rejected step needs no
    row). It draws T·R·4 threefry uniforms; RSA evaluates one flip
    probability a step, RWA all N."""
    nbytes = 4 * (2 * r * n + r + t * r + 3 * (segs + 1)
                  + 3 * r * n + 4 * r) + 4 * flips * n
    evals = t * r * (n if mode == "rwa" else 1)
    flops = (evals * (PWL_FLOPS + (1 if mode == "rwa" else 0))
             + 2 * flips * n + t * r * 4 * THREEFRY_OPS)
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


def profile_main_path(problem, config, store=None,
                      backend: str = "fused") -> None:
    """Device time by kernel and the device's busy share of the host wall
    time, over one solve."""
    profile_device(lambda: solve(problem, SEED, config, backend=backend,
                                 store=store))


def profile_device(run, top: int = 8, tag: str = "[profile]"):
    """Device time by kernel and the device's busy share of the host wall
    time, over one call of ``run``. Only device-side events (kernels,
    copies, fills) count: a host operator's own device time is that of the
    kernels it launched, which are listed themselves. Prints "not measured"
    and returns None if the trace has no device time; else returns
    ``{"wall", "busy", "events"}`` (seconds, seconds, device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    rows = sorted(((device_us(ev), ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e6
    if busy <= 0:
        print(f"{tag} device time not measured (no device events)")
        return None
    print(f"{tag} wall {wall:.4f} s (profiled), device busy "
          f"{busy:.4f} s = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
    for us, count, key in rows[:top]:
        print(f"{tag}   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return {"wall": wall, "busy": busy, "rows": [(us / 1e6, c, k)
                                                 for us, c, k in rows],
            "events": sum(count for _, count, _ in rows),
            "host_calls": sum(ev.count for ev in prof.key_averages()
                              if ev.key in HOST_LAUNCH_CALLS),
            "sweep_s": sum(us for us, _, key in rows
                           if "sweep_kernel" in key) / 1e6}


def launches_per_chunk(problem, config, store=None,
                       backend: str = "fused") -> float:
    """Device launches (kernels, copies, fills) per chunk of a solve: the
    device events of a 6-chunk solve less those of a 2-chunk one, over 4
    (the init's launches cancel)."""
    events = []
    for chunks in (2, 6):
        c = dataclasses.replace(config, num_steps=256 * chunks)
        prof = profile_device(lambda c=c: solve(problem, SEED, c,
                                                backend=backend,
                                                store=store), top=0,
                              tag="[main]   launches:")
        if prof is None:
            raise RuntimeError("the profiler saw no device events")
        events.append(prof["events"])
    return (events[1] - events[0]) / 4


def fixed_cost_ms(problem, config, store=None) -> float:
    """Host-clock ms of a one-step solve, the best of three: what a solve
    costs besides its steps (store, replica init, temperature table, one
    launch and merge)."""
    c = dataclasses.replace(config, num_steps=1)
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(problem, SEED, c, store=store)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def single_flip_main(label: str, problem, config, steps: int, store=None):
    """The profile of one main-path solve (device busy and idle share, and
    kernel A's own µs/step in it), its launches per chunk and the fixed
    cost of a solve, printed on ``[main]``; checks the launch count."""
    prof = profile_device(lambda: solve(problem, SEED, config, store=store),
                          top=3, tag=f"[main] {label} profile:")
    per_chunk = launches_per_chunk(problem, config, store)
    fixed = fixed_cost_ms(problem, config, store)
    kernel_us = (math.nan if prof is None
                 else prof["sweep_s"] / steps * 1e6)
    print(f"[main] {label}: {per_chunk:.2f} device launches per chunk "
          f"({steps} steps = {math.ceil(steps / 256)} chunks); kernel A's "
          f"own {kernel_us:.3f} us/step in the profiled solve; a one-step "
          f"solve {fixed:.3f} ms (host clock)")
    check(per_chunk <= MAX_CHUNK_LAUNCHES,
          f"{label}: at most {MAX_CHUNK_LAUNCHES} launches per chunk")
    return prof, per_chunk, {"kernel_us": kernel_us, "fixed_ms": fixed}


def width_sweep(label: str, couplings, args, tbl, words, fmt: str) -> dict:
    """Kernel A's ms per 256-step launch (CUDA events, the keyed variant)
    at each cluster width that fits, for RSA and RWA, beside the width
    the rule picks."""
    u0, s0, e0, _, temps = args
    n = u0.shape[1]
    lane = common.default_lane(n)
    segs = tbl.shape[0] - 1
    out = {}
    for mode in ("rsa", "rwa"):
        fits = sweep.widths(n, lane, segs, mode == "rwa")
        times = {}
        for c in SWEEP_WIDTHS:
            if c not in fits:
                continue
            times[c] = cuda_ms(lambda c=c, mode=mode: sweep.mcmc_sweep_at_width(
                c, couplings, u0, s0, e0, temps, tbl, base_words=words,
                chunk=0, mode=mode, coupling=fmt), 10)
        pick = sweep.cluster_width(n, lane, segs, mode == "rwa",
                                   fmt != "dense")
        out[mode] = times
        print(f"[timing] width sweep {label} {mode}: "
              + ", ".join(f"c={c} {ms:.4f} ms" for c, ms in times.items())
              + f"; the rule picks c={pick}")
    return out


def dense_slice() -> list:
    """The dense tier on K2000: kernel checks, the card against the CPU,
    the two main-path solves, a profile and the timings. Returns the
    ``kernels`` JSON rows of the dense sweep and the local-field init."""
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
    gen = torch.Generator("cuda").manual_seed(SEED)
    j_real = torch.randn((N, N), generator=gen, device="cuda")
    h_real = torch.randn((N,), generator=gen, device="cuda")
    got = local_field.local_field_init(s0, j_real, h_real)
    gap = (got.double() - (s0.double() @ j_real.double().T
                           + h_real.double())).abs()
    lim = local_field.order_error_bound(s0, j_real, h_real)
    check(bool((gap <= lim).all()), "local_field_init on normal J and h "
          f"within its order bound of the exact product (max gap "
          f"{float(gap.max()):.3e}, at most {float((gap / lim).max()):.4f} "
          "of the bound)")
    del j_real, got
    # Device time by CUDA-graph replay (the kernel, its plain version and
    # torch.addmm alike); the host-dispatch time of back-to-back calls is
    # printed beside it.
    calls = {"ms": lambda: local_field.local_field_init(
                 s0, problem.couplings, problem.fields),
             "plain_ms": lambda: ref.local_field_init(
                 s0, problem.couplings, problem.fields),
             "library_ms": lambda: torch.addmm(
                 problem.fields, s0, problem.couplings.T)}
    for key, call in calls.items():
        lf[key] = graph_ms(call, 50)
        lf["host_" + key] = cuda_ms(call, 50)
    lf["bound"] = bound(4 * (N * N + R * N + N + R * N), 2 * R * N * N)

    print("[kernels] snowball_sweep_uniforms, the keyed sweep's device "
          "draw, against rng.uniform01 of the chunk's stream")
    base = rng.fold_in(rng.key(0), SEED)
    words = rng.words(base)
    for chunk, t in ((0, T), (1, T), (78, 17), (1000, 130)):
        got = sweep.sweep_uniforms(words, chunk, t, R, device="cuda")
        want = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, chunk),
                             (t, R, 4))
        check(torch.equal(got.cpu(), want),
              f"chunk {chunk}, T={t}: the device draw equals rng.uniform01 "
              "bitwise")
    check(torch.equal(unif, sweep.sweep_uniforms(words, 0, T, R, "cuda")),
          "the main-path checks' uniforms are chunk 0's draw")

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

    print("[kernels] the keyed sweep (the main path's, drawing its "
          "uniforms) against the reading one fed the same words")
    for label, entry in sw.items():
        mode = "rsa" if label == "rsa" else "rwa"
        table = tbl if entry.get("pwl", True) else None
        uni = entry.get("uniformized", False)
        a = sweep.mcmc_sweep_keyed(problem.couplings, u0, s0, e0, words, 0,
                                   temps, table, mode=mode, uniformized=uni)
        b = sweep.mcmc_sweep(problem.couplings, u0, s0, e0, unif, temps,
                             table, mode=mode, uniformized=uni)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{label}: keyed kernel bit-equal to the reading kernel, all "
              "seven outputs")

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
    lane = common.default_lane(N)
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
              f"launches sweep={launches['sweep']} init={launches['init']}, "
              f"cluster width {sweep.cluster_width(N, lane, segs, mode == 'rwa')}")
        prof, per_chunk, extra = single_flip_main(
            f"K2000 dense {mode}", problem, cfg[mode], STEPS)
        MAIN_PATHS[("dense", mode)] = {
            "us_step": wall / STEPS * 1e6, "flips_s": flips / wall,
            "cut": float(cuts.max()), "per_chunk": per_chunk, "prof": prof,
            **extra}
        if mode == "rsa":
            check(int(cuts.max()) == RSA_MAIN_CUT["dense"],
                  f"rsa: best cut {RSA_MAIN_CUT['dense']}, as before")
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

    print("[timing] CUDA events at the main path's shapes (the keyed "
          "sweep, as the main path runs it)")
    for label, entry in sw.items():
        mode = "rsa" if label == "rsa" else "rwa"
        table = tbl if entry.get("pwl", True) else None
        uni = entry.get("uniformized", False)
        run = (lambda table=table, mode=mode, uni=uni: sweep.mcmc_sweep_keyed(
            problem.couplings, u0, s0, e0, words, 0, temps, table, mode=mode,
            uniformized=uni))
        entry["ms"] = cuda_ms(run, 20)
        entry["plain_ms"] = cuda_ms(lambda table=table, mode=mode, uni=uni:
                                    ref.mcmc_sweep(problem.couplings, u0, s0,
                                                   e0, unif, temps, table,
                                                   mode=mode,
                                                   uniformized=uni), 2)
        entry["bound"] = bound(*sweep_bytes_flops(
            mode, R, N, T, entry["flips"], segs if table is not None else 0))
        before = ONE_BLOCK_SWEEP_MS.get(("dense", label))
        print(f"[timing] mcmc_sweep {label}: {entry['ms']:.4f} ms "
              f"({entry['ms'] / T * 1e3:.3f} us/step)"
              + (f" [one block, host uniforms: {before:.4f} ms]"
                 if before else "")
              + f", plain {entry['plain_ms']:.2f} ms, bound "
              f"{entry['bound'][0]:.5f} ms")
    width_sweep("K2000 dense", problem.couplings, (u0, s0, e0, unif, temps),
                tbl, words, "dense")
    print(f"[timing] local_field_init (CUDA-graph replay): {lf['ms']:.5f} "
          f"ms, plain {lf['plain_ms']:.5f} ms, torch.addmm "
          f"{lf['library_ms']:.5f} ms ({lf['ms'] / lf['library_ms']:.3f}x "
          f"its time), bound {lf['bound'][0]:.5f} ms ({lf['bound'][1]}; "
          f"{lf['bound'][0] / lf['ms']:.1%} of it); back-to-back calls from "
          f"the host: {lf['host_ms']:.5f} / {lf['host_plain_ms']:.5f} / "
          f"{lf['host_library_ms']:.5f} ms")

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
    return line["kernels"]


def edge_energy(edges, h, spins):
    """H(s) straight from the edge list, in float64: −Σ_e w s_i s_j − h·s
    (an independent reference for the plane path, which has no dense J)."""
    dev = spins.device
    rows = torch.from_numpy(edges.rows.astype(np.int64)).to(dev)
    cols = torch.from_numpy(edges.cols.astype(np.int64)).to(dev)
    w = torch.from_numpy(edges.weights).to(dev, torch.float64)
    s = spins.to(torch.float64)
    return -(w * s[:, rows] * s[:, cols]).sum(1) - s @ h.to(torch.float64)


def plane_fields(planes, spins):
    """u^(J) of ``spins`` by the plain popcount version."""
    return ref.bitplane_field_init(planes.pos, planes.neg,
                                   pack_spins(spins, planes.num_words))


def plane_inputs(planes, h, r: int, t: int, temps_row, seed: int,
                 shared_sites: bool = False):
    """Random ±1 spins, their exact u and e from the planes, JAX-stream
    uniforms (on even steps the first half of the replicas share the site
    uniform when ``shared_sites``, so the coalesced count has work)."""
    key = rng.fold_in(rng.key(0, device="cuda"), seed)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(r, device="cuda")),
                            (planes.num_spins,)).to(torch.float32)
    u_j = plane_fields(planes, s0)
    e0 = ising.energy_from_fields(u_j, s0, h)
    unif = rng.uniform01(rng.stream(key, rng.Salt.SWEEP, 0), (t, r, 4))
    if shared_sites:
        unif[::2, : r // 2, 0] = unif[::2, :1, 0]
    temps = temps_row[:t].to("cuda")[:, None].expand(t, r).contiguous()
    return u_j + h, s0, e0, unif, temps


def plane_invariants(planes, h, out, label: str):
    u, s, e, be, bs, nf, rf = out
    u_j = plane_fields(planes, s)
    check(torch.equal(u, u_j + h), f"{label}: u == J s + h exactly")
    check(torch.equal(e, ising.energy_from_fields(u_j, s, h)),
          f"{label}: e == energy(s) exactly")
    check(torch.equal(be, ising.energy_from_fields(plane_fields(planes, bs),
                                                   bs, h)),
          f"{label}: best_e == energy(best_s) exactly")
    check(bool(((s == 1) | (s == -1)).all()), f"{label}: spins are ±1")


def rsa_rows_fetched(n: int, seed: int, config, block_r: int = 8):
    """The coalesced rows_fetched of an RSA solve, from its site uniforms
    alone (RSA sites do not depend on the state): per step and group of
    ``block_r`` replicas, one row for each replica whose site no lower
    replica of the group chose."""
    base = rng.fold_in(rng.key(0, device="cuda"), seed)
    r = config.num_replicas
    br = common.fit_block(r, block_r)
    lower = torch.tril(torch.ones(br, br, dtype=torch.bool, device="cuda"),
                       -1)
    total = torch.zeros(r, dtype=torch.int64, device="cuda")
    for c, clen in ops.chunk_list(config, 256)[1]:
        unif = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, c), (clen, r, 4))
        j = common.site_from_uniform(unif[..., 0], n).reshape(clen, -1, br)
        dup = ((j[..., :, None] == j[..., None, :]) & lower).any(-1)
        total += (~dup).sum(0).reshape(r)
    return total


def plane_sweep_bytes_flops(mode: str, r: int, n: int, t: int, flips: int,
                            segs: int, num_planes: int):
    """What one keyed plane sweep must move and compute for these inputs:
    as :func:`sweep_bytes_flops`, with a packed row (2·B·⌈N/32⌉ words) per
    accepted flip, decoded at 6 integer operations per plane and spin."""
    words = -(-n // 32)
    nbytes = 4 * (2 * r * n + r + t * r + 3 * (segs + 1)
                  + 3 * r * n + 4 * r) + 4 * flips * 2 * num_planes * words
    evals = t * r * (n if mode == "rwa" else 1)
    flops = (evals * (PWL_FLOPS + (1 if mode == "rwa" else 0))
             + flips * n * (2 + 6 * num_planes) + t * r * 4 * THREEFRY_OPS)
    return nbytes, flops


def field_bytes_ops(pos, r: int):
    """Kernel C's work: the plane bytes read once, the spin words in and u
    out; and its popcounts, the issue-limited operation: one per replica
    and word (of the select (p & x) | (q & ~x)) and two per word (popc(p)
    and popc(q)), (R+2)·B·N·W, counted at ``popc_per_s``."""
    b, n, w = pos.shape
    nbytes = 4 * (2 * b * n * w + r * w + r * n)
    return nbytes, (r + 2) * b * n * w


def reset_counts() -> None:
    for c in (sweep.counter, local_field.counter, bitplane_field.counter):
        c.reset()


def read_counts() -> dict:
    return {"sweep": sweep.counter.count, "init": bitplane_field.counter.count,
            "dense_init": local_field.counter.count}


def field_word_checks() -> list:
    """Kernel C against its plain version on random plane words (pos and
    neg overlapping) at ``FIELD_WORD_SHAPES``. Returns each max_abs_err."""
    wide = sweep.colored_max_n(256) // 32
    g = np.random.default_rng(SEED)
    errs = []
    for b, n, w, r in FIELD_WORD_SHAPES:
        w = w or wide
        pos, neg = (torch.from_numpy(
            g.integers(0, 2 ** 32, (b, n, w), dtype=np.uint32).view(
                np.int32)).to("cuda") for _ in range(2))
        words = torch.from_numpy(g.integers(0, 2 ** 32, (r, w),
                                            dtype=np.uint32).view(
                                                np.int32)).to("cuda")
        got = bitplane_field.bitplane_field_init(pos, neg, words)
        want = ref.bitplane_field_init(pos, neg, words)
        check(torch.equal(got, want), f"bitplane_field_init on random "
              f"overlapping words B={b} rows={n} W={w} R={r} bit-equal to "
              "plain")
        errs.append(max_abs_err([got], [want]))
    return errs


def plane_kernel_checks(k_store, sp_store, k_h, sp_h, cfg, tbl):
    """The popcount init and the plane sweep against their plain versions at
    the main paths' widths (K4096 and sparse N=16384). Returns the
    ``max_abs_err`` of each check and the popcount init's inputs; the
    checks' large tensors are freed on return."""
    names = ("u", "s", "e", "best_e", "best_s", "num_flips", "rows_fetched")
    err = {}

    print(f"[kernels] bitplane_field_init against its plain version "
          f"(B=1; K{K_PLANE_N} and N={SPARSE_N} at R = {FIELD_RS})")
    field_in = {}
    errs = []
    for key, store, h in (("k", k_store, k_h), ("sp", sp_store, sp_h)):
        pl = store.planes
        for r in FIELD_RS:
            s0 = plane_inputs(pl, h, r, 1, torch.ones(1), SEED)[1]
            words = pack_spins(s0, pl.num_words)
            got = bitplane_field.bitplane_field_init(pl.pos, pl.neg, words)
            want = ref.bitplane_field_init(pl.pos, pl.neg, words)
            check(torch.equal(got, want), f"bitplane_field_init "
                  f"N={pl.num_spins} W={pl.num_words} R={r} bit-equal to "
                  "plain")
            errs.append(max_abs_err([got], [want]))
            field_in[(key, r)] = (pl, s0, words)
    errs += field_word_checks()
    err["field"] = max(errs)
    check(err["field"] == 0.0, "bitplane_field_init max_abs_err == 0.0")

    print(f"[kernels] plane mcmc_sweep RSA + PWL against its plain version "
          f"(R={R}, T={CHECK_T}; shared site uniforms on even steps)")
    checks = (("k", "bitplane", True, k_store, k_h),
              ("sp", "bitplane", True, sp_store, sp_h),
              ("sp", "bitplane_hbm", True, sp_store, sp_h),
              ("sp", "bitplane_hbm", False, sp_store, sp_h))
    for key, fmt, coalesce, store, h in checks:
        pl = store.planes
        n = pl.num_spins
        temps0 = cfg[(n, "rsa")].schedule(
            torch.arange(CHECK_T, dtype=torch.int32))
        args = plane_inputs(pl, h, R, CHECK_T, temps0, SEED,
                            shared_sites=True)
        kw = dict(mode="rsa", coupling=fmt, coalesce=coalesce)
        got = sweep.mcmc_sweep(pl, *args, tbl, **kw)
        want = ref.mcmc_sweep(pl, *args, tbl, **kw)
        label = f"N={n} {fmt}{'' if coalesce else ' uncoalesced'} rsa+pwl"
        for name, a, b in zip(names, got, want):
            check(torch.equal(a, b), f"{label} {name} bit-equal to plain")
        plane_invariants(pl, h, got, f"{label} kernel")
        total = int(got[6].sum())
        if fmt == "bitplane_hbm" and coalesce:
            check(total < R * CHECK_T, f"{label}: coalesced rows_fetched "
                  f"{total} < R*T = {R * CHECK_T}, equal to plain")
        else:
            check(total == R * CHECK_T, f"{label}: rows_fetched == R*T")
        err[("rsa", fmt, key)] = max_abs_err(got, want)

    print("[kernels] the keyed plane sweep (the main path's) against the "
          f"reading one fed the same words (R={R}, T={CHECK_T})")
    words = rng.words(rng.fold_in(rng.key(0), SEED))
    for key, fmt, store, h in (("k", "bitplane", k_store, k_h),
                               ("sp", "bitplane_hbm", sp_store, sp_h)):
        pl = store.planes
        n = pl.num_spins
        temps0 = cfg[(n, "rsa")].schedule(
            torch.arange(CHECK_T, dtype=torch.int32))
        u0, s0, e0, unif, temps = plane_inputs(pl, h, R, CHECK_T, temps0,
                                               SEED)
        for mode in ("rsa", "rwa"):
            a = sweep.mcmc_sweep_keyed(pl, u0, s0, e0, words, 0, temps, tbl,
                                       mode=mode, coupling=fmt)
            b = sweep.mcmc_sweep(pl, u0, s0, e0, unif, temps, tbl, mode=mode,
                                 coupling=fmt)
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"N={n} {fmt} {mode}: keyed kernel bit-equal to the "
                  "reading kernel, all seven outputs")

    print("[kernels] plane mcmc_sweep RWA + PWL: invariants over T, then "
          "per-step picks from 512 states")
    for key, fmt, store, h in (("k", "bitplane", k_store, k_h),
                               ("sp", "bitplane_hbm", sp_store, sp_h)):
        pl = store.planes
        n = pl.num_spins
        c = cfg[(n, "rwa")]
        temps0 = c.schedule(torch.arange(CHECK_T, dtype=torch.int32))
        args = plane_inputs(pl, h, R, CHECK_T, temps0, SEED)
        got = sweep.mcmc_sweep(pl, *args, tbl, mode="rwa", coupling=fmt)
        plane_invariants(pl, h, got, f"N={n} {fmt} rwa+pwl kernel")
        check(torch.equal(got[5], torch.full_like(got[5], CHECK_T)),
              f"N={n} {fmt} rwa: rejection-free, one flip a step")
        ru = 512
        all_temps = c.schedule(torch.linspace(0, c.num_steps - 1,
                                              ru).to(torch.int32))
        pu0, ps0, pe0, punif, _ = plane_inputs(pl, h, ru, 1, temps0, SEED + 1)
        ptemps = all_temps.to("cuda")[None, :].contiguous()
        a = sweep.mcmc_sweep(pl, pu0, ps0, pe0, punif, ptemps, tbl,
                             mode="rwa", coupling=fmt)
        b = ref.mcmc_sweep(pl, pu0, ps0, pe0, punif, ptemps, tbl,
                           mode="rwa", coupling=fmt)
        p_all = common.flip_probability(2.0 * ps0 * pu0, ptemps[0][:, None],
                                        tbl)
        keep = ~roulette_near_tie(p_all, punif[0, :, 2], punif[0, :, 3],
                                  False)
        for name, x, y in zip(names, a, b):
            check(torch.equal(x[keep], y[keep]),
                  f"N={n} {fmt} rwa {name} equal on {int(keep.sum())} of "
                  f"{ru} states ({ru - int(keep.sum())} near ties)")
        err[("rwa", fmt, key)] = max_abs_err([x[keep] for x in a[:5]],
                                             [y[keep] for y in b[:5]])
    return err, field_in


def plane_slice() -> list:
    """The plane tiers: kernel checks at full width, the cross-tier check,
    the card against the CPU, the K4096 and sparse N=16384 main-path
    solves, a profile and the timings. Returns their ``kernels`` rows."""
    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        print(f"[phase] {name} {now - phase_t:.1f} s")
        phase_t = now

    print(f"[setup] K{K_PLANE_N} and the sparse N={SPARSE_N} instance")
    k_inst = complete_bipolar(K_PLANE_N, seed=K_PLANE_N)
    k_prob = maxcut_to_ising(k_inst, device="cuda")
    k_store, k_build = measure_host_build(
        lambda: CouplingStore.build(k_prob.couplings, "bitplane"))
    k_store = k_store.to("cuda")
    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    sp_prob = ising.IsingProblem.create_sparse(edges, device="cuda")
    sp_store, sp_build = measure_host_build(
        lambda: CouplingStore.build(edges, "bitplane_hbm"))
    sp_store = sp_store.to("cuda")
    sp_h = sp_prob.fields
    k_h = k_prob.fields
    for name, store, stats in ((f"K{K_PLANE_N} bitplane", k_store, k_build),
                               (f"N={SPARSE_N} bitplane_hbm", sp_store,
                                sp_build)):
        n = store.num_spins
        print(f"[setup] {name}: B={store.planes.num_planes} "
              f"W={store.planes.num_words}, plane bytes {store.nbytes} "
              f"against dense f32 J {4 * n * n} "
              f"({4 * n * n / store.nbytes:.1f}x), host encode "
              f"{stats['seconds']:.4f} s, host build peak "
              f"{stats['peak_bytes']} bytes")
    check(sp_build["peak_bytes"] < 4 * SPARSE_N ** 2,
          f"sparse N={SPARSE_N} host build peak below the "
          f"{4 * SPARSE_N ** 2} bytes of a dense f32 J")
    check(edges.nnz <= SPARSE_EDGES, f"sparse instance nnz {edges.nnz}")
    phase_done("setup")

    cfg = {(n, m): default_solver(n, steps, mode=m)
           for n, steps in ((K_PLANE_N, STEPS), (SPARSE_N, SPARSE_STEPS))
           for m in ("rsa", "rwa")}
    tbl = ops.solver_pwl_table(cfg[(K_PLANE_N, "rsa")], device="cuda")
    segs = tbl.shape[0] - 1
    err, field_in = plane_kernel_checks(k_store, sp_store, k_h, sp_h, cfg,
                                        tbl)
    phase_done("kernels")

    mains = {}
    for n, fmt, prob, store, steps in (
            (K_PLANE_N, "bitplane", k_prob, k_store, STEPS),
            (SPARSE_N, "bitplane_hbm", sp_prob, sp_store, SPARSE_STEPS)):
        print(f"[main] solve(N={n}, seed={SEED}, default_solver({n}, {steps}, "
              f"mode) with coupling_format='{fmt}', backend='fused'), R={R}")
        warm = dataclasses.replace(default_solver(n, 512, mode="rwa"),
                                   coupling_format=fmt)
        solve(prob, SEED, warm, backend="fused", store=store)
        for mode in ("rsa", "rwa"):
            c = dataclasses.replace(cfg[(n, mode)], coupling_format=fmt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            res = solve(prob, SEED, c, backend="fused", store=store)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated()
            h = prob.fields
            if n == K_PLANE_N:
                cuts = cut_from_energy(k_inst, res.best_energy.cpu().numpy())
                exact = ising.energy(prob, res.best_spins).to(torch.float64)
            else:
                # The cut of the graph whose weights are −J.
                cuts = (-float(edges.weights.sum())
                        - res.best_energy.cpu().numpy()) / 2.0
                exact = edge_energy(edges, h, res.best_spins)
            flips = int(res.num_flips.sum())
            print(f"[main] N={n} {fmt} {mode}: best cut {cuts.max():.0f} "
                  f"(per replica {sorted(cuts.tolist(), reverse=True)}), "
                  f"best energy {float(res.best_energy.min()):.0f}, "
                  f"{wall / steps * 1e6:.3f} us/step, "
                  f"{flips / wall:.4e} flips/s, wall {wall:.4f} s, peak "
                  f"device memory {peak / 2**20:.1f} MiB, of which "
                  f"{held / 2**20:.1f} MiB was held before the solve, "
                  f"launches "
                  f"sweep={launches['sweep']} "
                  f"bitplane_field_init={launches['init']} "
                  f"local_field_init={launches['dense_init']}, "
                  f"rows_fetched {int(res.rows_fetched.sum())}, cluster "
                  f"width {sweep.cluster_width(n, common.default_lane(n), segs, mode == 'rwa', True)}")
            prof, per_chunk, extra = single_flip_main(
                f"N={n} {fmt} {mode}", prob, c, steps, store)
            MAIN_PATHS[(fmt, mode)] = {
                "us_step": wall / steps * 1e6, "flips_s": flips / wall,
                "cut": float(cuts.max()), "per_chunk": per_chunk,
                "prof": prof, **extra}
            if mode == "rsa":
                check(int(cuts.max()) == RSA_MAIN_CUT[fmt],
                      f"N={n} rsa: best cut {RSA_MAIN_CUT[fmt]}, as before")
            check(launches["sweep"] == math.ceil(steps / 256),
                  f"N={n} {mode}: sweep launched ceil({steps}/256) = "
                  f"{math.ceil(steps / 256)} times")
            check(launches["init"] == 1 and launches["dense_init"] == 0,
                  f"N={n} {mode}: bitplane_field_init launched once, "
                  "local_field_init never")
            check(tuple(res.best_spins.shape) == (R, n)
                  and bool(torch.isfinite(res.best_energy).all()),
                  f"N={n} {mode}: results have shape (R, N) and are finite")
            check(torch.equal(res.best_energy.to(torch.float64), exact),
                  f"N={n} {mode}: best_energy == energy(best_spins) exactly")
            if mode == "rwa":
                check(flips == R * steps,
                      f"N={n} rwa: rejection-free, one flip a step")
            check(int(res.rows_fetched.sum()) <= R * steps,
                  f"N={n} {mode}: sum(rows_fetched) <= R*steps")
            mains[(fmt, mode)] = launches
            if fmt == "bitplane_hbm":
                SINGLE_FLIP_RATE[mode] = flips / wall
    phase_done("main")

    print(f"[tiers] dense, bitplane and bitplane_hbm: one RSA + PWL solve of "
          f"{TIER_STEPS} steps each, K{K_PLANE_N} and N={SPARSE_N}")
    dense_sp = torch.from_numpy(edges.to_dense()).to("cuda")
    sp_dense_prob = ising.IsingProblem(dense_sp, sp_h)
    tier_probs = {K_PLANE_N: {"dense": k_prob, "planes": k_prob},
                  SPARSE_N: {"dense": sp_dense_prob, "planes": sp_prob}}
    tier_stores = {}
    for n, probs in tier_probs.items():
        src = k_prob.couplings if n == K_PLANE_N else edges
        tier_stores[n] = {
            "dense": CouplingStore.build(probs["dense"].couplings, "dense"),
            "bitplane": CouplingStore.build(src, "bitplane").to("cuda"),
            "bitplane_hbm": (sp_store if n == SPARSE_N else CouplingStore.build(
                src, "bitplane_hbm").to("cuda"))}
        c = default_solver(n, TIER_STEPS, mode="rsa")
        runs = {}
        for fmt, store in tier_stores[n].items():
            prob = probs["dense" if fmt == "dense" else "planes"]
            runs[fmt] = solve(prob, SEED, dataclasses.replace(
                c, coupling_format=fmt), store=store)
        for fmt in ("bitplane", "bitplane_hbm"):
            for name in ("best_energy", "best_spins", "final_energy",
                         "num_flips", "trace_energy"):
                check(torch.equal(getattr(runs["dense"], name),
                                  getattr(runs[fmt], name)),
                      f"N={n} {fmt} {name} bitwise equal to dense")
        sums = {fmt: int(r_.rows_fetched.sum()) for fmt, r_ in runs.items()}
        want_rows = rsa_rows_fetched(n, SEED, c)
        print(f"[tiers] N={n} rows_fetched sums: {sums} (R*T = "
              f"{R * TIER_STEPS}; from the site uniforms: "
              f"{int(want_rows.sum())})")
        check(sums["dense"] == sums["bitplane"] == R * TIER_STEPS,
              f"N={n} dense and bitplane rows_fetched == R*T")
        check(torch.equal(runs["bitplane_hbm"].rows_fetched.long(), want_rows)
              and sums["bitplane_hbm"] <= R * TIER_STEPS,
              f"N={n} bitplane_hbm rows_fetched == the coalesced count of "
              "its sites, <= R*T")
    phase_done("tiers")

    print("[reference] at full width: a 1024-step RSA + PWL solve of "
          f"K{K_PLANE_N} on bitplane and of N={SPARSE_N} on bitplane_hbm, "
          "the card's against the CPU's")
    for n, fmt, prob in ((K_PLANE_N, "bitplane", k_prob),
                         (SPARSE_N, "bitplane_hbm", sp_prob)):
        c = dataclasses.replace(default_solver(n, 1024, mode="rsa"),
                                coupling_format=fmt)
        on_card = solve(prob, SEED, c, store=tier_stores[n][fmt])
        on_cpu = solve(prob, SEED, c, device="cpu")
        for name, a, b in zip(on_card._fields, on_card, on_cpu):
            check(torch.equal(a.cpu(), b), f"N={n} {fmt} 1024-step solve "
                  f"{name}: card == CPU")

    print("[reference] small input: the card's plane solves against the "
          "CPU's (sparse N=256, RSA + PWL, linear schedule)")
    small_edges = sparse_bipolar_edges(256, 2048, seed=3)
    small = ising.IsingProblem.create_sparse(small_edges)
    for fmt in ("bitplane", "bitplane_hbm"):
        c = SolverConfig(num_steps=1024, schedule=linear(16.0, 0.05, 1024),
                         mode="rsa", trace_every=256, coupling_format=fmt)
        on_card = solve(small, 7, c, backend="fused", device="cuda")
        on_cpu = solve(small, 7, c, backend="fused", device="cpu")
        for name, a, b in zip(on_card._fields, on_card, on_cpu):
            check(torch.equal(a.cpu(), b), f"N=256 {fmt} solve {name}: "
                  "card == CPU")
    phase_done("reference")

    print("[timing] CUDA events at the main paths' shapes (T=256; the keyed "
          "sweep, as the main path runs it)")
    timing = {}
    base_words = rng.words(rng.fold_in(rng.key(0), SEED))
    for key, fmt, store, h in (("k", "bitplane", k_store, k_h),
                               ("sp", "bitplane_hbm", sp_store, sp_h)):
        pl = store.planes
        n = pl.num_spins
        temps0 = cfg[(n, "rsa")].schedule(torch.arange(T, dtype=torch.int32))
        args = plane_inputs(pl, h, R, T, temps0, SEED)
        u0, s0, e0, _, temps = args
        for mode in ("rsa", "rwa"):
            run = (lambda mode=mode, pl=pl, fmt=fmt, u0=u0, s0=s0, e0=e0,
                   temps=temps: sweep.mcmc_sweep_keyed(
                       pl, u0, s0, e0, base_words, 0, temps, tbl, mode=mode,
                       coupling=fmt))
            out = run()
            e = {"ms": cuda_ms(run, 10),
                 "plain_ms": cuda_ms(lambda mode=mode, pl=pl, fmt=fmt,
                                     args=args: ref.mcmc_sweep(
                                         pl, *args, tbl, mode=mode,
                                         coupling=fmt), 1),
                 "bound": bound(*plane_sweep_bytes_flops(
                     mode, R, n, T, int(out[5].sum()), segs, pl.num_planes))}
            timing[(fmt, mode)] = e
            print(f"[timing] mcmc_sweep {fmt} {mode} N={n}: {e['ms']:.4f} ms "
                  f"({e['ms'] / T * 1e3:.3f} us/step) [one block, host "
                  f"uniforms: {ONE_BLOCK_SWEEP_MS[(fmt, mode)]:.4f} ms], plain "
                  f"{e['plain_ms']:.2f} ms, bound {e['bound'][0]:.5f} ms "
                  f"({e['bound'][1]})")
        if fmt == "bitplane_hbm":
            for mode in ("rsa", "rwa"):
                ms = cuda_ms(lambda mode=mode: sweep.mcmc_sweep_keyed(
                    pl, u0, s0, e0, base_words, 0, temps, tbl, mode=mode,
                    coupling=fmt, coalesce=False), 10)
                print(f"[timing] mcmc_sweep {fmt} {mode} N={n} uncoalesced: "
                      f"{ms:.4f} ms ({ms / T * 1e3:.3f} us/step)")
        width_sweep(f"N={n} {fmt}", pl, args, tbl, base_words, fmt)
    rate, mhz = popc_per_s()
    print(f"[timing] bitplane_field_init by CUDA-graph replay (from the "
          f"host: back-to-back calls by CUDA events); bound: bytes at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s, popcounts at {POPC_PER_CLOCK_SM} a "
          f"clock per SM x {torch.cuda.get_device_properties(0).multi_processor_count}"
          f" SMs x {mhz:.0f} MHz (clocks.max.sm)")
    dense_sp_j = sp_dense_prob.couplings
    for key, r, dense_j in (("k", R, k_prob.couplings), ("sp", R, dense_sp_j),
                            ("sp", FIELD_RS[-1], dense_sp_j)):
        pl, s0, words = field_in[(key, r)]
        n = pl.num_spins
        h = torch.zeros(n, device="cuda")
        run = (lambda pl=pl, words=words: bitplane_field.bitplane_field_init(
            pl.pos, pl.neg, words))
        lib = lambda h=h, s0=s0, dense_j=dense_j: torch.addmm(h, s0,
                                                              dense_j.T)
        nbytes, pops = field_bytes_ops(pl.pos, r)
        e = {"ms": graph_ms(run, 50), "host_ms": cuda_ms(run, 50),
             "plain_ms": cuda_ms(lambda pl=pl, words=words:
                                 ref.bitplane_field_init(pl.pos, pl.neg,
                                                         words), 2),
             "library_ms": graph_ms(lib, 20), "library_host_ms":
                 cuda_ms(lib, 20), "bound": bound(nbytes, pops, rate)}
        timing[("field", key, r)] = e
        before = (f" [spin words staged in shared memory, events from the "
                  f"host: {STAGED_FIELD_MS[n]:.5f} ms]" if r == R else "")
        print(f"[timing] bitplane_field_init N={n} W={pl.num_words} R={r}: "
              f"{e['ms']:.5f} ms by graph replay ({e['host_ms']:.5f} from the "
              f"host){before}, plain {e['plain_ms']:.3f} ms, torch.addmm on "
              f"the dense f32 J {e['library_ms']:.5f} ms by graph replay "
              f"({e['library_host_ms']:.5f} from the host), bound "
              f"{e['bound'][0]:.5f} ms ({e['bound'][1]}: bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, {pops} popcounts "
              f"{pops / rate * 1e3:.5f} ms), {e['bound'][0] / e['ms']:.1%} "
              "of it")

    print("[timing] per tier: sweep ms per 256-step launch (CUDA events) and "
          f"us/step of a {TIER_STEPS}-step solve (host clock)")
    for n in (K_PLANE_N, SPARSE_N):
        probs = tier_probs[n]
        h = probs["planes"].fields
        for fmt, store in tier_stores[n].items():
            for mode in ("rsa", "rwa"):
                c = dataclasses.replace(default_solver(n, TIER_STEPS,
                                                       mode=mode),
                                        coupling_format=fmt)
                prob = probs["dense" if fmt == "dense" else "planes"]
                op = store.kernel_operand
                temps0 = c.schedule(torch.arange(T, dtype=torch.int32))
                pl = store.planes if store.planes is not None else \
                    tier_stores[n]["bitplane"].planes
                u0, s0, e0, _, temps = plane_inputs(pl, h, R, T, temps0, SEED)
                ms = cuda_ms(lambda op=op, fmt=fmt, mode=mode, u0=u0, s0=s0,
                             e0=e0, temps=temps: sweep.mcmc_sweep_keyed(
                                 op, u0, s0, e0, base_words, 0, temps, tbl,
                                 mode=mode, coupling=fmt), 10)
                solve(prob, SEED, c, store=store)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve(prob, SEED, c, store=store)
                torch.cuda.synchronize()
                us = (time.perf_counter() - t0) / TIER_STEPS * 1e6
                print(f"[tier] N={n} {fmt:12s} {mode}: sweep {ms:.4f} ms per "
                      f"launch ({ms / T * 1e3:.3f} us/step), solve "
                      f"{us:.3f} us/step")
    phase_done("timing")

    src = "src/repro_torch/kernels/csrc/"
    rows = []
    for fmt, key in (("bitplane", "k"), ("bitplane_hbm", "sp")):
        for mode in ("rsa", "rwa"):
            e = timing[(fmt, mode)]
            rows.append({
                "name": f"mcmc_sweep[{fmt},{mode}]", "route": "cuda",
                "source": src + "sweep.cu",
                "replaces": "src/repro/kernels/sweep.py:555",
                "launches": mains[(fmt, mode)]["sweep"],
                "max_abs_err": err[(mode, fmt, key)], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
                "bound_by": e["bound"][1], "library_ms": None})
    e = timing[("field", "sp", R)]
    rows.append({
        "name": "bitplane_field_init", "route": "cuda",
        "source": src + "bitplane_field.cu",
        "replaces": "src/repro/kernels/bitplane_field.py:42",
        "launches": sum(m["init"] for m in mains.values()),
        "max_abs_err": err["field"], "ms": e["ms"],
        "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
        "bound_by": e["bound"][1], "library_ms": e["library_ms"]})
    return rows


def colored_reset_counts() -> None:
    for c in (sweep.counter, sweep.colored_counter, local_field.counter,
              bitplane_field.counter):
        c.reset()


def colored_inputs(plan, r: int, t: int, temps, seed: int):
    """A replica init of the plan's color-sorted problem (the solve's own
    init), JAX-stream uniforms over the class window, ``temps`` ((t,) or
    (t, r)) and the class schedule of steps 0..t-1."""
    base = rng.fold_in(rng.key(0, device="cuda"), seed)
    u0, s0, e0, *_ = ops.fused_init_state(plan.problem, base, r,
                                          planes=plan.store.planes)
    unif = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, 0),
                         (t, r, plan.window))
    temps = temps.to("cuda", torch.float32)
    if temps.dim() == 1:
        temps = temps[:, None].expand(t, r)
    sched = ops.colored_class_schedule(plan.wstarts, plan.offsets, plan.sizes,
                                       torch.arange(t, device="cuda"))
    return u0, s0, e0, unif, temps.contiguous(), sched


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 value held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def row_nonzeros(store) -> torch.Tensor:
    """Nonzero couplings of each row of J: the popcount of the planes'
    pos | neg words over every plane, or J's nonzeros on the dense tier."""
    if store.planes is None:
        return (store.kernel_operand != 0).sum(dim=1)
    words = store.planes.pos | store.planes.neg         # (B, N, W)
    union = words[0]
    for b in range(1, words.shape[0]):
        union = union | words[b]
    return popcount32(union.to(torch.int64) & 0xFFFFFFFF).sum(dim=1)


def colored_replay(op, args, tbl, fmt: str, nnz: torch.Tensor,
                   block_r: int = 8) -> dict:
    """The accepted (replica, slot) pairs of a colored launch, step by step:
    the reading kernel run one step a launch on the same uniforms (its
    trajectory is the launch's), the accepted spins being those that
    flipped. Returns the accepted pairs, the rows one fetch per rows group
    and step needs (the union of the group's accepts: Σ rows_fetched), and
    the nonzero couplings of both."""
    u, s, e, unif, temps, sched = args
    r, n = u.shape
    br = common.fit_block(r, block_r)
    got = {"flips": 0, "rows": 0, "flip_nnz": 0, "row_nnz": 0}
    for t in range(unif.shape[0]):
        u1, s1, e1, *_ = sweep.colored_sweep(
            op, u, s, e, unif[t:t + 1], temps[t:t + 1], sched[t:t + 1], tbl,
            coupling=fmt)
        acc = s1 != s
        rows = acc.view(r // br, br, n).any(dim=1)
        got["flips"] += int(acc.sum())
        got["rows"] += int(rows.sum())
        got["flip_nnz"] += int((acc * nnz).sum())
        got["row_nnz"] += int((rows * nnz).sum())
        u, s, e = u1, s1, e1
    return got


def colored_bytes_ops(plan, r: int, t: int, segs: int, out, sched,
                      replay: dict, keyed: bool = True):
    """What one colored sweep must move and compute for these inputs, the
    least work for its outputs: u0, s0, e0, temps, the schedule and the
    table in (the uniforms too when it reads them); u, s, best_s, e,
    best_e, num_flips and rows_fetched out; one coupling row for every slot
    some replica of a rows group accepted (Σ rows_fetched; 4·N bytes
    dense, 2·B·W words of planes). Operations, from ``replay`` (this
    run's accepted slots): per fetched plane row a scan of its B·W words
    and a decode of its nonzero couplings (6·B integer operations each);
    per accepted (replica, slot) a multiply and subtract at each nonzero
    coupling of its row; per class slot and replica a flip probability
    and, keyed, a threefry draw. Returns (bytes, ops), then the same for
    two earlier counts: a dense decode (6·B operations at every spin of
    a fetched row, an N-wide multiply and subtract per accepted pair), and
    the one that charged a decode to every accepted pair and a flip
    probability to every window slot."""
    n, win = plan.problem.num_spins, plan.window
    flips, rows = int(out[5].sum()), int(out[6].sum())
    check(replay["flips"] == flips and replay["rows"] == rows,
          f"the step-by-step replay accepts the launch's {flips} flips and "
          f"fetches its {rows} rows")
    if plan.store.planes is not None:
        b, w = plan.store.planes.num_planes, plan.store.planes.num_words
        row_bytes = 4 * 2 * b * w
    else:
        b, w, row_bytes = 0, 0, 4 * n
    wst = sched[:, 0].clamp(0, n - win)
    lo = torch.maximum(wst, sched[:, 1])
    hi = torch.minimum(wst + win, sched[:, 1] + sched[:, 2])
    slots = int((hi - lo).clamp(min=0).sum()) * r
    state = 4 * (2 * r * n + r + t * r + 3 * t + 3 * (segs + 1)
                 + 3 * r * n + 4 * r)
    nbytes = state + (0 if keyed else 4 * t * r * win) + rows * row_bytes
    per_slot = slots * (PWL_FLOPS + (THREEFRY_OPS if keyed else 0))
    ops_ = (rows * b * w + replay["row_nnz"] * 6 * b
            + replay["flip_nnz"] * 2 + per_slot)
    dense_ops = rows * n * 6 * b + flips * 2 * n + per_slot
    old_bytes = state + 4 * t * r * win + rows * row_bytes
    old_ops = t * r * win * PWL_FLOPS + flips * n * (2 + 6 * b)
    return nbytes, ops_, nbytes, dense_ops, old_bytes, old_ops


def colored_sweep_widths(plan, op, args, tbl, fmt, want, label, err):
    """Kernel D at every cluster width against the plain version's outputs
    ``want`` on the same (read) inputs, bitwise."""
    u0, s0, e0, unif, temps, sched = args
    r, n = u0.shape
    names = ("u", "s", "e", "best_e", "best_s", "num_flips", "rows_fetched")
    segs = 0 if tbl is None else tbl.shape[0] - 1
    widths = sweep.colored_widths(n, plan.window, segs, fmt == "dense")
    bad = []
    for c in widths:
        got = sweep.colored_sweep_at_width(c, op, u0, s0, e0, temps, sched,
                                           tbl, uniforms=unif, coupling=fmt)
        bad += [(c, nm) for nm, a, b in zip(names, got, want)
                if not torch.equal(a, b)]
        err[(label, fmt, c)] = max_abs_err(got, want)
    check(not bad, f"{label} {fmt} colored kernel bit-equal to plain at all "
          f"{len(widths)} cluster widths {widths}"
          + (f"; differ: {bad[:6]}" if bad else ""))
    return widths


def colored_width_sweep(op, args, tbl, fmt: str, words, label: str) -> None:
    """Kernel D's ms per launch (keyed, CUDA events) at every cluster width
    for these inputs, beside the rule's pick; every width's outputs equal
    the rule's, bitwise."""
    u0, s0, e0, _, temps, sched = args
    r, n = u0.shape
    win = args[3].shape[2]
    segs = tbl.shape[0] - 1
    dense = fmt == "dense"
    rule = sweep.colored_width(n, win, segs, r, dense)
    want = sweep.colored_sweep_at_width(rule, op, u0, s0, e0, temps, sched,
                                        tbl, base_words=words, window=win,
                                        coupling=fmt)
    swept = []
    for c in sweep.colored_widths(n, win, segs, dense):
        run = (lambda c=c: sweep.colored_sweep_at_width(
            c, op, u0, s0, e0, temps, sched, tbl, base_words=words,
            window=win, coupling=fmt))
        same = all(torch.equal(a, b) for a, b in zip(run(), want))
        check(same, f"{label}: width {c} equals the rule's width {rule}")
        swept.append(f"C={c} {cuda_ms(run, 3):.4f}")
    print(f"[timing] width sweep {label} (keyed; ms per {temps.shape[0]}-"
          f"step launch): {', '.join(swept)}; the rule picks C={rule}")


def colored_slice() -> list:
    """The colored path on the sparse N=16384 anchor: the coloring and the
    plans, the kernel against its plain version on every tier and at every
    cluster width (and on a χ=2 torus and at an N that splits into unequal
    slices), the keyed kernel against the reading one and the draw's plain
    version against ``rng.uniform01``, the
    704-step main path on bitplane_hbm with a prebuilt plan and with the
    plan build, its launches per chunk and a profile, the cross-tier check,
    the card against the CPU (N=256, and a sparse N=32768 past one block's
    old ceiling) and the timings with the width sweeps. Returns the
    ``kernels`` row of the colored sweep."""
    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        print(f"[phase] colored {name} {now - phase_t:.1f} s")
        phase_t = now

    names = ("u", "s", "e", "best_e", "best_s", "num_flips", "rows_fetched")
    print(f"[setup] colored: greedy coloring and plans of the sparse "
          f"N={SPARSE_N} instance")
    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    prob = ising.IsingProblem.create_sparse(edges, device="cuda")
    t0 = time.perf_counter()
    coloring = greedy_coloring(edges)
    color_s = time.perf_counter() - t0
    plans, plan_s = {}, {}
    dense_prob = ising.IsingProblem(torch.from_numpy(edges.to_dense()).to(
        "cuda"), prob.fields)
    for fmt in ("bitplane_hbm", "bitplane", "dense"):
        t0 = time.perf_counter()
        plans[fmt] = ops.ColoredPlan(
            coloring, dense_prob if fmt == "dense" else prob, fmt).to("cuda")
        torch.cuda.synchronize()
        plan_s[fmt] = time.perf_counter() - t0
    chi = coloring.num_classes
    plan = plans["bitplane_hbm"]
    print(f"[setup] chi={chi} class sizes {coloring.class_sizes.tolist()}, "
          f"max class {coloring.max_class_size}, window S={plan.window}; "
          f"host coloring {color_s:.4f} s, host plan (permute + encode) "
          + ", ".join(f"{k} {v:.4f} s" for k, v in plan_s.items()))
    check(chi == 11 and coloring.max_class_size == 2932
          and plan.window == 3072, "anchor coloring: chi 11, max class 2932, "
          "window 3072")
    coloring.validate_against(edges)   # raises on a monochromatic edge
    print("  ok: no edge joins two spins of one color")
    print(f"[setup] the rule's cluster widths at N={SPARSE_N}, S="
          f"{plan.window}, R={R}: planes "
          f"{sweep.colored_width(SPARSE_N, plan.window, 64, R)}, dense "
          f"{sweep.colored_width(SPARSE_N, plan.window, 64, R, True)}; "
          f"ceiling colored_max_n({plan.window}) = "
          f"{sweep.colored_max_n(plan.window)} spins")
    phase_done("setup")

    main_steps = 64 * chi
    cfg = dataclasses.replace(default_solver(SPARSE_N, main_steps,
                                             mode="rsa"),
                              flip_mode="colored",
                              coupling_format="bitplane_hbm")
    tbl = ops.solver_pwl_table(cfg, device="cuda")
    segs = tbl.shape[0] - 1
    spread = cfg.schedule(torch.linspace(0, main_steps - 1, CHECK_T).to(
        torch.int32))
    err = {}
    print(f"[kernels] colored_sweep against its plain version, N={SPARSE_N}, "
          f"R={R}, T={CHECK_T}, PWL, temperatures across the anneal, at "
          "every cluster width")
    args = colored_inputs(plan, R, CHECK_T, spread, SEED)
    h = plan.problem.fields
    for fmt in ("bitplane_hbm", "bitplane", "dense"):
        op = plans[fmt].store.kernel_operand
        got = sweep.colored_sweep(op, *args, tbl, coupling=fmt)
        want = ref.colored_sweep(op, *args, tbl)
        for name, a, b in zip(names, got, want):
            check(torch.equal(a, b), f"N={SPARSE_N} {fmt} colored {name} "
                  "bit-equal to plain at the rule's width")
        err[fmt] = max_abs_err(got, want)
        print(f"[kernels] {fmt}: max_abs_err {err[fmt]}, flips "
              f"{int(got[5].sum())}, rows_fetched {int(got[6].sum())}")
        if fmt != "dense":
            plane_invariants(plans[fmt].store.planes, h, got,
                             f"N={SPARSE_N} {fmt} colored kernel")
        check(bool((got[6] <= got[5]).all())
              and int(got[6].sum()) < int(got[5].sum()),
              f"{fmt}: rows_fetched <= num_flips per replica, below in sum")
        colored_sweep_widths(plans[fmt], op, args, tbl, fmt, want,
                             f"N={SPARSE_N}", err)
        for block_r in ((1, 2, 4) if fmt == "bitplane_hbm" else ()):
            got = sweep.colored_sweep(op, *args, tbl, coupling=fmt,
                                      block_r=block_r)
            want = ref.colored_sweep(op, *args, tbl, block_r=block_r)
            check(torch.equal(got[6], want[6]) and torch.equal(got[5],
                                                               want[5]),
                  f"{fmt} block_r={block_r}: rows_fetched and num_flips "
                  "equal the plain version's")
        del got, want

    print("[kernels] the keyed colored sweep's draw: its plain version "
          "(ref.colored_uniforms) against rng.uniform01 of the chunk's "
          "stream, and the keyed kernel against the reading one fed the "
          "same words")
    base = rng.fold_in(rng.key(0), SEED)
    words = rng.words(base)
    u0, s0, e0, _, temps, sched = args
    for chunk, t, at in ((0, CHECK_T, 0), (2, 37, 600), (1000, 64, 5)):
        sc = ops.colored_class_schedule(plan.wstarts, plan.offsets,
                                        plan.sizes,
                                        torch.arange(t, device="cuda") + at)
        want = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, chunk),
                             (t, R, plan.window))
        plain = ref.colored_uniforms(words, chunk, sc, R, plan.window,
                                     SPARSE_N)
        drawn = plain != 1.0
        check(torch.equal(plain[drawn], want[drawn])
              and int(drawn.sum()) > 0,
              f"chunk {chunk}, T={t} from step {at}: the draw's plain "
              "version equals rng.uniform01 at every class slot "
              f"({int(drawn.sum())} of them) bitwise")
    unif0 = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, 0),
                          (CHECK_T, R, plan.window)).to("cuda")
    for fmt in ("bitplane_hbm", "bitplane", "dense"):
        op = plans[fmt].store.kernel_operand
        a = sweep.colored_sweep_keyed(op, u0, s0, e0, words, 0, temps, sched,
                                      tbl, window=plan.window, coupling=fmt)
        b = sweep.colored_sweep(op, u0, s0, e0, unif0, temps, sched, tbl,
                                coupling=fmt)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{fmt}: keyed colored kernel (drawing on the card) bit-equal "
              "to the reading kernel fed rng.uniform01, all seven outputs")
        del a, b

    print("[kernels] colored_sweep, exact sigmoid: one step from 64 states "
          "at temperatures across the anneal (block_r=1)")
    ru = 64
    temps1 = cfg.schedule(torch.linspace(0, main_steps - 1, ru).to(
        torch.int32))[None, :]
    pu0, ps0, pe0, punif, ptemps, psched = colored_inputs(plan, ru, 1, temps1,
                                                          SEED + 1)
    op = plan.store.kernel_operand
    a = sweep.colored_sweep(op, pu0, ps0, pe0, punif, ptemps, psched,
                            coupling="bitplane_hbm", block_r=1)
    b = ref.colored_sweep(op, pu0, ps0, pe0, punif, ptemps, psched,
                          block_r=1)
    w, off, size = psched[0].tolist()
    win = plan.window
    idx = torch.arange(win, device="cuda") + w
    valid = ((idx >= off) & (idx < off + size))[None, :]
    de = 2.0 * ps0[:, w:w + win] * pu0[:, w:w + win]
    p = common.flip_probability(de, ptemps[0][:, None], None)
    ulp = torch.nextafter(p, torch.full_like(p, 2.0)) - p
    tie = ((torch.abs(punif[0] - p) <= 4 * ulp) & valid).any(dim=1)
    same = torch.ones(ru, dtype=torch.bool, device="cuda")
    for x, y in zip(a, b):
        same &= (x == y).reshape(ru, -1).all(dim=1)
    check(bool((same | tie).all()),
          f"exact sigmoid: equal on {int(same.sum())} of {ru} states, "
          f"{int(tie.sum())} near ties (accept uniform within 4 ulp of p), "
          "every split a near tie")
    err["exact"] = max_abs_err([x[same] for x in a], [y[same] for y in b])
    got = sweep.colored_sweep(op, *args, coupling="bitplane_hbm")
    plane_invariants(plan.store.planes, h, got,
                     f"N={SPARSE_N} bitplane_hbm colored exact-sigmoid "
                     f"kernel, T={CHECK_T}")
    del a, b, got

    print(f"[kernels] colored_sweep on torus_grid_edges(64, 64), chi=2, "
          f"R={R}, T={CHECK_T}, at every cluster width")
    t_edges = torus_grid_edges(64, 64, seed=1)
    t_prob = ising.IsingProblem.create_sparse(t_edges, device="cuda")
    t_dense = ising.IsingProblem(torch.from_numpy(t_edges.to_dense()).to(
        "cuda"), t_prob.fields)
    t_col = greedy_coloring(t_edges)
    check(t_col.num_classes == 2, "torus 64x64: two color classes")
    t_args = None
    for fmt in ("bitplane_hbm", "bitplane", "dense"):
        t_plan = ops.ColoredPlan(t_col, t_dense if fmt == "dense" else t_prob,
                                 fmt).to("cuda")
        if t_args is None:
            t_args = colored_inputs(t_plan, R, CHECK_T, torch.linspace(
                3.0, 0.1, CHECK_T), SEED)
        op = t_plan.store.kernel_operand
        got = sweep.colored_sweep(op, *t_args, tbl, coupling=fmt)
        want = ref.colored_sweep(op, *t_args, tbl)
        for name, x, y in zip(names, got, want):
            check(torch.equal(x, y), f"torus {fmt} colored {name} bit-equal "
                  "to plain")
        err[("torus", fmt)] = max_abs_err(got, want)
        print(f"[kernels] torus {fmt}: max_abs_err {err[('torus', fmt)]}, "
              f"flips {int(got[5].sum())}, rows_fetched {int(got[6].sum())}")
        colored_sweep_widths(t_plan, op, t_args, tbl, fmt, want, "torus",
                             err)
    u_edges = sparse_bipolar_edges(UNEVEN_N, 8 * UNEVEN_N, seed=UNEVEN_N)
    u_plan = ops.colored_plan(ising.IsingProblem.create_sparse(u_edges),
                              "bitplane_hbm").to("cuda")
    u_args = colored_inputs(u_plan, R, CHECK_T // 2, spread[::2], SEED)
    op = u_plan.store.kernel_operand
    print(f"[kernels] colored_sweep on sparse N={UNEVEN_N} (S="
          f"{u_plan.window}; a shorter last slice at every width "
          f"{sweep.colored_widths(UNEVEN_N, u_plan.window, segs)}), "
          f"R={R}, T={CHECK_T // 2}, bitplane_hbm, at every cluster width")
    want = ref.colored_sweep(op, *u_args, tbl)
    colored_sweep_widths(u_plan, op, u_args, tbl, "bitplane_hbm", want,
                         f"N={UNEVEN_N}", err)
    del want
    phase_done("kernels")

    print(f"[main] solve(sparse N={SPARSE_N}, seed={SEED}, "
          f"replace(default_solver({SPARSE_N}, 64*chi={main_steps}, "
          f"mode='rsa'), flip_mode='colored', coupling_format='bitplane_hbm'),"
          f" backend='colored'), R={R}")
    solve(prob, SEED, dataclasses.replace(cfg, num_steps=256),
          backend="colored")
    torch.cuda.synchronize()
    colored_reset_counts()
    t0 = time.perf_counter()
    res = solve(prob, SEED, cfg, backend="colored")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"colored_sweep": sweep.colored_counter.count,
                "bitplane_field_init": bitplane_field.counter.count,
                "mcmc_sweep": sweep.counter.count,
                "local_field_init": local_field.counter.count}
    flips = int(res.num_flips.sum())
    rows = int(res.rows_fetched.sum())
    cuts = (-float(edges.weights.sum()) - res.best_energy.cpu().numpy()) / 2.0
    print(f"[main] colored: best cut {cuts.max():.0f} (per replica "
          f"{sorted(cuts.tolist(), reverse=True)}), best energy "
          f"{float(res.best_energy.min()):.0f}, flips {flips} "
          f"({flips / main_steps:.1f} per step), {flips / wall:.4e} flips/s, "
          f"{wall / main_steps * 1e6:.3f} us/step (host clock, the solve's "
          f"own plan build included), wall {wall:.4f} s, rows_fetched {rows}, "
          f"launches {launches}")
    check(launches["colored_sweep"] == math.ceil(main_steps / 256),
          f"colored_sweep launched ceil({main_steps}/256) = "
          f"{math.ceil(main_steps / 256)} times")
    check(launches["bitplane_field_init"] == 1
          and launches["mcmc_sweep"] == 0
          and launches["local_field_init"] == 0,
          "bitplane_field_init launched once; mcmc_sweep and "
          "local_field_init never")
    check(tuple(res.best_spins.shape) == (R, SPARSE_N)
          and bool(torch.isfinite(res.best_energy).all()),
          "colored results have shape (R, N) and are finite")
    exact = edge_energy(edges, prob.fields, res.best_spins)
    check(torch.equal(res.best_energy.to(torch.float64), exact),
          "colored best_energy == energy(best_spins) exactly, from the "
          "original edges after the un-permutation")
    check(0 < rows < flips, "colored rows_fetched positive, below num_flips")
    check(round(cuts.max()) == COLORED_MAIN["cut"]
          and flips == COLORED_MAIN["flips"]
          and rows == COLORED_MAIN["rows_fetched"],
          f"the colored main path's trajectory is unchanged: best cut "
          f"{COLORED_MAIN['cut']}, flips {COLORED_MAIN['flips']}, "
          f"rows_fetched {COLORED_MAIN['rows_fetched']}")
    main_launches = launches["colored_sweep"]
    for mode, rate in SINGLE_FLIP_RATE.items():
        print(f"[main] same run, single-flip bitplane_hbm {mode} main "
              f"path at N={SPARSE_N}: {rate:.4e} flips/s (colored "
              f"{flips / wall / rate:.1f}x)")
    host_plan = ops.colored_plan(prob, "bitplane_hbm")
    prebuilt = host_plan.to("cuda")
    ops.colored_anneal(prob, SEED, dataclasses.replace(cfg, num_steps=256),
                       plan=prebuilt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = ops.colored_anneal(prob, SEED, cfg, plan=prebuilt)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    check(all(torch.equal(x, y) for x, y in zip(res, res_p)),
          "the solve with a prebuilt plan= equals the one that builds it")
    print(f"[main] colored with a prebuilt plan=: "
          f"{wall_p / main_steps * 1e6:.3f} us/step (host clock), "
          f"{flips / wall_p:.4e} flips/s; with the plan build "
          f"{wall / main_steps * 1e6:.3f}")
    per_chunk = launches_per_chunk(prob, cfg, backend="colored")
    print(f"[main] colored: {per_chunk:.2f} device launches per chunk")
    check(per_chunk <= min(MAX_CHUNK_LAUNCHES, COLORED_CHUNK_LAUNCHES),
          f"colored: at most {COLORED_CHUNK_LAUNCHES} launches per chunk "
          "(the keyed sweep, the merge, the rows add; no host RNG)")
    phase_done("main")

    print("[profile] torch.profiler over one colored main-path solve, with "
          "the plan build and with a prebuilt plan")
    profile_main_path(prob, cfg, backend="colored")
    prof = profile_device(lambda: ops.colored_anneal(prob, SEED, cfg,
                                                     plan=prebuilt),
                          top=3, tag="[profile] prebuilt plan:")
    if prof is not None:
        kernel_s = sum(
            us for us, _, key in prof["rows"] if "colored_kernel" in key)
        print(f"[profile] colored with a prebuilt plan: kernel D's own "
              f"{kernel_s / main_steps * 1e6:.3f} us/step of "
              f"{prof['wall'] / main_steps * 1e6:.3f}")
    phase_done("profile")

    print(f"[tiers] dense, bitplane and bitplane_hbm colored solves of "
          f"{COLORED_TIER_STEPS} steps at N={SPARSE_N}")
    tier_cfg = dataclasses.replace(cfg, num_steps=COLORED_TIER_STEPS)
    runs = {}
    for fmt, p_ in plans.items():
        runs[fmt] = ops.colored_anneal(
            dense_prob if fmt == "dense" else prob, SEED,
            dataclasses.replace(tier_cfg, coupling_format=fmt), plan=p_)
    for fmt in ("bitplane", "dense"):
        for name in res._fields:
            check(torch.equal(getattr(runs["bitplane_hbm"], name),
                              getattr(runs[fmt], name)),
                  f"colored {fmt} {name} bitwise equal to bitplane_hbm")
    phase_done("tiers")

    print("[reference] small input: the card's colored solves against the "
          "CPU's (sparse N=256, linear schedule)")
    small_edges = sparse_bipolar_edges(256, 2048, seed=3)
    small = {"planes": ising.IsingProblem.create_sparse(small_edges),
             "dense": ising.IsingProblem.create(small_edges.to_dense())}
    for fmt in ("bitplane", "bitplane_hbm", "dense"):
        c = SolverConfig(num_steps=1024, schedule=linear(4.0, 0.05, 1024),
                         mode="rsa", trace_every=256, coupling_format=fmt,
                         flip_mode="colored")
        pr = small["dense" if fmt == "dense" else "planes"]
        on_card = solve(pr, 7, c, backend="colored", device="cuda")
        on_cpu = solve(pr, 7, c, backend="colored", device="cpu")
        for name, a_, b_ in zip(on_card._fields, on_card, on_cpu):
            check(torch.equal(a_.cpu(), b_), f"N=256 colored {fmt} solve "
                  f"{name}: card == CPU")
    big_edges = sparse_bipolar_edges(COLORED_BIG_N, 8 * COLORED_BIG_N,
                                     seed=COLORED_BIG_N)
    big = ising.IsingProblem.create_sparse(big_edges)
    big_plan = ops.colored_plan(big, "bitplane_hbm")
    big_cfg = dataclasses.replace(
        default_solver(COLORED_BIG_N, COLORED_BIG_STEPS, mode="rsa"),
        flip_mode="colored",
        coupling_format="bitplane_hbm")
    width = sweep.colored_width(COLORED_BIG_N, big_plan.window, segs, R)
    print(f"[reference] sparse N={COLORED_BIG_N} (chi="
          f"{big_plan.coloring.num_classes}, window {big_plan.window}; one "
          f"block held at most ~18.8k spins before): card at width {width} "
          f"against the CPU, {COLORED_BIG_STEPS} steps in 16-step chunks")
    sweep.colored_counter.reset()
    on_card = ops.colored_anneal(big, 4, big_cfg, chunk_steps=16,
                                 plan=big_plan, device="cuda")
    check(sweep.colored_counter.count == COLORED_BIG_STEPS // 16,
          f"{COLORED_BIG_STEPS // 16} colored launches on the card")
    on_cpu = ops.colored_anneal(big, 4, big_cfg, chunk_steps=16,
                                plan=big_plan, device="cpu")
    for name in ("best_energy", "best_spins", "num_flips", "rows_fetched",
                 "final_energy"):
        check(torch.equal(getattr(on_card, name).cpu(),
                          getattr(on_cpu, name)),
              f"N={COLORED_BIG_N} colored solve {name}: card == CPU")
    phase_done("reference")

    print("[timing] colored_sweep ms per 256-step launch (CUDA events), "
          "temperatures across the anneal; the keyed kernel (the main "
          "path's) at the rule's width, and the width sweeps")
    steps_t = cfg.schedule(torch.linspace(0, main_steps - 1, T).to(
        torch.int32))
    args = colored_inputs(plan, R, T, steps_t, SEED)
    u0, s0, e0, unif, temps, sched = args
    timing = {}
    for fmt, p_ in plans.items():
        op = p_.store.kernel_operand
        dense = fmt == "dense"
        rule = sweep.colored_width(SPARSE_N, plan.window, segs, R, dense)
        run = (lambda op=op, fmt=fmt: sweep.colored_sweep_keyed(
            op, u0, s0, e0, words, 0, temps, sched, tbl, window=plan.window,
            coupling=fmt))
        out = run()
        replay = colored_replay(op, args, tbl, fmt, row_nonzeros(p_.store))
        count = colored_bytes_ops(p_, R, T, segs, out, sched, replay)
        e_ = {"ms": cuda_ms(run, 5), "bound": bound(*count[:2]),
              "dense_bound": bound(*count[2:4]),
              "old_bound": bound(*count[4:]), "flips": int(out[5].sum()),
              "rows": int(out[6].sum()),
              "read_ms": cuda_ms(lambda op=op, fmt=fmt: sweep.colored_sweep(
                  op, *args, tbl, coupling=fmt), 3)}
        if fmt == "bitplane_hbm":
            e_["plain_ms"] = cuda_ms(lambda: ref.colored_sweep(
                op, *args, tbl), 1)
        timing[fmt] = e_
        print(f"[timing] colored_sweep {fmt} N={SPARSE_N} keyed at C={rule}"
              f": {e_['ms']:.4f} ms ({e_['ms'] / T * 1e3:.3f} us/step; "
              f"reading {e_['read_ms']:.4f}; one block a replica "
              f"{ONE_BLOCK_COLORED_MS[fmt]}), flips {e_['flips']} (on "
              f"{replay['flip_nnz']} nonzero couplings), rows {e_['rows']} "
              f"({replay['row_nnz']}), bound {e_['bound'][0]:.5f} ms "
              f"({e_['bound'][1]}; {e_['bound'][0] / e_['ms']:.1%} of it; a "
              f"dense decode {e_['dense_bound'][0]:.5f} ms, "
              f"{e_['dense_bound'][1]}; a decode per accepted pair "
              f"{e_['old_bound'][0]:.5f} ms, {e_['old_bound'][1]})"
              + (f", plain {e_['plain_ms']:.2f} ms" if "plain_ms" in e_
                 else ""))
        if fmt != "bitplane":   # the same kernel and bytes as bitplane_hbm
            colored_width_sweep(op, args, tbl, fmt, words,
                                f"{fmt} N={SPARSE_N} R={R}")
    r_args = colored_inputs(plan, COLORED_WIDE_R, T, steps_t, SEED)
    colored_width_sweep(plan.store.kernel_operand, r_args, tbl,
                        "bitplane_hbm", words,
                        f"bitplane_hbm N={SPARSE_N} R={COLORED_WIDE_R}")
    del r_args
    t_edges = torus_grid_edges(128, 128, seed=1)
    t_plan = ops.colored_plan(ising.IsingProblem.create_sparse(t_edges),
                              "bitplane_hbm").to("cuda")
    t_args = colored_inputs(t_plan, R, T, torch.linspace(3.0, 0.1, T), SEED)
    op = t_plan.store.kernel_operand
    out = sweep.colored_sweep(op, *t_args, tbl, coupling="bitplane_hbm")
    ms = cuda_ms(lambda: sweep.colored_sweep(op, *t_args, tbl,
                                             coupling="bitplane_hbm"), 5)
    replay = colored_replay(op, t_args, tbl, "bitplane_hbm",
                            row_nonzeros(t_plan.store))
    tb = bound(*colored_bytes_ops(t_plan, R, T, segs, out, t_args[5], replay,
                                  keyed=False)[:2])
    print(f"[timing] colored_sweep bitplane_hbm torus 128x128 (chi=2, "
          f"S={t_plan.window}): {ms:.4f} ms ({ms / T * 1e3:.3f} us/step), "
          f"flips {int(out[5].sum())}, bound {tb[0]:.5f} ms ({tb[1]})")
    for label, edges in (("torus 32x32", torus_grid_edges(32, 32, seed=1)),
                         (f"sparse N={K_PLANE_N}", sparse_bipolar_edges(
                             K_PLANE_N, 8 * K_PLANE_N, seed=K_PLANE_N))):
        s_plan = ops.colored_plan(ising.IsingProblem.create_sparse(edges),
                                  "bitplane_hbm").to("cuda")
        s_args = colored_inputs(s_plan, R, T, steps_t, SEED)
        colored_width_sweep(s_plan.store.kernel_operand, s_args, tbl,
                            "bitplane_hbm", words,
                            f"bitplane_hbm {label} S={s_plan.window} R={R}")
    phase_done("timing")

    e_ = timing["bitplane_hbm"]
    return [{
        "name": "colored_sweep[bitplane_hbm]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/colored_sweep.cu",
        "replaces": "src/repro/kernels/sweep.py:475",
        "launches": main_launches,
        "max_abs_err": max(v for v in err.values()),
        "ms": e_["ms"], "plain_ms": e_["plain_ms"],
        "bound_ms": e_["bound"][0], "bound_by": e_["bound"][1],
        "library_ms": None}]


#: Steps of the reference engine's RWA check on the card, and the band its
#: best cut must fall in besides: within 3 % of the CPU's. The card adds
#: RWA's sums in another order than the CPU, so the two split at near ties
#: (each one shown to be one, step by step, by ``engine_rwa_lockstep``) and
#: the split replicas go their own ways; the others must end bitwise on the
#: CPU's run. The best cut of K2000 at this length spreads over 1.7 %
#: across seeds 0-3 on the CPU (32,585-33,157).
ENGINE_RWA_STEPS = 2048
ENGINE_RWA_BAND = 0.03
#: The statistical tier's chains: R replicas, chunks of CHUNK steps, the
#: states at the chunk boundaries after BURN pooled (as the CPU tests).
STAT_R, STAT_CHUNK, STAT_CHUNKS, STAT_BURN, STAT_TEMP = 64, 48, 130, 10, 2.5
#: The roulette's pick law at full width: one N=16384 state copied to 32
#: replicas, one step per chunk key, the sites in 64 bins of equal mass.
PICK_R, PICK_KEYS, PICK_BINS = 32, 2000, 64
#: A request far past the card's 80 GB: must raise an out-of-memory error
#: that the tier ladder classifies as an allocation failure.
OOM_BYTES = 200 * 2 ** 30
#: Chunks between snapshots of the supervised sparse N=16384 run (256
#: chunks: 16 snapshots).
SPARSE_CKPT_EVERY = 16
#: Snapshots of the [resilient] runs (under build/, which git ignores).
RUN_ROOT = Path(__file__).resolve().parent / "build" / "resilient_runs"


def kernel_counters() -> dict:
    return {"mcmc_sweep": sweep.counter,
            "colored_sweep": sweep.colored_counter,
            "local_field_init": local_field.counter,
            "bitplane_field_init": bitplane_field.counter}


def reset_all_counts() -> None:
    for c in kernel_counters().values():
        c.reset()


def read_all_counts() -> dict:
    return {name: c.count for name, c in kernel_counters().items()}


def timed(run):
    """``(result, host-clock seconds)`` of ``run()``, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_result(a, b, fields=None) -> bool:
    """Every field (or ``fields``) of two ``SolveResult``s bitwise equal,
    on the CPU."""
    for name in fields or a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            if not (x is None and y is None):
                return False
        elif not torch.equal(x.cpu(), y.cpu()):
            return False
    return True


def engine_phase() -> None:
    """[engine]: the reference engine (plain PyTorch, no kernel) on the
    card against the port's CPU reference."""
    inst = complete_bipolar(N, seed=SEED)
    problem = maxcut_to_ising(inst, device="cuda")
    cfg = default_solver(N, STEPS, mode="rsa")
    print(f"[engine] solve(K2000, seed={SEED}, default_solver(2000, {STEPS}, "
          f"'rsa'), backend='reference'), R={R}, PWL: the card against the "
          "CPU")
    reset_all_counts()
    card, wall = timed(lambda: solve(problem, SEED, cfg, backend="reference"))
    counts = read_all_counts()
    cpu, cpu_wall = timed(lambda: solve(problem, SEED, cfg,
                                        backend="reference", device="cpu"))
    check(not any(counts.values()), f"the reference engine launched no "
          f"kernel ({counts})")
    check(same_result(card, cpu), "reference RSA on the card == the CPU's, "
          "bitwise: best_energy, best_spins, final_energy, num_flips, "
          "trace_energy")
    check(torch.equal(card.best_energy, ising.energy(problem,
                                                     card.best_spins)),
          "reference best_energy == energy(best_spins) exactly")
    cuts = cut_from_energy(inst, card.best_energy.cpu().numpy())
    fused = MAIN_PATHS[("dense", "rsa")]["us_step"]
    print(f"[engine] rsa: best cut {cuts.max():.0f}, card "
          f"{wall / STEPS * 1e6:.3f} us/step (host clock; the fused path "
          f"{fused:.3f}, {wall / STEPS * 1e6 / fused:.1f}x), the CPU's "
          f"{cpu_wall / STEPS * 1e6:.3f} us/step")
    rcfg = default_solver(N, ENGINE_RWA_STEPS, mode="rwa")
    card, wall = timed(lambda: solve(problem, SEED, rcfg,
                                     backend="reference"))
    cpu = solve(problem, SEED, rcfg, backend="reference", device="cpu")
    split, t_lock = timed(lambda: engine_rwa_lockstep(problem, rcfg, cpu))
    card_cut = cut_from_energy(inst, card.best_energy.cpu().numpy())
    cpu_cut = cut_from_energy(inst, cpu.best_energy.numpy())
    same = torch.ones(R, dtype=torch.bool)
    for name in ("best_energy", "best_spins", "final_energy", "num_flips"):
        x, y = getattr(card, name).cpu(), getattr(cpu, name)
        same &= (x == y).reshape(R, -1).all(dim=1)
    # A replica no step of whose CPU trajectory splits from the card's pick
    # runs the same trajectory on the card: every state update is the same
    # elementwise arithmetic on both (the RSA check above holds it bitwise).
    check(bool(same[~split].all()) and int(same.sum()) >= R // 2,
          f"reference RWA, {ENGINE_RWA_STEPS} steps: {int(same.sum())} of "
          f"{R} replicas end bitwise on the CPU's run (best and final "
          f"energy, best spins, flips; at least {R // 2}), every replica "
          f"without a split among them ({int((~split).sum())})")
    gap = abs(card_cut.max() - cpu_cut.max()) / cpu_cut.max()
    check(gap <= ENGINE_RWA_BAND,
          f"reference RWA, {ENGINE_RWA_STEPS} steps: the card's best cut "
          f"{card_cut.max():.0f} within {ENGINE_RWA_BAND:.0%} of the CPU's "
          f"{cpu_cut.max():.0f} ({gap:.2%}); lockstep {t_lock:.2f} s")
    check(torch.equal(card.best_energy, ising.energy(problem,
                                                     card.best_spins))
          and int(card.num_flips.sum()) == R * ENGINE_RWA_STEPS,
          "reference RWA: best_energy == energy(best_spins), one flip a "
          "step")
    fused = MAIN_PATHS[("dense", "rwa")]["us_step"]
    print(f"[engine] rwa: card {wall / ENGINE_RWA_STEPS * 1e6:.3f} us/step "
          f"(host clock; the fused path {fused:.3f} at {STEPS} steps)")


def engine_rwa_lockstep(problem, cfg, cpu) -> torch.Tensor:
    """Every step of the CPU's reference RWA run taken again on the card
    from the CPU's state at that step, on the same draws: where the two
    pick different sites the step must be a near tie
    (``parity.roulette_near_tie``), elsewhere the card's next state must be
    the CPU's bitwise. Returns the (R,) replicas with a split."""
    from repro_torch.core import mcmc, solver

    steps, n = cfg.num_steps, problem.num_spins
    mc = solver._mcmc_config(cfg)
    host = problem.to("cpu")
    states, keys = solver.reference_init_state(host, SEED, cfg)
    temps = solver.step_temperatures(cfg.schedule, steps)
    draws = mcmc.step_draws(
        rng.stream(keys[None], torch.arange(steps)[:, None]), n, mc)
    split = torch.zeros(R, dtype=torch.bool)
    splits = ties = 0
    unequal = []
    for t in range(steps):
        d = draws.map(lambda x: x[t])
        on_card, c_info = mcmc.step_drawn(
            problem, mcmc.ChainState(*(x.cuda() for x in states)),
            d.map(lambda x: x.cuda()), temps[t].cuda(), mc)
        nxt, info = mcmc.step_drawn(host, states, d, temps[t], mc)
        differ = c_info.site.cpu() != info.site
        if differ.any():
            delta = 2.0 * states.spins.to(torch.float32) * states.fields
            tie = roulette_near_tie(mc.flip_prob(delta, temps[t]),
                                    d.roulette, d.roulette, False)
            splits += int(differ.sum())
            ties += int((differ & tie).sum())
            split |= differ
        agree = ~differ
        if not all(torch.equal(x.cpu()[agree], y[agree])
                   for x, y in zip(on_card, nxt)):
            unequal.append(t)
        states = nxt
    check(not unequal, f"reference RWA lockstep: the card's next state == "
          f"the CPU's wherever the picks agree (steps {unequal[:8]} not)")
    check(torch.equal(states.best_energy + host.offset, cpu.best_energy)
          and torch.equal(states.best_spins, cpu.best_spins),
          "the lockstep's CPU trajectory is the CPU solve's")
    check(splits == ties,
          f"reference RWA lockstep, {steps} steps x {R} replicas: the card "
          f"picks another site than the CPU in {splits} steps, {ties} of "
          f"them near ties (all must be; replicas with a split "
          f"{split.nonzero().flatten().tolist()})")
    return split


class SimulatedCrash(BaseException):
    """A process death at a chunk boundary: escapes the supervisor's
    handlers, as a kill would."""


def crash_after(chunk: int):
    def hook(kind, info):
        if kind == "snapshot" and info["chunk"] == chunk:
            raise SimulatedCrash()
    return hook


def flip_byte(path: Path) -> None:
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def resilient_phase() -> None:
    """[resilient]: run_resilient at the main paths' sizes against the
    monolithic solve; crash and resume, a corrupt newest snapshot, an
    injected and a real allocation failure."""
    import shutil

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core.backend import get_backend
    from repro_torch.checkpoint import snapshot_steps
    from repro_torch.core.resilience import (inject_faults,
                                             is_allocation_failure,
                                             problem_fingerprint,
                                             run_resilient)

    shutil.rmtree(RUN_ROOT, ignore_errors=True)
    k_prob = maxcut_to_ising(complete_bipolar(N, seed=SEED), device="cuda")
    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    sp_prob = ising.IsingProblem.create_sparse(edges, device="cuda")
    chi = greedy_coloring(edges).num_classes
    paths = (
        ("K2000 dense rwa", k_prob, default_solver(N, STEPS, mode="rwa"),
         "fused", 1, ("mcmc_sweep", "local_field_init")),
        (f"sparse N={SPARSE_N} bitplane_hbm rwa", sp_prob,
         dataclasses.replace(default_solver(SPARSE_N, SPARSE_STEPS,
                                            mode="rwa"),
                             coupling_format="bitplane_hbm"),
         "fused", SPARSE_CKPT_EVERY, ("mcmc_sweep", "bitplane_field_init")),
        (f"colored N={SPARSE_N}", sp_prob,
         dataclasses.replace(default_solver(SPARSE_N, 64 * chi, mode="rsa"),
                             flip_mode="colored",
                             coupling_format="bitplane_hbm"),
         "colored", 1, ("colored_sweep", "bitplane_field_init")))
    _, fp_s = timed(lambda: problem_fingerprint(k_prob))
    print(f"[resilient] problem_fingerprint(K2000): {fp_s * 1e3:.3f} ms (the "
          "dense J copied to the host and hashed; once a run, and only for "
          "a run with a run_dir)")
    for label, prob, cfg, backend, every, kernels in paths:
        steps = cfg.num_steps
        print(f"[resilient] {label}: run_resilient(..., backend="
              f"'{backend}', checkpoint_every={every}) against solve(), "
              f"{steps} steps, R={R}")
        mono, mono_s = timed(lambda: solve(prob, SEED, cfg, backend=backend))
        bare, bare_s = timed(lambda: run_resilient(prob, SEED, cfg,
                                                   backend=backend))
        run_dir = RUN_ROOT / label.replace(" ", "_")
        stamps = {}

        def stamp(kind, info):
            if kind in ("chunk", "snapshot"):
                stamps[(kind, info["chunk"])] = time.perf_counter()

        reset_all_counts()
        rr, rr_s = timed(lambda: run_resilient(
            prob, SEED, cfg, str(run_dir / "full"), backend=backend,
            checkpoint_every=every, on_event=stamp))
        counts = read_all_counts()
        total = rr.total_chunks
        # Between a chunk's "chunk" and "snapshot" events the loop copies
        # the state to the host (waiting for the chunk's kernels) and for a
        # write still running; the write itself runs on a thread, timed
        # here alone on the final state.
        stalls = [stamps[("snapshot", k)] - stamps[("chunk", k)]
                  for k in range(1, total + 1) if ("snapshot", k) in stamps]
        writes = []
        state = get_backend(backend).runner(prob, SEED, cfg).init()
        for i in range(3):
            t0 = time.perf_counter()
            ckpt.save(str(run_dir / "timing"), i, {"state": state})
            writes.append(time.perf_counter() - t0)
        del state
        print(f"[resilient] {label}: launches in the supervised run "
              f"{counts}")
        check(all(counts[k] > 0 for k in kernels),
              f"{label}: the supervised run launched "
              + " and ".join(kernels))
        check(counts[kernels[0]] == total,
              f"{label}: {kernels[0]} launched once a chunk ({total})")
        check(rr.stop_reason == "completed" and not rr.downgrades
              and same_result(mono, rr.result) and same_result(
                  mono, bare.result),
              f"{label}: run_resilient == solve() bitwise, every field "
              "(rows_fetched too), with and without snapshots; no "
              "downgrade recorded")
        print(f"[resilient] {label}: solve() {mono_s / steps * 1e6:.3f} "
              f"us/step, run_resilient without snapshots "
              f"{bare_s / steps * 1e6:.3f}, with {len(stalls)} snapshots "
              f"{rr_s / steps * 1e6:.3f} (host clock): "
              f"{(rr_s - bare_s) / total * 1e3:.3f} ms per chunk; the loop "
              f"stalls {np.median(stalls) * 1e3:.3f} ms at a snapshot "
              f"(median; mean {np.mean(stalls) * 1e3:.3f}: the device "
              f"finishing the chunks queued since the last one, the copy to "
              f"the host, a write still running), a write alone takes "
              f"{np.median(writes) * 1e3:.3f} ms (median of 3)")
        mid = every * max(2, (total // every) // 2)
        for case in ("crash", "corrupt"):
            d = str(run_dir / case)
            try:
                run_resilient(prob, SEED, cfg, d, backend=backend,
                              checkpoint_every=every, keep=10,
                              on_event=crash_after(mid))
                raise RuntimeError("the simulated crash did not happen")
            except SimulatedCrash:
                pass
            want = mid
            if case == "corrupt":
                steps_on_disk = snapshot_steps(d)
                check(steps_on_disk[-1] == mid and len(steps_on_disk) >= 2,
                      f"{label}: snapshots {steps_on_disk[-3:]} on disk "
                      "after the crash")
                flip_byte(Path(d) / f"step_{mid}" / "arrays.npz")
                want = steps_on_disk[-2]
            res, res_s = timed(lambda: run_resilient(
                prob, SEED, cfg, d, backend=backend,
                checkpoint_every=every, keep=10))
            check(res.resumed_from_chunk == want
                  and same_result(mono, res.result),
                  f"{label}: {case} after snapshot {mid}, resumed from "
                  f"chunk {want} == solve() bitwise ({res_s:.3f} s)")
    print("[resilient] tier ladder: an allocation failure injected at "
          "store_build on K2000, coupling_format='auto'")
    cfg = default_solver(N, STEPS, mode="rwa")
    mono = solve(k_prob, SEED, cfg)

    def oom_at_dense(site, info):
        if site == "store_build" and info["fmt"] == "dense":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    with inject_faults(oom_at_dense):
        res = run_resilient(k_prob, SEED, cfg)
    check(res.downgrades == (("dense", "bitplane", 0),)
          and res.result.rows_fetched is not None
          and same_result(mono, res.result),
          f"K2000 'auto': dense -> bitplane recorded ({res.downgrades}), "
          "the result unchanged bitwise (integer J)")
    try:
        torch.empty(OOM_BYTES, dtype=torch.uint8, device="cuda")
        raise RuntimeError(f"a {OOM_BYTES}-byte request did not fail")
    except torch.cuda.OutOfMemoryError as e:
        check(is_allocation_failure(e), "a real torch.cuda.OutOfMemoryError "
              f"({OOM_BYTES / 2**30:.0f} GiB) is an allocation failure")
    shutil.rmtree(RUN_ROOT, ignore_errors=True)


def stat_phase() -> None:
    """[stat]: the statistical tier through kernels A and D on the card,
    with the CPU tests' gates, and the roulette's pick law at full
    width."""
    from repro_torch.kernels import parity

    def gates(label, g):
        chi2 = ("" if "x2" not in g else
                f"chi2 {g['x2']:.2f} (df {g['df']}, gate "
                f"{2 * g['crit']:.2f}), ")
        check(parity.gates_pass(g),
              f"{label}: {chi2}TV {g['tv']:.4f} (< 0.05), at 2T and T/2 "
              f"{g['tv_wrong'][0]:.4f} / {g['tv_wrong'][1]:.4f} (> 3x)")

    g = np.random.default_rng(11)
    J = np.triu(np.rint(g.normal(size=(6, 6)) * 1.2), 1)
    h = np.rint(g.normal(size=6)).astype(np.float32)
    tiny = ising.IsingProblem.create(J + J.T, h, device="cuda")
    chain = dict(r=STAT_R, chunk=STAT_CHUNK, chunks=STAT_CHUNKS,
                 burn=STAT_BURN)
    reset_all_counts()
    counts = {}
    for mode, uni in (("rsa", False), ("rwa", True), ("rwa", False)):
        _, idx, _ = parity.sweep_chain(tiny, STAT_TEMP, mode=mode,
                                       uniformized=uni, **chain)
        counts[(mode, uni)] = np.bincount(idx, minlength=64).astype(float)
    for mode, uni in (("rsa", False), ("rwa", True)):
        gates(f"kernel A {mode}{' uniformized' if uni else ''}, N=6, "
              f"T={STAT_TEMP}", parity.boltzmann_gates(
                  counts[(mode, uni)], tiny, STAT_TEMP))
    a, b = counts[("rsa", False)], counts[("rwa", True)]
    cross = parity.tv_distance(a, b / b.sum())
    check(cross < 0.07, f"kernel A: RSA against uniformized RWA, TV "
          f"{cross:.4f} (< 0.07)")
    gates("kernel A plain RWA, its jump chain weighted by 1/W(s)",
          parity.boltzmann_gates(counts[("rwa", False)], tiny, STAT_TEMP,
                                 1.0 / parity.total_weight(tiny, STAT_TEMP)))
    g = np.random.default_rng(13)
    i, j = g.integers(0, 7, size=10), g.integers(0, 7, size=10)
    keep = i != j
    sedges = ising.EdgeList.create(i[keep], j[keep],
                                   g.choice([-2, -1, 1, 2], size=10)[keep], 7)
    sparse = ising.IsingProblem.create_sparse(
        sedges, h=np.rint(g.normal(size=7)).astype(np.float32))
    plan = ops.colored_plan(sparse, "bitplane").to("cuda")
    pdense = ising.IsingProblem.create(plan.problem.edges.to_dense(),
                                       h=plan.problem.fields.cpu().numpy())
    _, idx, _ = parity.colored_chain(plan, STAT_TEMP, **chain)
    gates(f"kernel D, N=7, chi={plan.coloring.num_classes}",
          parity.boltzmann_gates(np.bincount(idx, minlength=128).astype(
              float), pdense, STAT_TEMP))
    launched = read_all_counts()
    check(launched["mcmc_sweep"] == 3 * STAT_CHUNKS
          and launched["colored_sweep"] == STAT_CHUNKS,
          f"the chains ran on kernels A and D ({launched})")

    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    sp_prob = ising.IsingProblem.create_sparse(edges, device="cuda")
    store = CouplingStore.build(edges, "bitplane_hbm").to("cuda")
    cfg = default_solver(SPARSE_N, SPARSE_STEPS, mode="rwa")
    temp = float(cfg.schedule(torch.tensor(SPARSE_STEPS // 4)))
    state = ops.fused_init_state(sp_prob, rng.fold_in(rng.key(0), SEED), 1,
                                 planes=store.planes)
    u, s, e = (x.expand((PICK_R,) + tuple(x.shape[1:])).contiguous()
               for x in state[:3])
    sweep.counter.reset()
    (picks, p), wall = timed(lambda: parity.roulette_picks(
        store, u, s, e, temp, ops.solver_pwl_table(cfg, device="cuda"),
        keys=PICK_KEYS))
    x2, df, crit = parity.pick_law_chi2(p, picks, PICK_BINS)
    check(sweep.counter.count == PICK_KEYS and x2 < 2 * crit,
          f"kernel A's roulette at N={SPARSE_N} bitplane_hbm, T={temp:.4f}: "
          f"{picks.size} picks ({PICK_KEYS} chunk keys x {PICK_R} "
          f"replicas) against p_i/W in {PICK_BINS} bins of equal mass, "
          f"chi2 {x2:.2f} (df {df}, gate {2 * crit:.2f}); {wall:.2f} s")


# ---------------------------------------------------------------------------
# Parallel tempering, time to solution and the workloads (slice 10).

#: Steps of the tempering main paths, of their card-against-CPU prefix, and
#: the ladder: 8 rungs from sqrt(N) down to 0.05, a swap every 10 steps.
TEMPER_STEPS = 20000
TEMPER_PREFIX = 2000
TEMPER_EVERY = 10
TEMPER_T_MIN = 0.05
#: Swap rounds between snapshots in the supervised tempering check.
TEMPER_CKPT_EVERY = 100
#: A swap whose uniform lies within this many ulp of its probability may
#: go either way between the CPU's exp and the card's.
TIE_ULPS = 4
#: Kernel A with a distinct temperature column per replica: the chunk
#: lengths (one step, a tempering round, a main-path chunk) and widths.
LADDER_TS = (1, 10, 256)
LADDER_WIDTHS = (1, 8)
#: Time to solution on K2000 (paper Table III's target cut): seeds of
#: ``solve_many`` (R=8 each, so 32 runs) and the step budgets.
TTS_SEEDS = 4
TTS_BUDGETS = (2000, 5000, 20000)
#: The CLI's dense workloads on the card: torus<side> and sw<N>.
TORUS_SIDE = 64
SW_N = 2000
WORK_ROOT = Path(__file__).resolve().parent / "build" / "workloads"
#: Launches of this slice's main paths, by the ``kernels`` row they add to.
EXTRA_LAUNCHES: dict = {}
#: The K2000 TTS runs' best spins and energies (RWA, the longest budget),
#: refined by ``greedy_descent`` in ``[workloads]``.
TTS_BEST: dict = {}


def tempering_config(n: int, steps: int, mode: str, fmt: str = "auto"):
    from repro_torch.core.tempering import TemperingConfig

    return TemperingConfig(num_steps=steps, t_min=TEMPER_T_MIN,
                           t_max=math.sqrt(n), num_replicas=R,
                           swap_every=TEMPER_EVERY, mode=mode,
                           backend="fused", coupling_format=fmt)


def sweep_row(fmt: str, mode: str) -> str:
    """The ``kernels`` row of kernel A on tier ``fmt``."""
    return f"mcmc_sweep[{mode}]" if fmt == "dense" else \
        f"mcmc_sweep[{fmt},{mode}]"


def add_launches(counts: dict, fmt: str, mode: str) -> None:
    """Add a main path's launch counts to the rows of its kernels."""
    init = "local_field_init" if fmt == "dense" else "bitplane_field_init"
    for row, kernel in ((sweep_row(fmt, mode), "mcmc_sweep"),
                        (init, init)):
        EXTRA_LAUNCHES[row] = EXTRA_LAUNCHES.get(row, 0) + counts[kernel]


def ladder_kernel_checks() -> None:
    """[kernels] kernel A with a distinct temperature column per replica
    (the ladder, and a random table) against its plain version, RSA + PWL,
    at 1 block and at a cluster of 8, on every tier, T = 1, 10 and 256,
    reading the uniforms and drawing them itself."""
    print("[kernels] mcmc_sweep with a temperature column per replica "
          f"(a ladder, a random table) against its plain version: RSA + "
          f"PWL, R={R}, T in {LADDER_TS}, widths {LADDER_WIDTHS}")
    tbl = ops.solver_pwl_table(default_solver(N, 1, mode="rsa"),
                               device="cuda")
    segs = tbl.shape[0] - 1
    k2 = maxcut_to_ising(complete_bipolar(N, seed=SEED), device="cuda")
    k4 = maxcut_to_ising(complete_bipolar(K_PLANE_N, seed=K_PLANE_N))
    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    tiers = (("dense", k2.couplings, k2.fields),
             ("bitplane", CouplingStore.build(k4.couplings, "bitplane")
              .to("cuda").planes, torch.zeros(K_PLANE_N, device="cuda")),
             ("bitplane_hbm", CouplingStore.build(edges, "bitplane_hbm")
              .to("cuda").planes, torch.zeros(SPARSE_N, device="cuda")))
    gen = torch.Generator("cuda").manual_seed(SEED)
    words = rng.words(rng.fold_in(rng.key(0), SEED))
    names = ("u", "s", "e", "best_e", "best_s", "num_flips", "rows_fetched")
    worst, runs = 0.0, 0
    for fmt, operand, h in tiers:
        n = h.shape[0]
        fits = sweep.widths(n, common.default_lane(n), segs, False)
        for t in LADDER_TS:
            ones = torch.ones(t)
            if fmt == "dense":
                u0, s0, e0, unif, _ = sweep_inputs(k2, R, t, ones, SEED + t)
            else:
                u0, s0, e0, unif, _ = plane_inputs(operand, h, R, t, ones,
                                                   SEED + t)
            ladder = torch.from_numpy(np.geomspace(
                math.sqrt(n), TEMPER_T_MIN, R).astype(np.float32)).cuda()
            tables = {"ladder": ladder[None].expand(t, R).contiguous(),
                      "random": 0.05 + 2.0 * math.sqrt(n) * torch.rand(
                          (t, R), generator=gen, device="cuda")}
            drawn = rng.uniform01(rng.stream(rng.from_words(*words),
                                             rng.Salt.SWEEP, t),
                                  (t, R, 4)).cuda()
            for tname, temps in tables.items():
                for uni, kw in ((unif, {"uniforms": unif}),
                                (drawn, {"base_words": words, "chunk": t})):
                    want = ref.mcmc_sweep(operand, u0, s0, e0, uni, temps,
                                          tbl, mode="rsa", coupling=fmt)
                    for width in LADDER_WIDTHS:
                        if width not in fits:
                            print(f"[kernels]   {fmt} N={n}: width {width} "
                                  f"does not fit (fits {fits}); skipped")
                            continue
                        got = sweep.mcmc_sweep_at_width(
                            width, operand, u0, s0, e0, temps, tbl,
                            mode="rsa", coupling=fmt, **kw)
                        label = (f"{fmt} T={t} {tname} width {width} "
                                 f"{'keyed' if 'chunk' in kw else 'read'}")
                        for name, a, b in zip(names, got, want):
                            check(torch.equal(a, b), f"{label}: {name} "
                                  "bit-equal to plain", quiet=True)
                        worst = max(worst, max_abs_err(got, want))
                        runs += 1
    print(f"[kernels] per-replica temperature columns: {runs} launches "
          f"bitwise their plain version (max |err| {worst})")


class SwapMargins:
    """Records every active swap decision of the CPU's tempering runs: the
    gap between its uniform and its probability in ulps of the probability,
    by round (a spy on ``tempering.swap_permutation``; the card's calls
    pass through untouched, with no read back)."""

    def __init__(self):
        from repro_torch.core import tempering

        self.module = tempering
        self.inner = tempering.swap_permutation
        self.rounds = []

    def __enter__(self):
        inner, rounds = self.inner, self.rounds
        inactive = self.module.INACTIVE_UNIFORM

        def spy(energy, uniforms, dbeta):
            if energy.device.type == "cpu":
                even = uniforms.clone()
                even[1] = inactive
                perm0, _ = inner(energy, even, dbeta)
                gaps = []
                for k, e in ((0, energy), (1, energy[perm0])):
                    p = torch.clamp(torch.exp(torch.clamp(
                        dbeta * (e[:-1] - e[1:]), -80.0, 80.0)), max=1.0)
                    u = uniforms[k]
                    pn = p.numpy().astype(np.float32)
                    with np.errstate(over="ignore"):
                        gap = np.abs(u.numpy() - pn) / np.spacing(pn)
                    gaps += gap[(u <= 1.0).numpy()].tolist()
                rounds.append(gaps)
            return inner(energy, uniforms, dbeta)

        self.module.swap_permutation = spy
        return self

    def __exit__(self, *exc):
        self.module.swap_permutation = self.inner


def launches_per_round(problem, cfg, store=None) -> tuple:
    """``(device events, host launch calls)`` per tempering round: those of
    a 600-round solve less those of a 200-round one, over 400 (the set-up's
    cancel). Device events are the kernels, copies and fills the device
    ran (a CUDA graph's nodes each count); host launch calls are the
    runtime calls of :data:`HOST_LAUNCH_CALLS` (a graph replay is one)."""
    from repro_torch.core.tempering import solve_tempering

    events, calls = [], []
    for rounds in (200, 600):
        c = dataclasses.replace(cfg, num_steps=rounds * cfg.swap_every)
        prof = profile_device(lambda c=c: solve_tempering(
            problem, SEED, c, store=store), top=0,
            tag="[tempering]   launches:")
        if prof is None:
            raise RuntimeError("the profiler saw no device events")
        events.append(prof["events"])
        calls.append(prof["host_calls"])
    return ((events[1] - events[0]) / 400, (calls[1] - calls[0]) / 400)


def tempering_phase() -> None:
    """[tempering]: the tempering main paths on the card — K2000 dense RSA
    (bitwise the CPU's over a 2,000-step prefix, then 20,000 steps;
    supervised, crashed and resumed) and sparse N=16384 ``bitplane_hbm``
    RWA — with their launches per round."""
    import shutil

    from repro_torch.core.resilience import run_resilient
    from repro_torch.core.tempering import (TemperingRunner,
                                            solve_tempering,
                                            tempering_round_count)

    print(f"[tempering] {nvidia_smi()}")
    t0 = time.perf_counter()
    ladder_kernel_checks()
    print(f"[tempering] the column checks took {time.perf_counter() - t0:.1f} s")
    inst = complete_bipolar(N, seed=SEED)
    problem = maxcut_to_ising(inst, device="cuda")
    cfg = tempering_config(N, TEMPER_STEPS, "rsa")
    rounds = tempering_round_count(cfg)
    print(f"[tempering] K2000 dense: {cfg}")

    pre = dataclasses.replace(cfg, num_steps=TEMPER_PREFIX)
    card_run = TemperingRunner(problem, SEED, pre)
    cpu_run = TemperingRunner(problem, SEED, pre, device="cpu")
    split = None
    t0 = time.perf_counter()
    with SwapMargins() as margins:
        cs, hs = card_run.init(), cpu_run.init()
        for k in range(card_run.total_units):
            cs, hs = card_run.run_chunk(cs, k), cpu_run.run_chunk(hs, k)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(cs, hs)):
                split = k
                break
    gaps = [g for r in margins.rounds for g in r]
    near = sum(g <= TIE_ULPS for g in gaps)
    if split is None:
        check(same_result(card_run.finalize(cs, []),
                          cpu_run.finalize(hs, [])),
              f"K2000 tempering, {TEMPER_PREFIX} steps ({len(gaps)} swap "
              "decisions): the card == the CPU bitwise, round by round "
              "(every state tensor), and best energies, best spins, "
              "num_flips, swap_acceptance")
    else:
        check(min(margins.rounds[split]) <= TIE_ULPS,
              f"K2000 tempering: the card splits from the CPU at round "
              f"{split}, where a swap lies within {TIE_ULPS} ulp "
              f"(smallest {min(margins.rounds[split]):.1f})")
    print(f"[tempering] prefix: {len(gaps)} swap decisions, {near} within "
          f"{TIE_ULPS} ulp of their probability, smallest gap "
          f"{min(gaps):.1f} ulp; split at round {split} (lockstep "
          f"{time.perf_counter() - t0:.1f} s)")

    reset_all_counts()
    res, wall = timed(lambda: solve_tempering(problem, SEED, cfg))
    counts = read_all_counts()
    print(f"[tempering] K2000 launches: {counts}")
    check(counts["mcmc_sweep"] == rounds and counts["local_field_init"] == 1,
          f"K2000 tempering: kernel A once a round ({rounds}), kernel B "
          "once")
    add_launches(counts, "dense", "rsa")
    check(torch.equal(res.best_energy, ising.energy(problem,
                                                    res.best_spins)),
          "K2000 tempering: best_energy == energy(best_spins) exactly")
    acc = float(res.swap_acceptance)
    check(0.0 < acc < 1.0, f"K2000 tempering: swap acceptance {acc:.4f} in "
          "(0, 1)")
    cuts = cut_from_energy(inst, res.best_energy.cpu().numpy())
    fused = MAIN_PATHS.get(("dense", "rsa"), {}).get("us_step", math.nan)
    # The host clock spreads on a shared host: two more solves, and the
    # supervised loop between them.
    walls = [wall] + [timed(lambda: solve_tempering(problem, SEED, cfg))[1]
                      for _ in range(2)]
    us = float(np.median(walls)) / TEMPER_STEPS * 1e6
    prof = profile_device(lambda: solve_tempering(problem, SEED, cfg), top=4,
                          tag="[tempering] K2000 profile:")
    per_round, host_round = launches_per_round(problem, cfg)
    check(host_round <= 3, f"K2000 tempering: {host_round:.2f} host launch "
          "calls a round (the sweep, the uniform row, the graph replay)")
    kernel_us = (math.nan if prof is None
                 else prof["sweep_s"] / TEMPER_STEPS * 1e6)
    print(f"[tempering] K2000 dense rsa: {us:.3f} us/step (host clock, "
          f"median of {[round(w / TEMPER_STEPS * 1e6, 3) for w in walls]}; "
          f"the fused solve {fused:.3f}, {us / fused:.2f}x), kernel A's own "
          f"{kernel_us:.3f} us/step, {per_round:.2f} device events and "
          f"{host_round:.2f} host launch calls per round (the merge and "
          f"swap replayed as one CUDA graph), swap acceptance {acc:.4f}, "
          f"best cut {cuts.max():.0f} "
          f"(per rung {np.round(cuts).astype(int).tolist()}); "
          f"{nvidia_smi()}")

    print(f"[tempering] run_resilient(backend='tempering') at K2000 against "
          f"solve_tempering, a snapshot every {TEMPER_CKPT_EVERY} rounds")
    bare, bare_s = timed(lambda: run_resilient(problem, SEED, cfg,
                                               backend="tempering"))
    _, mono_s = timed(lambda: solve_tempering(problem, SEED, cfg))
    check(bare.stop_reason == "completed" and same_result(res, bare.result),
          "supervised tempering == solve_tempering bitwise")
    run_dir = RUN_ROOT / "tempering"
    shutil.rmtree(run_dir, ignore_errors=True)
    mid = rounds // 2
    try:
        run_resilient(problem, SEED, cfg, str(run_dir), backend="tempering",
                      checkpoint_every=TEMPER_CKPT_EVERY,
                      on_event=crash_after(mid))
        raise RuntimeError("the simulated crash did not happen")
    except SimulatedCrash:
        pass
    again, again_s = timed(lambda: run_resilient(
        problem, SEED, cfg, str(run_dir), backend="tempering",
        checkpoint_every=TEMPER_CKPT_EVERY))
    check(again.resumed_from_chunk == mid and same_result(res, again.result),
          f"tempering crashed after round {mid}, resumed from it == "
          f"solve_tempering bitwise (swap_acceptance too)")
    shutil.rmtree(run_dir, ignore_errors=True)
    print(f"[tempering] supervised: {bare_s / TEMPER_STEPS * 1e6:.3f} us/step "
          f"without snapshots, solve_tempering right after it "
          f"{mono_s / TEMPER_STEPS * 1e6:.3f}; the resumed half "
          f"{again_s:.3f} s")

    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    sp = ising.IsingProblem.create_sparse(edges, device="cuda")
    scfg = tempering_config(SPARSE_N, TEMPER_STEPS, "rwa", "bitplane_hbm")
    store = CouplingStore.build(edges, "bitplane_hbm")
    print(f"[tempering] sparse N={SPARSE_N} (nnz {edges.nnz}): {scfg}")
    reset_all_counts()
    sres, swall = timed(lambda: solve_tempering(sp, SEED, scfg, store=store))
    counts = read_all_counts()
    check(counts["mcmc_sweep"] == rounds
          and counts["bitplane_field_init"] == 1,
          f"sparse tempering: kernel A once a round ({rounds}), kernel C "
          "once")
    add_launches(counts, "bitplane_hbm", "rwa")
    exact = edge_energy(edges, sp.fields, sres.best_spins)
    check(torch.equal(sres.best_energy.to(torch.float64), exact),
          "sparse tempering: best_energy == energy(best_spins) exactly "
          "(from the edge list, in float64)")
    sacc = float(sres.swap_acceptance)
    check(0.0 < sacc < 1.0, f"sparse tempering: swap acceptance {sacc:.4f} "
          "in (0, 1)")
    sper_round, shost_round = launches_per_round(sp, scfg, store)
    cut = (-float(edges.weights.sum()) - sres.best_energy.min().item()) / 2
    print(f"[tempering] sparse N={SPARSE_N} bitplane_hbm rwa: "
          f"{swall / TEMPER_STEPS * 1e6:.3f} us/step (host clock, store "
          f"prebuilt; the fused solve "
          f"{MAIN_PATHS.get(('bitplane_hbm', 'rwa'), {}).get('us_step', math.nan):.3f}), "
          f"{sper_round:.2f} device events and {shost_round:.2f} host "
          f"launch calls per round, swap acceptance "
          f"{sacc:.4f}, best energy {sres.best_energy.min().item():.0f} "
          f"(cut {cut:.0f}, weights -J); {nvidia_smi()}")


def tts_phase() -> None:
    """[tts]: time to solution on K2000 at Table III's 33,000 cut — RSA and
    RWA over 4 seeds x R=8 at three budgets, and parallel tempering at the
    longest — with the JAX CLI's convention (each replica a run taking
    wall / runs)."""
    from repro_torch.core import tts
    from repro_torch.core.solver import solve_many
    from repro_torch.core.tempering import (solve_tempering,
                                            tempering_round_count)

    inst = complete_bipolar(N, seed=SEED)
    problem = maxcut_to_ising(inst, device="cuda")
    target = K2000.target_cut
    runs_n = TTS_SEEDS * R
    print(f"[tts] K2000 (complete_bipolar(2000, seed=0)), target cut "
          f"{target:.0f}: {TTS_SEEDS} seeds x R={R} = {runs_n} runs per "
          f"budget, t_a = wall / {runs_n}; {nvidia_smi()}")
    rows = []
    for mode in ("rsa", "rwa"):
        for steps in TTS_BUDGETS:
            cfg = default_solver(N, steps, mode=mode)
            reset_all_counts()
            runs, wall = timed(lambda: solve_many(problem,
                                                  range(TTS_SEEDS), cfg))
            counts = read_all_counts()
            check(counts["mcmc_sweep"] == TTS_SEEDS * math.ceil(steps / T)
                  and counts["local_field_init"] == TTS_SEEDS,
                  f"tts {mode} {steps}: kernels A and B launched "
                  f"({counts})")
            add_launches(counts, "dense", mode)
            check(torch.equal(runs.best_energy,
                              ising.energy(problem, runs.best_spins)),
                  f"tts {mode} {steps}: best_energy == energy(best_spins)")
            cuts = cut_from_energy(inst, runs.best_energy.cpu().numpy()
                                   .reshape(-1))
            rows.append((f"{mode} {steps}", cuts, wall))
            if mode == "rwa" and steps == TTS_BUDGETS[-1]:
                TTS_BEST.update(spins=runs.best_spins,
                                energy=runs.best_energy)
    tcfg = tempering_config(N, TTS_BUDGETS[-1], "rsa")
    reset_all_counts()
    temp, wall = timed(lambda: [solve_tempering(problem, s, tcfg)
                                for s in range(TTS_SEEDS)])
    counts = read_all_counts()
    check(counts["mcmc_sweep"] == TTS_SEEDS * tempering_round_count(tcfg),
          f"tts tempering: kernel A once a round ({counts})")
    add_launches(counts, "dense", "rsa")
    be = torch.stack([t.best_energy for t in temp]).cpu().numpy()
    rows.append((f"tempering {TTS_BUDGETS[-1]}", cut_from_energy(
        inst, be.reshape(-1)), wall))
    best = None
    for label, cuts, wall in rows:
        t_a = wall / runs_n * 1e3
        est = tts.estimate(-cuts, threshold=-target, time_per_run=t_a)
        print(f"[tts] {label:16s}: P_a={est.success_probability:.4f} "
              f"({est.num_successes}/{est.num_runs}), t_a={t_a:.4f} ms, "
              f"TTS(0.99)={est.tts:.4f} ms, best cut {cuts.max():.0f}, "
              f"mean {cuts.mean():.1f}")
        if best is None or est.tts < best[1]:
            best = (label, est.tts)
    print(f"[tts] best TTS(0.99) at cut {target:.0f}: {best[1]:.4f} ms "
          f"({best[0]}); {nvidia_smi()}")


def gset_text(weights: np.ndarray) -> str:
    """A symmetric weight matrix in Gset syntax (1-indexed upper triangle)."""
    i, j = np.nonzero(np.triu(weights, 1))
    lines = [f"{weights.shape[0]} {i.size}"]
    lines += [f"{a + 1} {b + 1} {weights[a, b]:g}" for a, b in zip(i, j)]
    return "\n".join(lines) + "\n"


def workloads_phase() -> None:
    """[workloads]: the CLI on the card on torus<side>, sw<N> and two Gset
    files (the embedded sample and a G6-sized Erdős–Rényi), each with its
    best cut and launches; then greedy_descent on the card on the K2000
    TTS runs' best spins against the CPU's."""
    import contextlib
    import io
    import shutil

    from repro_torch.core.coupling import BITPLANE_L2_MAX_N
    from repro_torch.core.refine import greedy_descent
    from repro_torch.graphs import GSET_SAMPLE, erdos_renyi, parse_gset
    from repro_torch.launch import solve as cli

    print(f"[workloads] {nvidia_smi()}")
    shutil.rmtree(WORK_ROOT, ignore_errors=True)
    WORK_ROOT.mkdir(parents=True)
    sample = WORK_ROOT / "G_sample"
    sample.write_text(GSET_SAMPLE)
    g6 = WORK_ROOT / "G6_mini"
    g6_inst = erdos_renyi(200, 4800, seed=6, name="G6-mini")
    g6.write_text(gset_text(g6_inst.weights))
    s_inst = parse_gset(str(sample))
    e_star, _, _ = ising.brute_force_ground_state(maxcut_to_ising(s_inst))
    s_best = float(cut_from_energy(s_inst, e_star))

    def run(args, n, mode="rwa"):
        buf = io.StringIO()
        reset_all_counts()
        with contextlib.redirect_stdout(buf):
            cli.main(args)
        counts = read_all_counts()
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"[workloads]   {line}")
        fmt = ("dense" if counts["local_field_init"] else "bitplane"
               if n <= BITPLANE_L2_MAX_N else "bitplane_hbm")
        check(counts["mcmc_sweep"] > 0, f"{args}: kernel A launched "
              f"({counts})")
        add_launches(counts, fmt, mode)
        return float(re.search(r"best cut = (\S+)", out).group(1)), out

    steps = str(STEPS)
    cut, _ = run(["--instance", f"torus{TORUS_SIDE}", "--steps", steps],
                 TORUS_SIDE ** 2)
    check(0 < cut <= 2 * TORUS_SIDE ** 2, f"torus{TORUS_SIDE}: best cut "
          f"{cut:.0f} in (0, |E|]")
    cut, _ = run(["--instance", f"sw{SW_N}", "--steps", steps], SW_N)
    check(cut > 0, f"sw{SW_N}: best cut {cut:.0f} positive")
    cut, out = run(["--gset", str(sample), "--steps", "2000",
                    "--tts-threshold", f"{s_best:g}"], 10)
    check(cut == s_best and "P_a=1.00" in out,
          f"Gset sample (N=10): best cut {cut:.0f} == the brute-force "
          f"optimum {s_best:.0f}, P_a = 1 at it")
    cut, _ = run(["--gset", str(g6), "--steps", "5000"], 200)
    cut2, out = run(["--gset", str(g6), "--steps", "5000",
                     "--tts-threshold", f"{0.97 * cut:.0f}"], 200)
    check(cut2 == cut and "TTS(0.99) @ cut≥" in out,
          f"G6-mini through --gset: best cut {cut:.0f} on both runs, the "
          "TTS line printed")
    shutil.rmtree(WORK_ROOT, ignore_errors=True)

    inst = complete_bipolar(N, seed=SEED)
    problem = maxcut_to_ising(inst, device="cuda")
    spins, energy = TTS_BEST["spins"], TTS_BEST["energy"]
    (ref_s, ref_e), wall = timed(lambda: greedy_descent(problem, spins))
    cpu_s, cpu_e = greedy_descent(problem.to("cpu"), spins.cpu())
    check(torch.equal(ref_s.cpu(), cpu_s) and torch.equal(ref_e.cpu(), cpu_e),
          "greedy_descent on the card == the CPU's, bitwise (spins and "
          "energies)")
    check(bool((ref_e <= energy).all()), "greedy_descent never lowers a cut")
    before = cut_from_energy(inst, energy.cpu().numpy().reshape(-1))
    after = cut_from_energy(inst, ref_e.cpu().numpy().reshape(-1))
    print(f"[workloads] greedy_descent on the {before.size} K2000 RWA "
          f"{TTS_BUDGETS[-1]}-step runs' best spins: {int((after > before).sum())} "
          f"improved, best cut {before.max():.0f} -> {after.max():.0f}, mean "
          f"{before.mean():.1f} -> {after.mean():.1f}, {wall:.3f} s on the "
          "card")



#: The [serve] burst: 8 seed-free K2000 RWA tenants at R=8 stacking into one
#: 64-replica launch, 4 seed-pinned ones (the "vmap" lane), 2 seed-free
#: tenants on the sparse N=16384 edge list on bitplane_hbm (a bucket: no
#: padding) and one colored request on it; K2000 pads to 2,048 spins.
SERVE_STACKED, SERVE_PINNED, SERVE_SPARSE = 8, 4, 2
SERVE_STEPS = 5000
SERVE_SPARSE_STEPS = 16384
#: The anchor burst (RSA + PWL, a linear schedule, integer J and h) at a
#: small N, drained on the card and on the CPU.
SERVE_ANCHOR_N, SERVE_ANCHOR_STEPS = 48, 96


def capture_kernel_calls(run):
    """``(run(), calls)``: ``run()`` with kernel A's keyed entry and
    kernels B's and C's wrappers wrapped, so that the first call at each
    shape is recorded (its tensors cloned before the launch). The launches
    and their counts are those of the unwrapped run."""
    calls = {}
    keys = {(sweep, "mcmc_sweep_keyed"):
            lambda c, u, *a, **kw: (kw.get("coupling", "dense"),
                                    tuple(u.shape)),
            (local_field, "local_field_init"):
            lambda s, j, h: (tuple(s.shape),),
            (bitplane_field, "bitplane_field_init"):
            lambda pos, neg, w: (tuple(pos.shape), tuple(w.shape))}
    real = {k: getattr(*k) for k in keys}

    def recorder(k):
        def wrapped(*args, **kw):
            key = (k[1],) + keys[k](*args, **kw)
            if key not in calls:
                calls[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kw))
            return real[k](*args, **kw)
        return wrapped

    for k in keys:
        setattr(*k, recorder(k))
    try:
        out = run()
    finally:
        for k, fn in real.items():
            setattr(*k, fn)
    return out, calls


def stepwise_sweep_check(label: str, args, kw) -> tuple:
    """Kernel A on one chunk's operands as the main path gave them
    (``args`` of ``mcmc_sweep_keyed``): the keyed kernel bitwise the reading
    kernel fed the chunk's plain draw; then, step by step from the
    kernel's own trajectory, one-step launches against the plain version
    (RWA near ties masked per replica, and per replica group for the
    coalesced rows count); the T one-step launches compose to the chunk's
    launch. Returns (the chunk's outputs, near ties, max_abs_err)."""
    couplings, u0, s0, e0, words, chunk, temps, tbl = args
    t, r = temps.shape
    rwa, uni = kw["mode"] == "rwa", kw.get("uniformized", False)
    plain_kw = {k: v for k, v in kw.items() if k != "gather"}
    unif = rng.uniform01(rng.stream(rng.from_words(*words), rng.Salt.SWEEP,
                                    chunk), (t, r, 4)).to("cuda")
    keyed = sweep.mcmc_sweep_keyed(*args, **kw)
    read = sweep.mcmc_sweep(couplings, u0, s0, e0, unif, temps, tbl, **kw)
    check(all(torch.equal(x, y) for x, y in zip(keyed, read)),
          f"{label}: the keyed kernel bitwise the reading kernel fed the "
          f"chunk's plain draw (chunk {chunk}, T={t}), all seven outputs")
    br = common.fit_block(r, kw.get("block_r", 8))
    u, s, e = u0, s0, e0
    nf = torch.zeros_like(read[5])
    rf = torch.zeros_like(read[6])
    bad = torch.zeros(r, dtype=torch.bool, device="cuda")
    ties = torch.zeros((), dtype=torch.int64, device="cuda")
    err = torch.zeros((), dtype=torch.float64, device="cuda")
    for i in range(t):
        step = (unif[i:i + 1], temps[i:i + 1], tbl)
        a = sweep.mcmc_sweep(couplings, u, s, e, *step, **kw)
        b = ref.mcmc_sweep(couplings, u, s, e, *step, **plain_kw)
        keep = torch.ones(r, dtype=torch.bool, device="cuda")
        if rwa:
            p_all = common.flip_probability(2.0 * s * u, temps[i][:, None],
                                            tbl)
            keep = ~roulette_near_tie(p_all, unif[i, :, 2], unif[i, :, 3],
                                      uni)
        group = keep.reshape(-1, br).all(1).repeat_interleave(br)
        for j, (x, y) in enumerate(zip(a, b)):
            mask = group if j == 6 else keep
            diff = (x.to(torch.float64) - y.to(torch.float64)).abs()
            diff = diff.reshape(r, -1).amax(1) * mask
            bad |= diff > 0
            err = torch.maximum(err, diff.max())
        ties += r - keep.sum()
        u, s, e = a[:3]
        nf += a[5]
        rf += a[6]
    ties, err = int(ties), float(err)
    check(not bool(bad.any()), f"{label}: {t} one-step launches from the "
          f"kernel's trajectory bitwise the plain version, all seven "
          f"outputs ({ties} near ties of {t * r} replica steps masked)")
    check(torch.equal(u, read[0]) and torch.equal(s, read[1])
          and torch.equal(e, read[2]) and torch.equal(nf, read[5])
          and torch.equal(rf, read[6]),
          f"{label}: the {t} one-step launches compose to the chunk's "
          "(u, s, e, num_flips, rows_fetched)")
    return read, ties, err


def serve_kernel_checks(reqs, dense, sparse, padded) -> None:
    """Kernels A, B and C held against their plain versions on the
    operands the service's batched drain gave them: the first chunk of the
    stacked K2000 launch (N=2048, the padded zero rows included, R=64) and
    of a vmap lane (R=8), the stacked sparse launch (bitplane_hbm, R=16),
    and every init of the drain."""
    from repro_torch.serve import SolverService

    svc = SolverService(device="cuda")
    for r in reqs:
        svc.submit(r)
    reset_all_counts()
    _, calls = capture_kernel_calls(svc.drain)
    serve_launches(read_all_counts(), math.ceil(SERVE_SPARSE_STEPS / T))
    n_pad = padded.num_spins
    want = {("mcmc_sweep_keyed", "dense", (SERVE_STACKED * R, n_pad)),
            ("mcmc_sweep_keyed", "dense", (R, n_pad)),
            ("mcmc_sweep_keyed", "bitplane_hbm", (SERVE_SPARSE * R,
                                                 SPARSE_N))}
    check(want <= set(calls), f"the drain's kernel A shapes captured: "
          f"{sorted(k for k in calls if k[0] == 'mcmc_sweep_keyed')}")
    print(f"[kernels] [serve] kernels A, B and C against their plain "
          f"versions on the batched drain's own operands (first chunk, "
          f"T={T}; {nvidia_smi()})")
    for key in sorted(calls, key=str):
        (args, kw), name = calls[key], key[0]
        if name == "local_field_init":
            s0, j, h = args
            check(torch.equal(j, padded.couplings)
                  and torch.equal(h, padded.fields)
                  and not bool(j[N:].any()) and not bool(j[:, N:].any()),
                  f"the R={s0.shape[0]} init reads the padded K2000 (rows "
                  f"and columns {N}..{n_pad - 1} zero)")
            got = local_field.local_field_init(s0, j, h)
            check(torch.equal(got, ref.local_field_init(s0, j, h)),
                  f"local_field_init (R={s0.shape[0]}, N={n_pad}) bit-equal "
                  "to plain")
        elif name == "bitplane_field_init":
            pos, neg, w = args
            got = bitplane_field.bitplane_field_init(pos, neg, w)
            check(torch.equal(got, ref.bitplane_field_init(pos, neg, w)),
                  f"bitplane_field_init (B={pos.shape[0]}, N={pos.shape[1]}"
                  f", W={pos.shape[2]}, R={w.shape[0]}) bit-equal to plain")
        else:
            fmt, (r, n) = key[1], key[2]
            label = f"{fmt} {kw['mode']} R={r} N={n}"
            out, ties, err = stepwise_sweep_check(label, args, kw)
            if fmt == "dense":
                check(torch.equal(args[0], padded.couplings),
                      f"{label}: the sweep reads the padded K2000")
                invariants(padded, out, T, f"{label} chunk")
            else:
                plane_invariants(args[0], sparse.fields, out,
                                 f"{label} chunk")
            print(f"[kernels] [serve] {label}: max_abs_err {err} on the "
                  f"unmasked steps, {ties} near ties")


def serve_launches(counts: dict, sparse_sweeps: int) -> None:
    """Add a [serve] run's launches to the kernels rows: kernel A's K2000
    (dense RWA) and sparse (bitplane_hbm RWA, ``sparse_sweeps`` of them)
    launches, the two inits and the colored sweep."""
    for row, n in (("mcmc_sweep[rwa]", counts["mcmc_sweep"] - sparse_sweeps),
                   ("mcmc_sweep[bitplane_hbm,rwa]", sparse_sweeps),
                   ("local_field_init", counts["local_field_init"]),
                   ("bitplane_field_init", counts["bitplane_field_init"]),
                   ("colored_sweep[bitplane_hbm]", counts["colored_sweep"])):
        EXTRA_LAUNCHES[row] = EXTRA_LAUNCHES.get(row, 0) + n


def serve_burst(dense, sparse, stacked_cfg, sparse_cfg, colored_cfg):
    """The burst's requests, in submission order, and each one's label."""
    from repro_torch.serve import SolveRequest

    reqs = [SolveRequest(dense, stacked_cfg)
            for _ in range(SERVE_STACKED)]
    reqs += [SolveRequest(dense, stacked_cfg, seed=100 + i)
             for i in range(SERVE_PINNED)]
    reqs += [SolveRequest(sparse, sparse_cfg) for _ in range(SERVE_SPARSE)]
    reqs.append(SolveRequest(sparse, colored_cfg, seed=7,
                             backend="colored"))
    labels = (["stack"] * SERVE_STACKED + ["vmap"] * SERVE_PINNED
              + ["stack"] * SERVE_SPARSE + ["single"])
    return reqs, labels


def drain_burst(service, reqs):
    """Submit the burst and drain it: ``(tickets, results, submit seconds
    per request, drain wall, kernel launches)``."""
    t_sub = []
    tickets = []
    for r in reqs:
        t0 = time.perf_counter()
        tickets.append(service.submit(r))
        t_sub.append(time.perf_counter() - t0)
    reset_all_counts()
    out, wall = timed(service.drain)
    return tickets, out, t_sub, wall, read_all_counts()


def serve_anchor_check() -> None:
    """The same kinds of lanes on the anchor at a small N (RSA + PWL,
    linear schedule, integer J and h, N=48 padded to 64): the card's drain
    bitwise the CPU's, ticket by ticket, with equal stats."""
    from repro_torch.core.resilience import BudgetConfig
    from repro_torch.serve import SolveRequest, SolverService

    n, steps = SERVE_ANCHOR_N, SERVE_ANCHOR_STEPS

    def problem(seed):
        g = np.random.default_rng(seed)
        J = np.triu(np.rint(g.normal(size=(n, n)) * 1.5), 1)
        return ising.IsingProblem.create(J + J.T, np.rint(g.normal(size=n)),
                                         offset=-2.0)

    cfg = SolverConfig(num_steps=steps, schedule=linear(6.0, 0.05, steps),
                       mode="rsa", num_replicas=2, trace_every=16)
    runs = []
    for dev in ("cuda", "cpu"):
        a = problem(21)
        reqs = [SolveRequest(a, cfg), SolveRequest(a, cfg),
                SolveRequest(a, dataclasses.replace(cfg, num_replicas=3)),
                SolveRequest(a, cfg, seed=5), SolveRequest(problem(21), cfg,
                                                           seed=6),
                SolveRequest(problem(22), cfg, seed=7),
                SolveRequest(a, cfg, seed=8,
                             budget=BudgetConfig(max_steps=48))]
        svc = SolverService(device=dev)
        tickets = [svc.submit(r) for r in reqs]
        out = svc.drain()
        best = min(float(out[t].result.best_energy.min()) for t in tickets)
        tickets.append(svc.submit(SolveRequest(
            a, cfg, budget=BudgetConfig(target_energy=best + 1.0))))
        out.update(svc.drain())
        runs.append((tickets, out, svc.stats))
    (tc, card, sc), (tp, cpu, sp) = runs
    kinds = [card[t].batched for t in tc]
    check(tc == tp and kinds == ["stack"] * 3 + ["vmap"] * 2
          + ["single", "budgeted", "cached"] and sc == sp,
          f"anchor burst (N={n} -> 64): the same tickets, lanes {kinds} and "
          f"stats on the card and the CPU")
    for t in tc:
        c, p = card[t], cpu[t]
        same = ((c.batched, c.store_hit, c.warm_hit, c.stop_reason)
                == (p.batched, p.store_hit, p.warm_hit, p.stop_reason)
                and same_result(c.result, p.result,
                                ("best_energy", "best_spins", "num_flips",
                                 "final_energy", "trace_energy")))
        check(same, f"anchor ticket {t} ({c.batched}): the card's result "
              "bitwise the CPU's", quiet=True)
    print(f"  ok: every anchor ticket's best/final energy, best spins, "
          f"flips and trace bitwise the CPU's ({len(tc)} tickets)")


def serve_phase() -> None:
    """[serve]: one burst through ``SolverService(device="cuda")`` with
    batching and with ``ServeConfig(batching=False)``: its lanes held
    against solo solves, exact energies on the unpadded instances, a repeat
    tenant on the store cache, a met target answered without a launch, a
    budgeted request; the anchor burst on the card against the CPU; and
    kernels A, B and C against their plain versions on the drain's own
    operands."""
    from repro_torch.core import coupling
    from repro_torch.core.resilience import BudgetConfig
    from repro_torch.serve import (ServeConfig, SolverService,
                                   bucket_replicas, bucket_spins,
                                   coupling_digest, pad_problem,
                                   problem_digest)

    inst = complete_bipolar(N, seed=SEED)
    dense = maxcut_to_ising(inst, device="cuda")
    edges = sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)
    sparse = ising.IsingProblem.create_sparse(edges, device="cuda")
    stacked_cfg = default_solver(N, SERVE_STEPS, mode="rwa")
    sparse_cfg = dataclasses.replace(
        default_solver(SPARSE_N, SERVE_SPARSE_STEPS, mode="rwa"),
        coupling_format="bitplane_hbm")
    colored_cfg = dataclasses.replace(
        default_solver(SPARSE_N, 704, mode="rsa"), flip_mode="colored",
        coupling_format="bitplane_hbm")
    reqs, labels = serve_burst(dense, sparse, stacked_cfg, sparse_cfg,
                               colored_cfg)
    n_pad = bucket_spins(N)
    print(f"[serve] burst of {len(reqs)} requests: {SERVE_STACKED} seed-free "
          f"K2000 RWA (R={R}, {SERVE_STEPS} steps; N={N} pads to {n_pad}), "
          f"{SERVE_PINNED} seed-pinned, {SERVE_SPARSE} seed-free sparse "
          f"N={SPARSE_N} bitplane_hbm RWA ({SERVE_SPARSE_STEPS} steps), one "
          f"colored (704 steps); {nvidia_smi()}")

    chunks = math.ceil(SERVE_STEPS / T)
    sparse_chunks = math.ceil(SERVE_SPARSE_STEPS / T)
    colored_chunks = math.ceil(704 / T)
    want = {True: {"mcmc_sweep": (1 + SERVE_PINNED) * chunks + sparse_chunks,
                   "local_field_init": 1 + SERVE_PINNED,
                   "bitplane_field_init": 2, "colored_sweep": colored_chunks},
            False: {"mcmc_sweep": (SERVE_STACKED + SERVE_PINNED) * chunks
                    + SERVE_SPARSE * sparse_chunks,
                    "local_field_init": SERVE_STACKED + SERVE_PINNED,
                    "bitplane_field_init": SERVE_SPARSE + 1,
                    "colored_sweep": colored_chunks}}
    # In turns (batched, unbatched, unbatched, batched), each drain on a
    # new service with cold caches; the checks below read the first of each.
    runs, walls = {}, {True: [], False: []}
    for batching in (True, False, False, True):
        svc = SolverService(ServeConfig(batching=batching), device="cuda")
        tickets, out, t_sub, wall, counts = drain_burst(svc, reqs)
        runs.setdefault(batching, (svc, tickets, out, t_sub, wall, counts))
        walls[batching].append(wall)
        print(f"[serve] batching={batching}: {len(reqs) / wall:.3f} "
              f"requests/s, drain wall {wall:.4f} s, submit "
              f"{sum(t_sub) / len(t_sub) * 1e3:.3f} ms a request (mean; "
              f"max {max(t_sub) * 1e3:.3f}), launches per drain: kernel A "
              f"{counts['mcmc_sweep']}, B {counts['local_field_init']}, C "
              f"{counts['bitplane_field_init']}, D "
              f"{counts['colored_sweep']}; service launches "
              f"{svc.stats['launches']}; store cache {svc.stores.hits} hits "
              f"/ {svc.stores.misses} misses")
        kinds = [out[t].batched for t in tickets]
        check(counts == want[batching]
              and kinds == (labels if batching else ["single"] * len(reqs))
              and svc.stats["launches"] == (4 if batching else len(reqs)),
              f"batching={batching}: lanes {kinds}, launches {counts} (one "
              "stacked K2000 launch, one solve a vmap lane, one stacked "
              "sparse launch and the colored solve when batched; one solve "
              "a request when not)", quiet=len(walls[batching]) > 1)
        serve_launches(counts, (1 if batching else SERVE_SPARSE)
                       * sparse_chunks)
    svc, tickets, out, t_sub, wall, counts = runs[True]
    print(f"[serve] drain wall in turns: batched {walls[True][0]:.4f} / "
          f"{walls[True][1]:.4f} s, unbatched {walls[False][0]:.4f} / "
          f"{walls[False][1]:.4f} s; requests/s batched "
          f"{2 * len(reqs) / sum(walls[True]):.3f}, unbatched "
          f"{2 * len(reqs) / sum(walls[False]):.3f}; kernel A launches "
          f"{want[True]['mcmc_sweep']} / {want[False]['mcmc_sweep']}")

    padded = pad_problem(dense, n_pad)
    serve_kernel_checks(reqs, dense, sparse, padded)

    # The lanes against solo solves on the card.
    for i in range(SERVE_STACKED, SERVE_STACKED + SERVE_PINNED):
        t = tickets[i]
        solo = solve(padded, reqs[i].seed, stacked_cfg)
        got = out[t].result
        check(same_result(got, solo._replace(
            best_spins=solo.best_spins[:, :N]),
            ("best_energy", "best_spins", "final_energy", "num_flips",
             "trace_energy", "rows_fetched")),
            f"vmap lane seed {reqs[i].seed}: bitwise solve(pad_problem("
            f"K2000, {n_pad}), seed) on the card", quiet=i > SERVE_STACKED)
    width = bucket_replicas(SERVE_STACKED * R)
    stack_solo = solve(padded, tickets[0],
                       dataclasses.replace(stacked_cfg, num_replicas=width))
    for i in range(SERVE_STACKED):
        span = slice(i * R, (i + 1) * R)
        got = out[tickets[i]].result
        check(torch.equal(got.best_energy, stack_solo.best_energy[span])
              and torch.equal(got.best_spins,
                              stack_solo.best_spins[span, :N])
              and torch.equal(got.num_flips, stack_solo.num_flips[span])
              and torch.equal(got.final_energy,
                              stack_solo.final_energy[span]),
              f"stacked span {i}: bitwise the solo solve at ticket "
              f"{tickets[0]}, R={width}, sliced", quiet=i > 0)
        check(torch.equal(got.best_energy,
                          ising.energy(dense, got.best_spins)),
              f"span {i}: best_energy == energy of its spins on the "
              "unpadded K2000", quiet=i > 0)
    print(f"  ok: all {SERVE_STACKED} K2000 spans bitwise the solo launch "
          "and exact on the unpadded instance")
    sp_solo = solve(sparse, tickets[SERVE_STACKED + SERVE_PINNED],
                    dataclasses.replace(sparse_cfg,
                                        num_replicas=bucket_replicas(
                                            SERVE_SPARSE * R)))
    for i in range(SERVE_SPARSE):
        t = tickets[SERVE_STACKED + SERVE_PINNED + i]
        got = out[t].result
        span = slice(i * R, (i + 1) * R)
        e = edge_energy(edges, sparse.fields, got.best_spins)
        check(torch.equal(got.best_spins, sp_solo.best_spins[span])
              and torch.equal(got.best_energy.double(), e),
              f"sparse span {i}: bitwise the solo launch, best_energy == "
              "the edge-list energy of its spins exactly")
    col = out[tickets[-1]]
    e = edge_energy(edges, sparse.fields, col.result.best_spins)
    check(torch.equal(col.result.best_energy.double(), e)
          and not col.store_hit,
          f"colored request: single, best cut "
          f"{-float(col.result.best_energy.min()):.0f} (weights -J), "
          "best_energy == the edge-list energy of its spins")
    for batching in (True, False):
        s_out = runs[batching][2]
        cuts = [cut_from_energy(inst, s_out[t].result.best_energy.cpu()
                                .numpy()).max() for t in tickets[:12]]
        print(f"[serve] batching={batching}: K2000 best cut "
              f"{max(cuts):.0f} over the 12 tenants")

    # Submit's cost, the digests' share (medians of 5).
    def median_s(fn):
        return sorted(timed(fn)[1] for _ in range(5))[2]

    t_dig = median_s(lambda: problem_digest(padded))
    t_cdig = median_s(lambda: coupling_digest(padded))
    t_pad = median_s(lambda: pad_problem(dense, n_pad))
    t_k = sorted(t_sub[:SERVE_STACKED + SERVE_PINNED])[
        (SERVE_STACKED + SERVE_PINNED) // 2]
    print(f"[serve] submit of a K2000 request, median of 12: "
          f"{t_k * 1e3:.3f} ms; pad_problem {t_pad * 1e3:.3f} ms, "
          f"problem_digest (the padded J, 16 MB, to the host and sha256) "
          f"{t_dig * 1e3:.3f} ms = {t_dig / t_k:.1%} of it; coupling_digest "
          f"at each store lookup of a plan {t_cdig * 1e3:.3f} ms")

    # The repeat tenant: content-equal fresh arrays on the host.
    encodes = {"n": 0}
    real = coupling.encode_planes

    def counting(*a, **k):
        encodes["n"] += 1
        return real(*a, **k)

    coupling.encode_planes = counting
    try:
        moved = svc.stores.bytes_to_device
        fresh = maxcut_to_ising(complete_bipolar(N, seed=SEED))   # CPU
        reset_all_counts()
        rep = svc.solve(fresh, stacked_cfg, seed=42)
        sp_rep = svc.solve(ising.IsingProblem.create_sparse(
            sparse_bipolar_edges(SPARSE_N, SPARSE_EDGES, seed=SPARSE_N)),
            sparse_cfg, seed=43)
        serve_launches(read_all_counts(), sparse_chunks)
    finally:
        coupling.encode_planes = real
    check(rep.store_hit and sp_rep.store_hit and encodes["n"] == 0
          and svc.stores.bytes_to_device == moved,
          f"repeat tenants (K2000 and sparse, fresh host arrays): store "
          f"hits, {encodes['n']} encodes, no store bytes moved to the card")
    check(torch.equal(rep.result.best_energy,
                      ising.energy(dense, rep.result.best_spins.cuda())),
          "repeat tenant: best_energy == energy of its spins")

    # A met target: no launch at all.
    best = min(float(out[t].result.best_energy.min()) for t in tickets[:12])
    before = svc.stats["launches"]
    reset_all_counts()
    hit = svc.solve(dense, stacked_cfg,
                    budget=BudgetConfig(target_energy=best + 10.0))
    c = read_all_counts()
    check(hit.stop_reason == "cached_target" and hit.warm_hit
          and not any(c.values()) and svc.stats["launches"] == before,
          f"a target the burst met ({best + 10.0:.0f}) is answered from the "
          f"warm cache: no kernel launched ({c})")
    check(torch.equal(hit.result.best_energy,
                      ising.energy(dense, hit.result.best_spins))
          and hit.result.best_spins.dtype == torch.int8
          and hit.result.best_spins.is_cuda,
          "the cached answer: int8 spins on the card scoring its energy")

    # A budgeted request.
    reset_all_counts()
    bud = svc.solve(dense, stacked_cfg, seed=44,
                    budget=BudgetConfig(max_steps=SERVE_STEPS // 2))
    c = read_all_counts()
    check(bud.batched == "budgeted" and bud.stop_reason == "max_steps"
          and c["mcmc_sweep"] == math.ceil(SERVE_STEPS // 2 / T),
          f"budgeted request stops with max_steps after "
          f"{c['mcmc_sweep']} chunks")
    serve_launches(c, 0)
    print(f"[serve] caches: store {svc.stores.hits} hits / "
          f"{svc.stores.misses} misses, warm {svc.warm.hits} hits / "
          f"{svc.warm.misses} misses; stats {svc.stats}")

    print("[profile] torch.profiler over the batched burst's drain (a new "
          "service, the same requests)")
    prof_svc = SolverService(device="cuda")
    for r in reqs:
        prof_svc.submit(r)
    reset_all_counts()
    profile_device(prof_svc.drain)
    serve_launches(read_all_counts(), sparse_chunks)
    serve_anchor_check()


def reset_flash_counts() -> None:
    fa.tc_counter.reset()
    fa.f32_counter.reset()


def flash_launches() -> int:
    return fa.tc_counter.count + fa.f32_counter.count


def attention_flops(b: int, hq: int, s: int, d: int,
                    causal: bool = True) -> int:
    """QKᵀ and P·V of one attention forward, over the kept (row, col)
    pairs: 4·B·Hq·D·S(S+1)/2 when causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * hq * d * pairs


def rel_err(a, b) -> float:
    """max |a − b| / max |b|, in f32 one leading index at a time."""
    num = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    return num / max(float(y.float().abs().max()) for y in b)


def with_flash(replacement, run):
    """Call ``run`` with ``replacement(orig, q, k, v, causal, scale)`` in
    place of ``flash_attention`` (the model imports it at each call)."""
    orig = fa.flash_attention
    fa.flash_attention = (lambda q, k, v, causal, scale, *args:
                          replacement(orig, q, k, v, causal, scale, *args))
    try:
        return run()
    finally:
        fa.flash_attention = orig


def capture_first_attention(run):
    """Call ``run`` and return the q, k and v of its first flash launch."""
    seen = []

    def spy(orig, q, k, v, *args):
        if not seen:
            seen.append((q, k, v))
        return orig(q, k, v, *args)

    with_flash(spy, run)
    return seen[0]


def layer_errors(cfg, params, tokens) -> list:
    """The flash and chunked paths' hidden states after each layer, each
    path on its own outputs: max |x_flash − x_chunked| / max |x_chunked|."""
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    pos = torch.arange(tokens.shape[1], device="cuda")[None].expand(
        tokens.shape)
    xf = xc = lm_model._embed_input(cfg, params, tokens, None)
    errs = []
    with torch.no_grad():
        for g in range(cfg.num_groups):
            gp = lm_model._index(params["groups"], g)["b0"]
            xf = lm_model._apply_block(cfg, "attn:mlp", gp, xf, pos, None,
                                       None)[0]
            xc = lm_model._apply_block(chunked, "attn:mlp", gp, xc, pos, None,
                                       None)[0]
            errs.append(rel_err(xf, xc))
    return errs


def lm_slice() -> list:
    """The LM serving path: qwen2-7b at full width and depth, a 4 x 4,096
    prefill through the flash kernel (28 launches), the chunked path on the
    same inputs, one-token decode, the kernel against its plain version at
    the main path's shapes and others, and the timings. Returns the
    ``kernels`` row of flash_attention."""
    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        print(f"[phase] lm {name} {now - phase_t:.1f} s")
        phase_t = now

    cfg = dataclasses.replace(get_config(LM_ARCH), param_dtype="bfloat16",
                              remat="none", attn_impl="flash")
    specs = model_specs(cfg)
    print(f"[setup] {LM_ARCH}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{cfg.param_count()} parameters, {2 * cfg.param_count()} bytes "
          "in bf16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(specs, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[setup] init_params on the card {time.perf_counter() - t0:.2f} s, "
          f"device memory {torch.cuda.memory_allocated()} bytes")
    tok_np = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))
    tokens = torch.from_numpy(tok_np).to("cuda")
    forward(cfg, params, tokens=tokens[:1, :512])   # warm-up
    phase_done("setup")

    print(f"[main] forward({LM_ARCH}, tokens ({LM_BATCH}, {LM_SEQ})), "
          "attn_impl='flash', bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_flash_counts()
    t0 = time.perf_counter()
    logits = forward(cfg, params, tokens=tokens).logits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.tc_counter.count
    launches_f32 = fa.f32_counter.count
    others = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] prefill {wall * 1e3:.3f} ms, "
          f"{LM_BATCH * LM_SEQ / wall:.1f} tokens/s, peak device memory "
          f"{peak} bytes, launches flash_attention bf16 (tensor cores)="
          f"{launches} f32={launches_f32} (others {others})")
    check(launches == cfg.num_layers,
          f"flash_attention's tensor-core entry launched {cfg.num_layers} "
          "times, once a layer")
    check(launches_f32 == 0, "flash_attention's f32 entry launched 0 times")
    check(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg.vocab_size)
          and logits.dtype == torch.bfloat16,
          f"logits are bf16 of shape ({LM_BATCH}, {LM_SEQ}, {cfg.vocab_size})")
    check(all(bool(torch.isfinite(x).all()) for x in logits),
          "logits are finite")
    phase_done("main")

    print("[profile] torch.profiler over one prefill (the same call)")
    q0, k0, v0 = capture_first_attention(lambda: profile_device(
        lambda: forward(cfg, params, tokens=tokens)))
    phase_done("profile")

    print("[reference] the same forward with attn_impl='chunked' (plain "
          "torch, no kernel)")
    reset_flash_counts()
    chunked_logits = forward(dataclasses.replace(cfg, attn_impl="chunked"),
                             params, tokens=tokens).logits
    check(flash_launches() == 0, "the chunked path launches no kernel")
    err = rel_err(logits, chunked_logits)
    print(f"[reference] flash against chunked logits: max abs err / max "
          f"|logit| = {err:.6f} (max |logit| "
          f"{max(float(x.float().abs().max()) for x in chunked_logits):.4f})"
          f"; {'below' if err < CUDA_CORE_LOGIT_GAP else 'not below'} the "
          f"{CUDA_CORE_LOGIT_GAP} of the f32 CUDA-core kernel on bf16 inputs")
    del chunked_logits
    errs = layer_errors(cfg, params, tokens[:1])
    print("[reference] per layer, hidden state of request 0, max abs err / "
          "max |x|: " + " ".join(f"{e:.5f}" for e in errs))
    check(errs[1] <= BF16_PATH_BOUND, f"hidden-state gap after 2 layers (the "
          f"smoke configs' depth) {errs[1]:.5f} within {BF16_PATH_BOUND}")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    e32 = rel_err(forward(f32, params, tokens=tokens[:1]).logits,
                  forward(dataclasses.replace(f32, attn_impl="chunked"),
                          params, tokens=tokens[:1]).logits)
    check(e32 <= F32_PATH_BOUND, f"in f32 compute, flash and chunked logits "
          f"of request 0 agree at full depth: {e32:.3e} <= {F32_PATH_BOUND}")
    plain_logits = with_flash(
        lambda _, q, k, v, causal, scale, *__: ref.flash_attention(
            q, k, v, causal, scale),
        lambda: forward(cfg, params, tokens=tokens[:1]).logits)
    ekp = rel_err(logits[:1], plain_logits)
    del plain_logits
    bound_l = depth_bound(cfg.num_layers)
    print(f"[reference] request 0, bf16: the kernel's model against the same "
          f"model with the kernel's plain version {ekp:.6f}; full-depth bound "
          f"{bound_l:.4f} = {BF16_PATH_BOUND} x sqrt({cfg.num_layers}/2)")
    check(ekp <= bound_l, "kernel and plain-version models within the "
          "full-depth bf16 bound")
    check(err <= bound_l, f"flash logits within {bound_l:.4f} of max |logit| "
          "of the chunked path's (full-depth bf16 path bound)")
    phase_done("reference")

    print(f"[decode] init_decode_cache(cfg, {LM_BATCH}, max_len={LM_SEQ}); "
          f"{DECODE_PROMPT} prompt tokens one at a time, then {DECODE_NEW} "
          "greedy tokens")
    cache = init_decode_cache(cfg, LM_BATCH, max_len=LM_SEQ)
    cache_bytes = sum(t.numel() * t.element_size() for blk in cache.values()
                      for t in blk["attn"].values())
    reset_flash_counts()
    outs, times = [], []
    nxt = None
    for t in range(DECODE_PROMPT + DECODE_NEW):
        step_tokens = tokens[:, t:t + 1] if t < DECODE_PROMPT else nxt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = decode_step(cfg, params, cache, t, tokens=step_tokens)
        nxt = lg[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if t < DECODE_PROMPT:
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    derr = rel_err(dec, logits[:, :DECODE_PROMPT])
    prompt_ms = sum(times[1:DECODE_PROMPT]) / (DECODE_PROMPT - 1) * 1e3
    greedy_ms = sum(times[DECODE_PROMPT:]) / DECODE_NEW * 1e3
    kv_read = (DECODE_PROMPT + DECODE_NEW / 2) / LM_SEQ * cache_bytes
    decode_bound = (2 * cfg.param_count() + kv_read) / HBM_BYTES_PER_S * 1e3
    print(f"[decode] {prompt_ms:.3f} ms per prompt step, {greedy_ms:.3f} ms "
          f"per greedy step (host clock, batch {LM_BATCH}: "
          f"{LM_BATCH / greedy_ms * 1e3:.1f} tokens/s), byte bound "
          f"{decode_bound:.3f} ms (bf16 weights + the KV cache read, at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); cache {cache_bytes} bytes; "
          f"greedy tokens of request 0: {nxt[0].tolist()} (last)")
    check(flash_launches() == 0, "decode launches no flash_attention")
    check(derr <= bound_l, f"decode logits at positions 0-"
          f"{DECODE_PROMPT - 1} within {bound_l:.4f} of max |logit| of the "
          f"prefill's (got {derr:.6f}; full-depth bf16 path bound)")
    check(bool(torch.isfinite(lg).all()), "greedy decode logits are finite")
    print("[profile] torch.profiler over one more greedy decode step")
    profile_device(lambda: decode_step(cfg, params, cache,
                                       DECODE_PROMPT + DECODE_NEW,
                                       tokens=nxt))
    del cache, dec, outs, lg, logits
    torch.cuda.empty_cache()
    phase_done("decode")

    scale = cfg.resolved_head_dim ** -0.5
    print("[kernels] flash_attention against its plain version")
    errs = {}

    def against_plain(label, q, k, v, causal=True):
        sc = q.shape[-1] ** -0.5
        got = fa.flash_attention(q, k, v, causal, sc, q.shape[2], k.shape[2])
        want = ref.flash_attention(q, k, v, causal, sc)
        torch.cuda.synchronize()
        tol = FLASH_TOL[q.dtype]
        e = max_abs_err([got], [want])
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{label}: max_abs_err {e:.3e} within {tol} ({q.dtype})")
        return e

    errs["main_bf16"] = against_plain(
        f"layer-0 q, k, v of the prefill {tuple(q0.shape)}/{tuple(k0.shape)}",
        q0, k0, v0)
    gen = torch.Generator("cuda").manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    qs, ks = tuple(q0.shape), tuple(k0.shape)
    errs["main_f32"] = against_plain(
        "random f32 at the main path's shapes", rand(qs, torch.float32),
        rand(ks, torch.float32), rand(ks, torch.float32))
    for d in (80, 128, 160, 192):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (rand((2, 8, 512, d), dtype),
                           rand((2, 2, 512, d), dtype),
                           rand((2, 2, 512, d), dtype))
                errs[(d, causal, dtype)] = against_plain(
                    f"(2, 8/2, 512, {d}) causal={causal}", q, k, v, causal)
    for causal in (True, False):
        q, k, v = (rand((1, 7, 333, 128), torch.bfloat16),
                   rand((1, 1, 200, 128), torch.bfloat16),
                   rand((1, 1, 200, 128), torch.bfloat16))
        errs[("ragged", causal)] = against_plain(
            f"ragged (1, 7/1, 333 x 200, 128) causal={causal}", q, k, v,
            causal)
    long_q, long_k, long_v = (rand((1, 28, LM_LONG_SEQ, 128), torch.bfloat16),
                              rand((1, 4, LM_LONG_SEQ, 128), torch.bfloat16),
                              rand((1, 4, LM_LONG_SEQ, 128), torch.bfloat16))
    errs["long"] = against_plain(f"random bf16 (1, 28/4, {LM_LONG_SEQ}, 128)",
                                 long_q, long_k, long_v)
    phase_done("kernels")

    smem = _build.load("flash_attention").flash_attention_bf16_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    print("[build] flash_tc_kernel dynamic shared memory per block: "
          + ", ".join(f"D={d}: {smem(d)} B" for d in (80, 128, 160, 192)))
    print("[timing] CUDA events: the kernel, its plain version and "
          "scaled_dot_product_attention (causal, GQA) on the same inputs")
    timing = {}
    for label, (q, k, v), reps in (("main", (q0, k0, v0), (5, 2, 10)),
                                   ("long", (long_q, long_k, long_v),
                                    (2, 1, 3))):
        b, hq, s, d = q.shape
        flops = attention_flops(b, hq, s, d)
        e = {"ms": cuda_ms(lambda: fa.flash_attention(q, k, v, True, scale,
                                                      s, s), reps[0]),
             "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, True,
                                                             scale), reps[1]),
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, scale=scale, enable_gqa=True),
                 reps[2]),
             # q, k, v in and out once; the flops at the bf16 rate.
             "bound": bound(q.element_size() * (2 * q.numel() + 2 * k.numel()),
                            flops, BF16_FLOP_PER_S),
             "f32_ms": flops / F32_FLOP_PER_S * 1e3}
        timing[label] = e
        print(f"[timing] flash_attention {tuple(q.shape)}/{tuple(k.shape)} "
              f"bf16 causal (tensor cores): {e['ms']:.4f} ms per launch "
              f"({flops / e['ms'] / 1e9:.1f} TFLOP/s, "
              f"{e['bound'][0] / e['ms']:.1%} of the bound), plain "
              f"{e['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{e['library_ms']:.4f} ms (kernel / SDPA "
              f"{e['ms'] / e['library_ms']:.2f}), bound {e['bound'][0]:.4f} ms "
              f"({e['bound'][1]}: {flops} flop at "
              f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16), the f32 "
              f"CUDA-core ceiling {e['f32_ms']:.4f} ms")
        check(e["ms"] < e["f32_ms"], f"{label}: the bf16 kernel beats the "
              f"f32 CUDA-core ceiling ({e['ms']:.4f} < {e['f32_ms']:.4f} ms)")
    phase_done("timing")

    e = timing["main"]
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "launches": launches,
        "max_abs_err": max(errs["main_bf16"], errs["main_f32"]),
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
        "bound_by": e["bound"][1], "library_ms": e["library_ms"]}]


#: [lm-families]: granite-moe and rwkv6 at full width and depth, a 4 x 4,096
#: prefill each (the qwen2-7b run's shape); jamba at its smoke config and
#: one Mamba block at its full width.
MOE_ARCH, RWKV_ARCH, HYBRID_ARCH = ("granite-moe-1b-a400m", "rwkv6-1.6b",
                                    "jamba-1.5-large-398b")
#: The Mamba block at jamba's width: a prefill, the cached prefix it
#: decodes from (a multiple of the 256-step scan chunk) and the CPU check's
#: input length.
MAMBA_SEQ, MAMBA_PREFIX, MAMBA_CPU_SEQ = 1024, 768, 64


def timed_steps(step, count: int) -> tuple:
    """``(outputs, host-clock seconds of each)`` of ``count`` calls of
    ``step(i)``, each synchronised."""
    outs, times = [], []
    for i in range(count):
        out, t = timed(lambda: step(i))
        outs.append(out)
        times.append(t)
    return outs, times


def tree_to(tree: dict, device) -> dict:
    """A parameter dict with every leaf on ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def bf16_model(arch: str):
    """``(cfg, params)``: ``arch`` at full width and depth with bf16
    weights made on the card from a seed, its attention on the kernel."""
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16",
                              remat="none", attn_impl="flash")
    params = init_params(model_specs(cfg),
                         torch.Generator("cuda").manual_seed(SEED))
    print(f"[lm-families] {arch}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, pattern {cfg.block_pattern}, "
          f"{cfg.param_count()} parameters ({2 * cfg.param_count()} bytes in "
          f"bf16), device memory {torch.cuda.memory_allocated()} bytes")
    return cfg, params


def moe_family() -> tuple:
    """granite-moe: the 4 x 4,096 prefill through kernel E at D=64, its MoE
    losses and loads, the chunked path, one-token decode, and E at this
    shape against its plain version and SDPA. Returns (flash launches,
    prefill tokens/s)."""
    from repro_torch.models import moe

    cfg, params = bf16_model(MOE_ARCH)
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).to("cuda")
    forward(cfg, params, tokens=tok[:1, :512])   # warm-up
    reset_flash_counts()
    out, wall = timed(lambda: forward(cfg, params, tokens=tok))
    launches = fa.tc_counter.count
    e, k = cfg.num_experts, cfg.experts_per_token
    c = moe._capacity(cfg, LM_SEQ)
    print(f"[lm-families] {MOE_ARCH} prefill ({LM_BATCH}, {LM_SEQ}): "
          f"{wall * 1e3:.3f} ms, {LM_BATCH * LM_SEQ / wall:.1f} tokens/s; "
          f"flash_attention launches {launches}; aux_loss "
          f"{float(out.aux_loss):.6f}; expert capacity {c} of {LM_SEQ} "
          f"tokens x {k} / {e} experts")
    check(launches == cfg.num_layers and fa.f32_counter.count == 0,
          f"kernel E's tensor-core entry once a layer ({launches})")
    check(float(out.aux_loss) > 0 and out.expert_load.shape == (1, e)
          and bool(torch.allclose(out.expert_load.sum(-1),
                                  torch.ones(1, device="cuda"), atol=1e-5)),
          f"aux_loss > 0, expert_load (1, {e}) sums to 1 per MoE block "
          f"(max load {float(out.expert_load.max()):.4f})")
    check(bool(torch.isfinite(out.logits).all()), "granite logits finite")
    q0, k0, v0 = capture_first_attention(lambda: profile_device(
        lambda: forward(cfg, params, tokens=tok), top=6,
        tag="[lm-families] granite prefill:"))
    chunked = forward(dataclasses.replace(cfg, attn_impl="chunked"), params,
                      tokens=tok).logits
    err, bnd = rel_err(out.logits, chunked), depth_bound(cfg.num_layers)
    del chunked
    check(err <= bnd, f"granite flash against chunked logits {err:.6f} "
          f"within {bnd:.4f} = {BF16_PATH_BOUND} x sqrt({cfg.num_layers}/2)")
    del out

    # One-token decode drops no (token, expert) pair (C = 1 a token), so
    # it is held against a forward whose capacity keeps every pair (C = S),
    # with the chunked attention (decode's own cast points).
    nodrop = dataclasses.replace(cfg, capacity_factor=e / k,
                                 attn_impl="chunked")
    prompt = tok[:, :DECODE_PROMPT]
    ref_logits = forward(nodrop, params, tokens=prompt).logits
    cache = init_decode_cache(cfg, LM_BATCH, DECODE_PROMPT + DECODE_NEW)
    reset_flash_counts()
    nxt = [None]

    def step(t):
        toks = prompt[:, t:t + 1] if t < DECODE_PROMPT else nxt[0]
        lg, _ = decode_step(cfg, params, cache, t, tokens=toks)
        nxt[0] = lg[:, -1].argmax(dim=-1, keepdim=True)
        return lg[:, 0]

    outs, times = timed_steps(step, DECODE_PROMPT + DECODE_NEW)
    derr = rel_err(torch.stack(outs[:DECODE_PROMPT], dim=1), ref_logits)
    greedy_ms = sum(times[DECODE_PROMPT:]) / DECODE_NEW * 1e3
    print(f"[lm-families] {MOE_ARCH} decode at batch {LM_BATCH}: "
          f"{sum(times[1:DECODE_PROMPT]) / (DECODE_PROMPT - 1) * 1e3:.3f} ms "
          f"per prompt step, {greedy_ms:.3f} ms per greedy step; decode "
          f"against the forward {derr:.6f}")
    check(flash_launches() == 0 and derr <= BF16_PATH_BOUND,
          f"granite decode logits within {BF16_PATH_BOUND} of the no-drop "
          f"forward's (got {derr:.6f}); decode launches no kernel E")
    profile_device(lambda: decode_step(cfg, params, cache,
                                       DECODE_PROMPT + DECODE_NEW - 1,
                                       tokens=nxt[0]), top=0,
                   tag="[lm-families] granite decode step:")
    del params, cache, ref_logits, outs
    torch.cuda.empty_cache()

    b, hq, s, d = q0.shape
    sc = d ** -0.5
    got = fa.flash_attention(q0, k0, v0, True, sc, s, s)
    want = ref.flash_attention(q0, k0, v0, True, sc)
    ferr = max_abs_err([got], [want])
    check(torch.allclose(got.float(), want.float(), rtol=FLASH_TOL[q0.dtype],
                         atol=FLASH_TOL[q0.dtype]),
          f"kernel E at granite's layer-0 q, k, v {tuple(q0.shape)}/"
          f"{tuple(k0.shape)}: max_abs_err {ferr:.3e} against its plain "
          "version")
    flops = attention_flops(b, hq, s, d)
    t_k = cuda_ms(lambda: fa.flash_attention(q0, k0, v0, True, sc, s, s), 5)
    t_p = cuda_ms(lambda: ref.flash_attention(q0, k0, v0, True, sc), 2)
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        q0, k0, v0, is_causal=True, scale=sc, enable_gqa=True), 10)
    bnd_ms, by = bound(q0.element_size() * (2 * q0.numel() + 2 * k0.numel()),
                       flops, BF16_FLOP_PER_S)
    print(f"[timing] flash_attention {tuple(q0.shape)}/{tuple(k0.shape)} "
          f"bf16 causal (granite): {t_k:.4f} ms ({bnd_ms / t_k:.1%} of the "
          f"bound), plain {t_p:.4f} ms, scaled_dot_product_attention "
          f"{t_l:.4f} ms (kernel / SDPA {t_k / t_l:.2f}), bound "
          f"{bnd_ms:.4f} ms ({by})")
    return launches, LM_BATCH * LM_SEQ / wall


def rwkv_family() -> None:
    """rwkv6: the 4 x 4,096 prefill (the chunked wkv), the same prefix into
    a decode cache and 16 decode steps (the scan) against the forward over
    the prefix and those tokens, in bf16 and (request 0) in f32 compute."""
    cfg, params = bf16_model(RWKV_ARCH)
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ + DECODE_NEW))).to("cuda")
    forward(cfg, params, tokens=tok[:1, :64])    # warm-up
    out, wall = timed(lambda: forward(cfg, params, tokens=tok[:, :LM_SEQ]))
    check(bool(torch.isfinite(out.logits).all())
          and float(out.aux_loss) == 0.0 and out.expert_load is None,
          "rwkv6 prefill logits finite, no MoE losses")
    del out
    print(f"[lm-families] {RWKV_ARCH} prefill ({LM_BATCH}, {LM_SEQ}): "
          f"{wall * 1e3:.3f} ms, {LM_BATCH * LM_SEQ / wall:.1f} tokens/s")
    profile_device(lambda: forward(cfg, params, tokens=tok[:, :LM_SEQ]),
                   top=6, tag="[lm-families] rwkv6 prefill:")
    full = forward(cfg, params, tokens=tok).logits[:, LM_SEQ:].clone()
    cache = init_decode_cache(cfg, LM_BATCH, 1)
    _, t_pre = timed(lambda: decode_step(cfg, params, cache, 0,
                                         tokens=tok[:, :LM_SEQ]))
    outs, times = timed_steps(lambda i: decode_step(
        cfg, params, cache, LM_SEQ + i,
        tokens=tok[:, LM_SEQ + i:LM_SEQ + i + 1])[0][:, 0], DECODE_NEW)
    derr = rel_err(torch.stack(outs, dim=1), full)
    print(f"[lm-families] {RWKV_ARCH}: the {LM_SEQ}-token prefix into the "
          f"cache {t_pre * 1e3:.3f} ms, then {sum(times) / DECODE_NEW * 1e3:.3f}"
          f" ms per decode step (batch {LM_BATCH}); decode against the "
          f"forward {derr:.6f}")
    # In f32 compute the scan and the chunked wkv differ only by the order
    # of their f32 sums, so request 0's decode is held tight there; in bf16
    # each of the 24 layers adds its own rounding of the two paths' GEMM
    # shapes to the residual stream, hence the depth bound.
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    full32 = forward(f32, params, tokens=tok[:1]).logits[:, LM_SEQ:].clone()
    cache32 = init_decode_cache(f32, 1, 1)
    decode_step(f32, params, cache32, 0, tokens=tok[:1, :LM_SEQ])
    outs32 = [decode_step(f32, params, cache32, LM_SEQ + i,
                          tokens=tok[:1, LM_SEQ + i:LM_SEQ + i + 1])[0][:, 0]
              for i in range(DECODE_NEW)]
    e32 = rel_err(torch.stack(outs32, dim=1), full32)
    del full32, cache32, outs32
    bnd = depth_bound(cfg.num_layers)
    print(f"[lm-families] {RWKV_ARCH} decode against the forward, request 0 "
          f"in f32 compute: {e32:.3e}")
    check(e32 <= F32_PATH_BOUND, f"rwkv6 decode (scan) within "
          f"{F32_PATH_BOUND} of the forward's logits (chunked wkv) in f32 "
          f"compute ({e32:.3e})")
    check(derr <= bnd, f"rwkv6 decode (scan) within {bnd:.4f} = "
          f"{BF16_PATH_BOUND} x sqrt({cfg.num_layers}/2) of the forward's "
          f"logits (chunked wkv) in bf16 ({derr:.6f})")
    profile_device(lambda: decode_step(cfg, params, cache,
                                       LM_SEQ + DECODE_NEW,
                                       tokens=tok[:, -1:]), top=0,
                   tag="[lm-families] rwkv6 decode step:")
    del params, cache, full
    torch.cuda.empty_cache()


def hybrid_family() -> int:
    """jamba: its smoke model on the card against the CPU (forward and
    decode), and one Mamba block at its full width. Returns the smoke
    forward's flash launches."""
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config(HYBRID_ARCH, smoke=True),
                              attn_impl="flash")
    cpu_p = init_params(model_specs(cfg), torch.Generator().manual_seed(SEED),
                        device="cpu")
    card_p = tree_to(cpu_p, "cuda")
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 32)))
    reset_flash_counts()
    card = forward(cfg, card_p, tokens=tok.cuda())
    launches = flash_launches()
    cpu = forward(cfg, cpu_p, tokens=tok)
    bnd = depth_bound(cfg.num_layers)
    err = rel_err(card.logits.cpu(), cpu.logits)
    check(err <= bnd and launches == cfg.num_groups and abs(
        float(card.aux_loss) - float(cpu.aux_loss)) <= 1e-4,
          f"jamba smoke forward: the card within {bnd:.4f} of the CPU "
          f"({err:.6f}), aux_loss {float(card.aux_loss):.6f} / "
          f"{float(cpu.aux_loss):.6f}, kernel E {launches} launches")
    caches = [init_decode_cache(cfg, 2, 16, device=d) for d in ("cuda", "cpu")]
    dec = [[], []]
    for t in range(16):
        for i, (p, dev) in enumerate(((card_p, "cuda"), (cpu_p, "cpu"))):
            lg, _ = decode_step(cfg, p, caches[i], t,
                                tokens=tok[:, t:t + 1].to(dev))
            dec[i].append(lg[:, 0].cpu())
    derr = rel_err(torch.stack(dec[0], 1), torch.stack(dec[1], 1))
    ferr = rel_err(torch.stack(dec[0], 1), card.logits[:, :16].cpu())
    check(derr <= bnd and ferr <= BF16_PATH_BOUND,
          f"jamba smoke decode: the card within {bnd:.4f} of the CPU "
          f"({derr:.6f}), within {BF16_PATH_BOUND} of its forward "
          f"({ferr:.6f})")

    full = dataclasses.replace(get_config(HYBRID_ARCH),
                               param_dtype="bfloat16")
    p = init_params(lm_model._mamba_specs(full),
                    torch.Generator("cuda").manual_seed(SEED))
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    x = torch.randn((1, MAMBA_SEQ, full.d_model), generator=gen,
                    device="cuda").bfloat16()
    (y, _), wall = timed(lambda: ssm.mamba_block(full, p, x))
    cache = ssm.init_cache(full, 1, device="cuda")
    _, cache = ssm.mamba_block(full, p, x[:, :MAMBA_PREFIX], cache=cache)
    state = [cache]

    def step(i):
        t = MAMBA_PREFIX + i
        out, state[0] = ssm.mamba_block(full, p, x[:, t:t + 1],
                                        cache=state[0])
        return out[:, 0]

    outs, times = timed_steps(step, DECODE_NEW)
    derr = rel_err(torch.stack(outs, 1),
                   y[:, MAMBA_PREFIX:MAMBA_PREFIX + DECODE_NEW])
    print(f"[lm-families] {HYBRID_ARCH} mamba_block at full width (d "
          f"{full.d_model}, d_inner {full.d_inner}, state "
          f"{full.ssm_state_dim}, conv {full.ssm_conv_width}, dt_rank "
          f"{full.resolved_dt_rank}, scan chunk {full.ssm_chunk}): prefill "
          f"(1, {MAMBA_SEQ}) {wall * 1e3:.3f} ms, "
          f"{sum(times) / DECODE_NEW * 1e3:.3f} ms per decode step; decode "
          f"from a {MAMBA_PREFIX}-token cached prefix against the prefill "
          f"{derr:.6f}")
    check(bool(torch.isfinite(y).all()) and derr <= BF16_PATH_BOUND,
          f"mamba_block prefill finite; decode within {BF16_PATH_BOUND} of "
          "the prefill")
    profile_device(lambda: ssm.mamba_block(full, p, x), top=4,
                   tag="[lm-families] mamba_block prefill:")
    xs = x[:, :MAMBA_CPU_SEQ]
    card_y, _ = ssm.mamba_block(full, p, xs)
    cpu_y, _ = ssm.mamba_block(full, {k: v.cpu() for k, v in p.items()},
                               xs.cpu())
    cerr = rel_err(card_y.cpu(), cpu_y)
    check(cerr <= BF16_PATH_BOUND, f"mamba_block at full width, "
          f"{MAMBA_CPU_SEQ} tokens: the card within {BF16_PATH_BOUND} of "
          f"the CPU ({cerr:.6f})")
    del p, x, y, cache, state
    torch.cuda.empty_cache()
    return launches


def lm_families_phase() -> int:
    """[lm-families]: the MoE, RWKV and hybrid families on the card.
    Returns kernel E's launches on their main paths."""
    phase_t = time.perf_counter()
    print(f"[lm-families] {nvidia_smi()}")
    launches, _ = moe_family()
    print(f"[phase] lm-families moe {time.perf_counter() - phase_t:.1f} s")
    t0 = time.perf_counter()
    rwkv_family()
    print(f"[phase] lm-families rwkv {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches += hybrid_family()
    print(f"[phase] lm-families hybrid {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    props = torch.cuda.get_device_properties(0)
    print(f"[device] {kind} count={count} nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"L2 {props.L2_cache_size} bytes, {props.multi_processor_count} SMs")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in f32 to the end, as the JAX reference asks.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    print("[build] nvcc, one process per source, in parallel")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall")
    for b in built.values():
        print(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.name}")
        for line in ptxas_summary(b.log):
            print(f"[build]   {line}")

    t0 = time.perf_counter()
    rows = dense_slice()
    print(f"[phase] dense slice (K2000) {time.perf_counter() - t0:.1f} s")
    rows += plane_slice()
    print("[summary] single-flip main paths: host-clock us/step (kernel A's "
          "own in the profiled solve; a one-step solve's fixed cost), "
          "flips/s, best cut, device idle share (profiled solve), launches "
          "per chunk")
    for (fmt, mode), m in MAIN_PATHS.items():
        prof = m["prof"]
        idle = ("not measured" if prof is None
                else f"{1 - prof['busy'] / prof['wall']:.1%}")
        print(f"[summary] {fmt} {mode}: {m['us_step']:.3f} us/step "
              f"(kernel A's own {m['kernel_us']:.3f}; a one-step solve "
              f"{m['fixed_ms']:.3f} ms), {m['flips_s']:.4e} flips/s, best "
              f"cut {m['cut']:.0f}, idle {idle}, {m['per_chunk']:.2f} "
              f"launches per chunk")
    rows += colored_slice()
    for name, phase in (("engine", engine_phase),
                        ("resilient", resilient_phase),
                        ("stat", stat_phase),
                        ("tempering", tempering_phase),
                        ("tts", tts_phase),
                        ("workloads", workloads_phase),
                        ("serve", serve_phase)):
        t0 = time.perf_counter()
        phase()
        print(f"[phase] {name} {time.perf_counter() - t0:.1f} s")
    # Kernel A's, C's, D's and the inits' rows count the launches of the
    # later slices' main paths too (tempering, TTS, the CLI's workloads,
    # the service's drains).
    for row in rows:
        row["launches"] += EXTRA_LAUNCHES.pop(row["name"], 0)
    check(not EXTRA_LAUNCHES, f"every main path's launches land on a "
          f"kernels row (left: {EXTRA_LAUNCHES})")
    rows += lm_slice()
    t0 = time.perf_counter()
    # Kernel E's row counts the MoE and hybrid families' launches too.
    rows[-1]["launches"] += lm_families_phase()
    print(f"[phase] lm-families {time.perf_counter() - t0:.1f} s")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
