"""Kernel D's route on the card (``csrc/colored_sweep_hopper.cu``), against
its plain version (``ref.colored_sweep``) and the earlier kernel
(``csrc/colored_sweep.cu``, forced with ``pr17=True``):

* every cluster width bitwise the plain version, all seven outputs, on the
  three tiers (PWL, integer J), for R = 1, 8, 64 and T = 1, 256, on a 32×32
  torus (χ = 2), sparse N = 2,002 (N not a multiple of 4: the dense tier's
  4-byte copies; W = 63 on ``bitplane``), sparse N = 4,096, the N = 16,384
  anchor and N = 20,000 (a shorter last slice; W = 625 on ``bitplane`` and
  odd slice word counts: the planes' 4-byte copies);
* the keyed (DRAW) kernel bitwise the reading one fed ``rng.uniform01``;
* ``rows_fetched`` as the plain version has it at ``block_r`` 1, 2 and 8;
* the exact sigmoid bitwise the earlier kernel (the same device expf);
* every launch of the wrappers on ``colored_hopper_counter``, none of the
  forced earlier kernel, which still matches the plain version.

Marked ``cuda``; each test skips (inside the ``cuda_device`` fixture)
without a card. The file imports neither JAX nor the JAX package. Run on a
GPU machine with

    PYTHONPATH=src python -m pytest -m cuda \\
        tests/test_torch_colored_hopper_card.py
"""
import dataclasses
import functools

import pytest
import torch

from repro_torch.configs.snowball import default_solver
from repro_torch.core import ising, rng
from repro_torch.core.solver import solve
from repro_torch.graphs import (greedy_coloring, sparse_bipolar_edges,
                                torus_grid_edges)
from repro_torch.kernels import ops, ref, sweep

pytestmark = pytest.mark.cuda

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
TIERS = ("dense", "bitplane", "bitplane_hbm")
GRAPHS = {"torus32": lambda: torus_grid_edges(32, 32, seed=1),
          "n2002": lambda: sparse_bipolar_edges(2002, 8 * 2002, seed=2002),
          "n4096": lambda: sparse_bipolar_edges(4096, 8 * 4096, seed=4096),
          "anchor": lambda: sparse_bipolar_edges(16384, 8 * 16384,
                                                 seed=16384),
          "n20000": lambda: sparse_bipolar_edges(20000, 8 * 20000,
                                                 seed=20000)}
#: The plain version at R=64 over 256 steps runs for minutes at the larger
#: N: those shapes take R=64 at T=1 only.
LARGE = ("anchor", "n20000")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _edges(graph):
    return GRAPHS[graph]()


@functools.lru_cache(maxsize=None)
def _plan(graph, fmt):
    """The colored plan of ``graph`` on tier ``fmt``, on the card; every
    tier of a graph shares one coloring, so one color order."""
    edges = _edges(graph)
    prob = ising.IsingProblem.create_sparse(edges, device="cuda")
    if fmt == "dense":
        prob = ising.IsingProblem(torch.from_numpy(edges.to_dense()).to(
            "cuda"), prob.fields)
    return ops.ColoredPlan(_coloring(graph), prob, fmt).to("cuda")


@functools.lru_cache(maxsize=None)
def _coloring(graph):
    return greedy_coloring(_edges(graph))


@functools.lru_cache(maxsize=None)
def _inputs(graph, r, t, seed=0):
    """The solve's init of ``r`` replicas, the uniforms of chunk 0 of the
    key's stream, temperatures across an anneal of 64·χ steps, the class
    schedule of steps 0..t-1 and the PWL table; one set for every tier."""
    plan = _plan(graph, "bitplane_hbm")
    chi = plan.coloring.num_classes
    cfg = default_solver(plan.problem.num_spins, 64 * chi, mode="rsa")
    tbl = ops.solver_pwl_table(cfg, device="cuda")
    temps = cfg.schedule(torch.linspace(0, 64 * chi - 1, t).to(
        torch.int32)).to("cuda", torch.float32)[:, None].expand(t, r)
    words = rng.words(rng.fold_in(rng.key(0), seed))
    base = rng.from_words(*words).to("cuda")
    u0, s0, e0, *_ = ops.fused_init_state(plan.problem, base, r,
                                          planes=plan.store.planes)
    unif = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, 0),
                         (t, r, plan.window))
    sched = ops.colored_class_schedule(plan.wstarts, plan.offsets, plan.sizes,
                                       torch.arange(t, device="cuda"))
    return (u0, s0, e0, unif, temps.contiguous(), sched), tbl, words


@functools.lru_cache(maxsize=None)
def _want(graph, r, t, block_r=8):
    """The plain version's outputs; the tiers walk one trajectory."""
    args, tbl, _ = _inputs(graph, r, t)
    return ref.colored_sweep(_plan(graph, "bitplane_hbm").store.kernel_operand,
                             *args, tbl, block_r=block_r)


def _differ(a_list, b_list):
    return [name for name, a, b in zip(NAMES, a_list, b_list)
            if not torch.equal(a, b)]


def _widths(graph, fmt, pr17=False):
    plan = _plan(graph, fmt)
    op = plan.store.kernel_operand
    return sweep.colored_widths(plan.problem.num_spins, plan.window, 64,
                                fmt == "dense",
                                1 if fmt == "dense" else op.num_planes,
                                pr17=pr17)


def _at_width(graph, fmt, width, args, tbl, **kw):
    u0, s0, e0, unif, temps, sched = args
    return sweep.colored_sweep_at_width(
        width, _plan(graph, fmt).store.kernel_operand, u0, s0, e0, temps,
        sched, tbl, uniforms=unif, coupling=fmt, **kw)


@pytest.mark.parametrize("t", [1, 256])
@pytest.mark.parametrize("r", [1, 8, 64])
@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_every_width_bitwise_plain(cuda_device, graph, fmt, r, t):
    if graph in LARGE and r == 64 and t > 1:
        pytest.skip("the plain version takes minutes at this shape")
    args, tbl, _ = _inputs(graph, r, t)
    want = _want(graph, r, t)
    widths = _widths(graph, fmt)
    assert widths and widths[-1] == 16 and 8 in widths
    for width in widths:
        got = _at_width(graph, fmt, width, args, tbl)
        assert not _differ(got, want), (width, _differ(got, want))
    if t > 1:
        assert 0 < int(want[6].sum()) <= int(want[5].sum())


@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", ["anchor", "n20000", "n2002"])
def test_draw_equals_read(cuda_device, graph, fmt):
    r, t = 8, 64
    args, tbl, words = _inputs(graph, r, t)
    u0, s0, e0, unif, temps, sched = args
    plan = _plan(graph, fmt)
    op = plan.store.kernel_operand
    read = sweep.colored_sweep(op, *args, tbl, coupling=fmt)
    assert not _differ(read, _want(graph, r, t))
    for width in _widths(graph, fmt):
        drawn = sweep.colored_sweep_at_width(
            width, op, u0, s0, e0, temps, sched, tbl, base_words=words,
            chunk=0, window=plan.window, coupling=fmt)
        assert not _differ(drawn, read), width
    keyed = sweep.colored_sweep_keyed(op, u0, s0, e0, words, 0, temps, sched,
                                      tbl, window=plan.window, coupling=fmt)
    assert not _differ(keyed, read)


@pytest.mark.parametrize("block_r", [1, 2, 8])
@pytest.mark.parametrize("graph", ["anchor", "n20000"])
def test_rows_fetched_equals_plain(cuda_device, graph, block_r):
    r, t = 8, 64
    args, tbl, _ = _inputs(graph, r, t)
    want = _want(graph, r, t, block_r)
    for fmt in ("bitplane_hbm", "bitplane"):
        for width in _widths(graph, fmt):
            got = _at_width(graph, fmt, width, args, tbl, block_r=block_r)
            assert not _differ(got, want), (fmt, width)
    if block_r == 1:
        assert torch.equal(want[6], want[5])
    else:
        assert int(want[6].sum()) < int(want[5].sum())


@pytest.mark.parametrize("fmt", TIERS)
def test_exact_sigmoid_equals_the_earlier_kernel(cuda_device, fmt):
    """Without the PWL table both kernels take the device's expf: the
    route is bitwise the earlier kernel at every width either has."""
    graph, r, t = "n4096", 8, 64
    args, _, _ = _inputs(graph, r, t)
    old = _at_width(graph, fmt, sweep.colored_width(
        4096, _plan(graph, fmt).window, 0, r, fmt == "dense", pr17=True),
        args, None, pr17=True)
    for width in _widths(graph, fmt):
        got = _at_width(graph, fmt, width, args, None)
        assert not _differ(got, old), width
    assert int(old[5].sum()) > 0


def test_counters_and_forced_pr17_route(cuda_device):
    graph, r, t = "anchor", 8, 64
    args, tbl, words = _inputs(graph, r, t)
    u0, s0, e0, unif, temps, sched = args
    want = _want(graph, r, t)
    for c in (sweep.colored_counter, sweep.colored_hopper_counter):
        c.reset()
    for fmt in TIERS:
        plan = _plan(graph, fmt)
        op = plan.store.kernel_operand
        sweep.colored_sweep(op, *args, tbl, coupling=fmt)
        sweep.colored_sweep_keyed(op, u0, s0, e0, words, 0, temps, sched, tbl,
                                  window=plan.window, coupling=fmt)
        for width in _widths(graph, fmt, pr17=True):
            old = _at_width(graph, fmt, width, args, tbl, pr17=True)
            assert not _differ(old, want), (fmt, width)
    forced = sum(len(_widths(graph, fmt, pr17=True)) for fmt in TIERS)
    assert sweep.colored_hopper_counter.count == 6
    assert sweep.colored_counter.count == 6 + forced
    # A colored solve: every launch on the route.
    problem = ising.IsingProblem.create_sparse(
        sparse_bipolar_edges(300, 2400, seed=5))
    cfg = dataclasses.replace(default_solver(300, 600, mode="rsa"),
                              flip_mode="colored", coupling_format="bitplane")
    for c in (sweep.colored_counter, sweep.colored_hopper_counter):
        c.reset()
    on_card = solve(problem, 1, cfg, backend="colored", device=cuda_device)
    assert sweep.colored_hopper_counter.count == sweep.colored_counter.count \
        == 3
    on_cpu = solve(problem, 1, cfg, backend="colored", device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name
    # N = 1024 splits into 9 blocks of whole words only with an empty last
    # block: no such width.
    assert 9 not in _widths("torus32", "bitplane_hbm")
    with pytest.raises(ValueError, match="cluster width"):
        _at_width("torus32", "bitplane_hbm", 9, *_inputs("torus32", r, 4)[:2])
