"""The CUDA kernels against their plain versions, on the card: the
single-flip sweep on every tier (its device draw of the uniforms, the keyed
and reading variants at every cluster width, the coalesced row count, N
past one block's shared memory) and the colored sweep (the keyed and
reading variants and every cluster width against the plain version, a
shorter last slice, rows_fetched at every group size, N past one block's
shared memory), tempering on the card against the CPU (kernel A with a
temperature column per replica, the round's merge and swap as a CUDA
graph), the two field inits (the popcount init also on random
overlapping plane words, W past the earlier design's shared-memory ceiling
and misaligned words), and the flash-attention forward with the LM serving
path around it.

Marked ``cuda``; each test skips (inside the ``cuda_device`` fixture) when
no card is present. The file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed. Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs.snowball import default_solver
from repro_torch.core import bitplane, ising, pwl, rng
from repro_torch.core.coupling import CouplingStore
from repro_torch.core.solver import solve
from repro_torch.graphs import (complete_bipolar, maxcut_to_ising,
                                sparse_bipolar_edges, torus_grid_edges)
from repro_torch.configs import get_config
from repro_torch.kernels import (bitplane_field, common, local_field, ops,
                                 parity, ref, sweep)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as lm_model
from repro_torch.models.params import init_params

pytestmark = pytest.mark.cuda

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(n, r, t, dev, seed=0):
    problem = maxcut_to_ising(complete_bipolar(n, seed=seed), device=dev)
    key = rng.fold_in(rng.key(0, device=dev), seed)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(r, device=dev)),
                            (n,)).to(torch.float32)
    u0 = ref.local_field_init(s0, problem.couplings, problem.fields)
    e0 = ising.energy(problem, s0)
    unif = rng.uniform01(rng.stream(key, rng.Salt.SWEEP, 0), (t, r, 4))
    sched = default_solver(n, 4 * t).schedule
    temps = sched(torch.arange(t, dtype=torch.int32))
    temps = temps.to(dev)[:, None].expand(t, r).contiguous()
    return problem, (problem.couplings, u0, s0, e0, unif, temps)


@pytest.mark.parametrize("n,r", [(250, 8), (2000, 8), (1000, 13),
                                 # rows not 16-byte aligned (N % 4 != 0)
                                 (250, 1), (250, 33), (1001, 1), (1001, 8),
                                 (1001, 13), (1001, 33), (2000, 33)])
def test_local_field_kernel_bitwise(cuda_device, n, r):
    problem, (J, _, s0, *_rest) = _state(n, r, 1, cuda_device)
    before = local_field.counter.count
    got = local_field.local_field_init(s0, J, problem.fields)
    assert local_field.counter.count == before + 1
    assert torch.equal(got, ref.local_field_init(s0, J, problem.fields))


@pytest.mark.parametrize("n,r", [(1001, 13), (2000, 8)])
def test_local_field_kernel_within_order_bound_for_real_j(cuda_device, n, r):
    """Non-integer J and h: the kernel sums in its own order, within the
    stated bound (``local_field.order_error_bound``) of the exact float64
    product, and so within twice it of the plain version's."""
    g = torch.Generator(device=cuda_device).manual_seed(n + r)
    J = torch.randn((n, n), generator=g, device=cuda_device)
    h = torch.randn((n,), generator=g, device=cuda_device)
    s = torch.where(torch.rand((r, n), generator=g, device=cuda_device) < 0.5,
                    -1.0, 1.0)
    got = local_field.local_field_init(s, J, h)
    exact = s.double() @ J.double().T + h.double()
    lim = local_field.order_error_bound(s, J, h)
    assert bool(((got.double() - exact).abs() <= lim).all())
    want = ref.local_field_init(s, J, h)
    assert bool(((got.double() - want.double()).abs() <= 2 * lim).all())


@pytest.mark.parametrize("n", [250, 2000])
def test_sweep_kernel_rsa_pwl_bitwise(cuda_device, n):
    _, args = _state(n, 8, 256, cuda_device)
    tbl = pwl.pwl_table(device=cuda_device)
    got = sweep.mcmc_sweep(*args, tbl, mode="rsa")
    want = ref.mcmc_sweep(*args, tbl, mode="rsa")
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("uniformized", [False, True])
@pytest.mark.parametrize("use_pwl", [True, False])
def test_sweep_kernel_rwa_one_step_agrees_except_near_ties(
        cuda_device, uniformized, use_pwl):
    n, r = 2000, 512
    problem, (J, u0, s0, e0, unif, _) = _state(n, r, 1, cuda_device, seed=3)
    temps = torch.linspace(0.1, 45.0, r, device=cuda_device)[None, :]
    tbl = pwl.pwl_table(device=cuda_device) if use_pwl else None
    args = (J, u0, s0, e0, unif, temps.contiguous(), tbl)
    got = sweep.mcmc_sweep(*args, mode="rwa", uniformized=uniformized)
    want = ref.mcmc_sweep(*args, mode="rwa", uniformized=uniformized)
    p_all = common.flip_probability(2.0 * s0 * u0, temps[0][:, None], tbl)
    keep = ~parity.roulette_near_tie(p_all, unif[0, :, 2], unif[0, :, 3],
                                     uniformized)
    assert int(keep.sum()) >= 0.9 * r
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a[keep], b[keep]), name


@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_sweep_kernel_invariants(cuda_device, mode):
    problem, args = _state(2000, 8, 256, cuda_device, seed=5)
    u, s, e, be, bs, nf, rf = sweep.mcmc_sweep(
        *args, pwl.pwl_table(device=cuda_device), mode=mode)
    assert torch.equal(u, ref.local_field_init(s, problem.couplings,
                                               problem.fields))
    assert torch.equal(e, ising.energy(problem, s))
    assert torch.equal(be, ising.energy(problem, bs))
    assert int(rf.sum()) == 8 * 256


def test_solve_on_card_equals_cpu(cuda_device):
    problem = maxcut_to_ising(complete_bipolar(250, seed=3))
    cfg = default_solver(250, 1000, mode="rsa")
    sweep.counter.reset()
    on_card = solve(problem, 1, cfg, device=cuda_device)
    assert sweep.counter.count == 4
    on_cpu = solve(problem, 1, cfg, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


def test_sweep_kernel_rejects_bad_input(cuda_device):
    _, (J, u0, s0, e0, unif, temps) = _state(250, 8, 4, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sweep.mcmc_sweep(J, u0, s0.to(torch.int8), e0, unif, temps)
    with pytest.raises(ValueError, match="shape"):
        sweep.mcmc_sweep(J, u0, s0, e0, unif[:, :4].contiguous(), temps)
    with pytest.raises(ValueError, match="on"):
        sweep.mcmc_sweep(J.cpu(), u0, s0, e0, unif, temps)
    # A prime N past one block's budget has no cluster width to split it.
    big = 20_011
    assert sweep.shared_bytes(big, 1, 0, False) > sweep.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="cluster width"):
        z = torch.zeros((1, big), device=cuda_device)
        sweep.mcmc_sweep(torch.zeros((big, big), device=cuda_device), z, z,
                         torch.zeros(1, device=cuda_device),
                         torch.zeros((1, 1, 4), device=cuda_device),
                         torch.ones((1, 1), device=cuda_device), mode="rsa",
                         lane=1)


def _planes(n, fmt, dev, seed=0):
    """The sparse G(n, 8n) ±1 instance's store and its dense J."""
    edges = sparse_bipolar_edges(n, 8 * n, seed=seed)
    store = CouplingStore.build(edges, fmt).to(dev)
    J = torch.from_numpy(edges.to_dense()).to(dev)
    return store.planes, J


@pytest.mark.parametrize("n,r,fmt", [(250, 8, "bitplane"),
                                     (4096, 8, "bitplane_hbm"),
                                     (4096, 1, "bitplane_hbm"),
                                     (4096, 32, "bitplane_hbm"),
                                     (1000, 13, "bitplane")])
def test_bitplane_field_kernel_bitwise(cuda_device, n, r, fmt):
    planes, J = _planes(n, fmt, cuda_device)
    s0 = torch.where(torch.rand((r, n), device=cuda_device) < 0.5, 1.0, -1.0)
    words = bitplane.pack_spins(s0, planes.num_words)
    before = bitplane_field.counter.count
    got = bitplane_field.bitplane_field_init(planes.pos, planes.neg, words)
    assert bitplane_field.counter.count == before + 1
    assert torch.equal(got, ref.bitplane_field_init(planes.pos, planes.neg,
                                                    words))
    assert torch.equal(got, s0 @ J.T)


def _random_words(shape, dev, seed, offset=0):
    """Random int32-held uint32 words; ``offset`` words into a larger
    buffer, so the tensor is contiguous but not 16-byte aligned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    numel = math.prod(shape)
    buf = torch.randint(-2 ** 31, 2 ** 31, (numel + offset,),
                        dtype=torch.int64, generator=g).to(torch.int32)
    return buf.to(dev)[offset:].view(shape)


# (B, rows, W, R, offset): B=3; W=7,265, one word past the earlier design's
# shared-memory ceiling and not a multiple of 4; W=9,552, a colored solve's
# at sweep.colored_max_n(256); words 4 bytes off 16-byte alignment; R past
# 32 (two reads of the planes).
@pytest.mark.parametrize("b,n,w,r,offset", [(3, 512, 128, 8, 0),
                                            (3, 64, 128, 32, 0),
                                            (1, 64, 7265, 8, 0),
                                            (1, 64, 9552, 8, 0),
                                            (3, 64, 9552, 1, 0),
                                            (2, 64, 512, 13, 1),
                                            (1, 100, 96, 40, 0)])
def test_bitplane_field_kernel_bitwise_on_random_words(cuda_device, b, n, w,
                                                       r, offset):
    """pos and neg words drawn independently overlap on about a quarter of
    their bits, which no real plane does; the kernel's select identity does
    not need them disjoint."""
    pos = _random_words((b, n, w), cuda_device, 1, offset)
    neg = _random_words((b, n, w), cuda_device, 2, offset)
    words = _random_words((r, w), cuda_device, 3, offset)
    assert bool(((pos & neg) != 0).float().mean() > 0.9)
    before = bitplane_field.counter.count
    got = bitplane_field.bitplane_field_init(pos, neg, words)
    assert bitplane_field.counter.count == before + 1
    assert torch.equal(got, ref.bitplane_field_init(pos, neg, words))


@pytest.mark.parametrize("fmt,coalesce", [("bitplane", True),
                                          ("bitplane_hbm", True),
                                          ("bitplane_hbm", False)])
@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_plane_sweep_kernel_bitwise_or_near_ties(cuda_device, fmt, coalesce,
                                                 mode):
    n, r, t = 2048, 8, 128
    planes, J = _planes(n, fmt, cuda_device, seed=1)
    key = rng.fold_in(rng.key(0, device=cuda_device), 3)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(r, device=cuda_device)),
                            (n,)).to(torch.float32)
    u0 = ref.local_field_init(s0, J, torch.zeros(n, device=cuda_device))
    e0 = -0.5 * (s0 * u0).sum(1)
    unif = rng.uniform01(rng.stream(key, rng.Salt.SWEEP, 0), (t, r, 4))
    unif[::2, :4, 0] = unif[::2, :1, 0]   # shared sites on even steps
    temps = torch.linspace(6.0, 0.1, t, device=cuda_device)[:, None].expand(
        t, r).contiguous()
    tbl = pwl.pwl_table(device=cuda_device)
    kw = dict(mode=mode, coupling=fmt, coalesce=coalesce)
    got = sweep.mcmc_sweep(planes, u0, s0, e0, unif, temps, tbl, **kw)
    want = ref.mcmc_sweep(planes, u0, s0, e0, unif, temps, tbl, **kw)
    dense = sweep.mcmc_sweep(J, u0, s0, e0, unif, temps, tbl, mode=mode)
    if mode == "rsa":
        for name, a, b in zip(NAMES, got, want):
            assert torch.equal(a, b), name
    for name, a, b in zip(NAMES[:6], got, dense):
        assert torch.equal(a, b), name
    assert torch.equal(got[0], got[1] @ J.T)
    if coalesce and fmt == "bitplane_hbm":
        # RSA sites come from the site uniforms, so the shared ones coalesce.
        assert int(got[6].sum()) < r * t if mode == "rsa" else \
            int(got[6].sum()) <= r * t
    else:
        assert int(got[6].sum()) == r * t


def test_plane_solve_on_card_equals_cpu_and_dense(cuda_device):
    edges = sparse_bipolar_edges(300, 2400, seed=5)
    problem = ising.IsingProblem.create_sparse(edges)
    dense = ising.IsingProblem.create(edges.to_dense())
    cfg = default_solver(300, 1024, mode="rsa")
    for fmt in ("bitplane", "bitplane_hbm"):
        c = dataclasses.replace(cfg, coupling_format=fmt)
        sweep.counter.reset()
        bitplane_field.counter.reset()
        on_card = solve(problem, 1, c, device=cuda_device)
        assert sweep.counter.count == 4 and bitplane_field.counter.count == 1
        on_cpu = solve(problem, 1, c, device="cpu")
        via_dense = solve(dense, 1, dataclasses.replace(
            cfg, coupling_format="dense"), device=cuda_device)
        for name, a, b, d in zip(on_card._fields, on_card, on_cpu, via_dense):
            assert torch.equal(a.cpu(), b), (fmt, name)
            if name != "rows_fetched":
                assert torch.equal(a, d), (fmt, name)
    # The coalescing group is no longer a cluster: 16 replicas may share it.
    c16 = dataclasses.replace(cfg, coupling_format="bitplane_hbm",
                              num_replicas=16)
    on_card = ops.fused_anneal(problem, 1, c16, block_r=16,
                               device=cuda_device)
    on_cpu = ops.fused_anneal(problem, 1, c16, block_r=16, device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), ("block_r=16", name)


@pytest.mark.parametrize("seed,chunk,t", [(0, 0, 256), (3, 1, 100),
                                          (2**31 + 5, 78, 17),
                                          (2**32 - 1, 1000, 130)])
def test_sweep_uniforms_kernel_bitwise(cuda_device, seed, chunk, t):
    """The keyed sweep's device draw equals ``rng.uniform01`` of the chunk's
    stream bitwise."""
    base = rng.fold_in(rng.key(0), seed)
    words = rng.words(base)
    before = sweep.uniforms_counter.count
    got = sweep.sweep_uniforms(words, chunk, t, 8, device=cuda_device)
    assert sweep.uniforms_counter.count == before + 1
    want = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, chunk), (t, 8, 4))
    assert torch.equal(got.cpu(), want)


def _width_operands(n, fmt, r, t, dev, seed=0):
    """A store of the sparse G(n, 8n) instance (or its dense J), a state
    on it and temperatures across an anneal."""
    edges = sparse_bipolar_edges(n, 8 * n, seed=seed)
    J = torch.from_numpy(edges.to_dense()).to(dev)
    op = (J if fmt == "dense"
          else CouplingStore.build(edges, fmt).to(dev).planes)
    key = rng.fold_in(rng.key(0, device=dev), seed)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(r, device=dev)),
                            (n,)).to(torch.float32)
    u0 = s0 @ J.T
    e0 = -0.5 * (s0 * u0).sum(1)
    temps = torch.linspace(4.0, 0.1, t, device=dev)[:, None].expand(
        t, r).contiguous()
    return op, J, (u0, s0, e0, temps)


WIDTH_MODES = {"rsa": dict(mode="rsa", pwl=True, uniformized=False),
               "rsa_exact": dict(mode="rsa", pwl=False, uniformized=False),
               "rwa": dict(mode="rwa", pwl=True, uniformized=False),
               "rwa_uniformized": dict(mode="rwa", pwl=True,
                                       uniformized=True),
               "rwa_exact": dict(mode="rwa", pwl=False, uniformized=False)}


@pytest.mark.parametrize("fmt,n", [("dense", 2000), ("bitplane", 4096),
                                   ("bitplane_hbm", 16384)])
@pytest.mark.parametrize("variant", sorted(WIDTH_MODES))
def test_draw_kernel_equals_read_kernel_at_every_width(cuda_device, fmt, n,
                                                       variant):
    """The keyed (DRAW) kernel equals the read kernel fed the drawn tensor
    bitwise, at every cluster width; RSA + PWL also equals the plain
    version, and every width walks one trajectory."""
    v = WIDTH_MODES[variant]
    r, t = 8, 130
    op, J, (u0, s0, e0, temps) = _width_operands(n, fmt, r, t, cuda_device)
    tbl = pwl.pwl_table(device=cuda_device) if v["pwl"] else None
    words = rng.words(rng.fold_in(rng.key(0), 11))
    unif = sweep.sweep_uniforms(words, 3, t, r, device=cuda_device)
    kw = dict(mode=v["mode"], uniformized=v["uniformized"], coupling=fmt)
    lane = common.default_lane(n)
    runs = {}
    for width in sweep.widths(n, lane, 64 if v["pwl"] else 0,
                              v["mode"] == "rwa"):
        got = sweep.mcmc_sweep_at_width(width, op, u0, s0, e0, temps, tbl,
                                        base_words=words, chunk=3, **kw)
        read = sweep.mcmc_sweep_at_width(width, op, u0, s0, e0, temps, tbl,
                                         uniforms=unif, **kw)
        for name, a, b in zip(NAMES, got, read):
            assert torch.equal(a, b), (width, name)
        assert torch.equal(got[0], got[1] @ J.T), width
        runs[width] = got
    if v["mode"] == "rsa":
        want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
        for width, got in runs.items():
            if v["pwl"]:
                for name, a, b in zip(NAMES, got, want):
                    assert torch.equal(a, b), (width, name)
            for name, a, b in zip(NAMES, got, runs[1]):
                assert torch.equal(a, b), (width, name)


@pytest.mark.parametrize("fmt,n", [("dense", 2000), ("bitplane", 4096),
                                   ("bitplane_hbm", 16384)])
def test_rsa_pwl_solve_on_card_equals_cpu(cuda_device, fmt, n):
    """An RSA + PWL solve at the rule's width, sparse ±1 J, equals the CPU
    plain solve bitwise (the keyed path: the card draws its uniforms)."""
    edges = sparse_bipolar_edges(n, 8 * n, seed=n)
    problem = (ising.IsingProblem.create(edges.to_dense()) if fmt == "dense"
               else ising.IsingProblem.create_sparse(edges))
    cfg = dataclasses.replace(default_solver(n, 600, mode="rsa"),
                              coupling_format=fmt, trace_every=200)
    sweep.counter.reset()
    on_card = solve(problem, 2, cfg, device=cuda_device)
    assert sweep.counter.count == 3
    on_cpu = solve(problem, 2, cfg, device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("n", [2000, 16384])
def test_rwa_one_step_splits_only_at_near_ties(cuda_device, n):
    """One RWA + PWL step from 512 states at the rule's width: every state
    the kernel and the plain version disagree on is a near tie."""
    r = 512
    fmt = "dense" if n == 2000 else "bitplane_hbm"
    op, J, (u0, s0, e0, _) = _width_operands(n, fmt, r, 1, cuda_device,
                                             seed=4)
    temps = torch.linspace(0.1, 3.0 * math.sqrt(n), r,
                           device=cuda_device)[None, :].contiguous()
    words = rng.words(rng.fold_in(rng.key(0), 5))
    unif = sweep.sweep_uniforms(words, 0, 1, r, device=cuda_device)
    tbl = pwl.pwl_table(device=cuda_device)
    kw = dict(mode="rwa", coupling=fmt)
    got = sweep.mcmc_sweep_keyed(op, u0, s0, e0, words, 0, temps, tbl, **kw)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    p_all = common.flip_probability(2.0 * s0 * u0, temps[0][:, None], tbl)
    tie = parity.roulette_near_tie(p_all, unif[0, :, 2], unif[0, :, 3],
                                   False)
    same = torch.ones(r, dtype=torch.bool, device=cuda_device)
    for a, b in zip(got, want):
        same &= (a == b).reshape(r, -1).all(dim=1)
    assert bool((same | tie).all())
    assert int(tie.sum()) <= 0.35 * r


@pytest.mark.parametrize("block_r", [1, 4, 8])
@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_coalesced_rows_fetched_equals_plain(cuda_device, block_r, mode):
    """The last cluster of each group counts its unique rows per step: the
    plain version's count, for every group size."""
    n, r, t = 4096, 8, 200
    op, _, (u0, s0, e0, temps) = _width_operands(n, "bitplane_hbm", r, t,
                                                 cuda_device, seed=6)
    words = rng.words(rng.fold_in(rng.key(0), 9))
    unif = sweep.sweep_uniforms(words, 0, t, r, device=cuda_device)
    unif[::2, :4, 0] = unif[::2, :1, 0]   # shared sites on even steps
    unif = unif.contiguous()
    tbl = pwl.pwl_table(device=cuda_device)
    kw = dict(mode=mode, coupling="bitplane_hbm", block_r=block_r)
    got = sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    plain = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    if mode == "rsa":
        for name, a, b in zip(NAMES, got, plain):
            assert torch.equal(a, b), name
    else:
        # RWA sites come from the state: count the kernel's own sites.
        assert int(got[6].sum()) <= r * t
    if block_r == 1:
        assert int(got[6].sum()) == r * t
    elif mode == "rsa":
        assert int(got[6].sum()) < r * t


def test_sparse_past_one_block_ceiling_equals_plain(cuda_device):
    """A sparse N=32768 bitplane_hbm RSA + PWL solve (past the old 19,370
    spins of one block) runs on a two-block cluster and equals the CPU."""
    n = 32768
    problem = ising.IsingProblem.create_sparse(
        sparse_bipolar_edges(n, 8 * n, seed=n))
    cfg = dataclasses.replace(default_solver(n, 300, mode="rsa"),
                              coupling_format="bitplane_hbm")
    assert sweep.cluster_width(n, common.default_lane(n), 64, False) > 1
    on_card = solve(problem, 0, cfg, device=cuda_device)
    on_cpu = solve(problem, 0, cfg, device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name


def _colored_operands(edges, fmt, r, t, dev, seed=0, hi=2.5):
    """A colored plan on the card and a consistent state, uniforms over its
    window, temperatures and the class schedule."""
    n = edges.num_spins
    if fmt == "dense":
        problem = ising.IsingProblem.create(edges.to_dense())
    else:
        problem = ising.IsingProblem.create_sparse(edges)
    plan = ops.colored_plan(problem, fmt).to(dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    s0 = torch.where(torch.rand((r, n), generator=g) < 0.5, 1.0, -1.0).to(dev)
    J = torch.from_numpy(plan.problem.edges.to_dense() if fmt != "dense"
                         else plan.problem.couplings.cpu().numpy()).to(dev)
    u0 = ref.local_field_init(s0, J, torch.zeros(n, device=dev))
    e0 = -0.5 * (s0 * u0).sum(1)
    unif = torch.rand((t, r, plan.window), generator=g).to(dev)
    temps = torch.logspace(math.log10(hi), math.log10(0.05), t)[:, None]
    temps = temps.expand(t, r).contiguous().to(dev)
    sched = ops.colored_class_schedule(plan.wstarts, plan.offsets, plan.sizes,
                                       torch.arange(t, device=dev))
    return plan, J, (u0, s0, e0, unif, temps, sched)


@pytest.mark.parametrize("fmt", ["dense", "bitplane", "bitplane_hbm"])
@pytest.mark.parametrize("graph", ["torus", "sparse"])
@pytest.mark.parametrize("use_pwl", [True, False])
def test_colored_kernel_bitwise(cuda_device, fmt, graph, use_pwl):
    edges = (torus_grid_edges(32, 32, seed=1) if graph == "torus"
             else sparse_bipolar_edges(2048, 8 * 2048, seed=2))
    plan, J, args = _colored_operands(edges, fmt, 8, 64, cuda_device)
    tbl = pwl.pwl_table(device=cuda_device) if use_pwl else None
    before = sweep.colored_counter.count
    got = sweep.colored_sweep(plan.store.kernel_operand, *args, tbl,
                              coupling=fmt)
    assert sweep.colored_counter.count == before + 1
    want = ref.colored_sweep(plan.store.kernel_operand, *args, tbl)
    if use_pwl:
        for name, a, b in zip(NAMES, got, want):
            assert torch.equal(a, b), name
    u, s, e, be, bs, nf, rf = got
    assert torch.equal(u, s @ J.T)                 # h = 0
    assert torch.equal(e, -0.5 * (s * u).sum(1))
    assert int(nf.sum()) > 0 and bool((rf <= nf).all())


@pytest.mark.parametrize("block_r", [1, 2, 4, 8])
def test_colored_rows_fetched_per_cluster(cuda_device, block_r):
    """The kernel's count of rows_fetched (the last cluster of each rows
    group counts it) equals the plain per-group count at every shape,
    whether a group spans several clusters or a cluster several groups;
    with block_r=1 every replica counts its own accepts."""
    edges = sparse_bipolar_edges(4096, 8 * 4096, seed=3)
    plan, _, args = _colored_operands(edges, "bitplane_hbm", 8, 96,
                                      cuda_device, seed=1, hi=6.0)
    tbl = pwl.pwl_table(device=cuda_device)
    got = sweep.colored_sweep(plan.store.kernel_operand, *args, tbl,
                              coupling="bitplane_hbm", block_r=block_r)
    want = ref.colored_sweep(plan.store.kernel_operand, *args, tbl,
                             block_r=block_r)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name
    u0, s0, e0, unif, temps, sched = args
    for width in sweep.colored_widths(4096, plan.window, 64):
        at = sweep.colored_sweep_at_width(
            width, plan.store.kernel_operand, u0, s0, e0, temps, sched, tbl,
            uniforms=unif, coupling="bitplane_hbm", block_r=block_r)
        for name, a, b in zip(NAMES, at, want):
            assert torch.equal(a, b), (width, name)
    if block_r == 1:
        assert torch.equal(got[6], got[5])
    else:
        assert int(got[6].sum()) < int(got[5].sum())


def test_colored_solve_on_card_equals_cpu(cuda_device):
    problem = ising.IsingProblem.create_sparse(
        sparse_bipolar_edges(300, 2400, seed=5))
    cfg = dataclasses.replace(default_solver(300, 600, mode="rsa"),
                              flip_mode="colored", coupling_format="bitplane")
    sweep.colored_counter.reset()
    on_card = solve(problem, 1, cfg, backend="colored", device=cuda_device)
    assert sweep.colored_counter.count == 3
    on_cpu = solve(problem, 1, cfg, backend="colored", device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name
    # A rows group is no longer a cluster: 16 replicas may share one.
    c16 = dataclasses.replace(cfg, num_replicas=16)
    on_card = ops.colored_anneal(problem, 1, c16, block_r=16,
                                 device=cuda_device)
    on_cpu = ops.colored_anneal(problem, 1, c16, block_r=16, device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), ("block_r=16", name)


@pytest.mark.parametrize("fmt", ["dense", "bitplane", "bitplane_hbm"])
@pytest.mark.parametrize("graph", ["torus", "sparse", "uneven"])
def test_colored_keyed_equals_read_and_every_width_equals_plain(
        cuda_device, fmt, graph):
    """The keyed kernel (drawing its uniforms) equals the reading one fed
    ``rng.uniform01`` of the chunk's stream, bitwise; every cluster width
    equals the plain version bitwise (PWL, integer J), also at N=2000,
    which no width splits into equal whole words."""
    edges = {"torus": lambda: torus_grid_edges(32, 32, seed=1),
             "sparse": lambda: sparse_bipolar_edges(2048, 8 * 2048, seed=2),
             "uneven": lambda: sparse_bipolar_edges(2000, 8 * 2000,
                                                    seed=5)}[graph]()
    r, t = 8, 48
    plan, _, (u0, s0, e0, _, temps, sched) = _colored_operands(
        edges, fmt, r, t, cuda_device)
    n, win = edges.num_spins, plan.window
    op = plan.store.kernel_operand
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), 13))
    unif = rng.uniform01(rng.stream(rng.from_words(*words), rng.Salt.SWEEP,
                                    5), (t, r, win)).to(cuda_device)
    keyed = sweep.colored_sweep_keyed(op, u0, s0, e0, words, 5, temps, sched,
                                      tbl, window=win, coupling=fmt)
    read = sweep.colored_sweep(op, u0, s0, e0, unif, temps, sched, tbl,
                               coupling=fmt)
    for name, a, b in zip(NAMES, keyed, read):
        assert torch.equal(a, b), name
    want = ref.colored_sweep(op, u0, s0, e0, unif, temps, sched, tbl)
    widths = sweep.colored_widths(n, win, 64, fmt == "dense")
    assert sweep.colored_width(n, win, 64, r, fmt == "dense") in widths
    if graph == "uneven" and fmt != "dense":
        assert widths[-1] == 16
    for width in widths:
        got = sweep.colored_sweep_at_width(width, op, u0, s0, e0, temps,
                                           sched, tbl, base_words=words,
                                           chunk=5, window=win, coupling=fmt)
        for name, a, b in zip(NAMES, got, want):
            assert torch.equal(a, b), (width, name)


def test_colored_sparse_past_one_block_ceiling_equals_cpu(cuda_device):
    """A sparse N=32768 bitplane_hbm colored solve (past the ~18.8k spins
    one block held) runs on a cluster and equals the CPU's solve."""
    n = 32768
    problem = ising.IsingProblem.create_sparse(
        sparse_bipolar_edges(n, 8 * n, seed=n))
    plan = ops.colored_plan(problem, "bitplane_hbm")
    assert 1 not in sweep.colored_widths(n, plan.window, 64)
    cfg = dataclasses.replace(default_solver(n, 40, mode="rsa"),
                              flip_mode="colored",
                              coupling_format="bitplane_hbm")
    on_card = ops.colored_anneal(problem, 3, cfg, chunk_steps=16, plan=plan,
                                 device=cuda_device)
    on_cpu = ops.colored_anneal(problem, 3, cfg, chunk_steps=16, plan=plan,
                                device="cpu")
    for name, a, b in zip(on_card._fields, on_card, on_cpu):
        assert torch.equal(a.cpu(), b), name


def _qkv(shape_q, shape_kv, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(sh, generator=g, device=dev).to(dtype)
            for sh in (shape_q, shape_kv, shape_kv)]


#: f32: the plain version sums the same products in another order (2e-5,
#: JAX's own flash-against-chunked bound); bf16: one bf16 ulp of |out| ≤ 2
#: (2^-7), where the two f32 results round apart (2e-2, JAX's bf16 bound).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("fmt,mode", [("dense", "rsa"), ("bitplane", "rsa"),
                                      ("bitplane_hbm", "rwa")])
def test_tempering_on_card_equals_cpu(cuda_device, fmt, mode):
    """Tempering on the card (kernel A with the ladder as its per-replica
    table, the merge and swap replayed as a CUDA graph) equals the CPU's
    op-by-op run bitwise, also when a fresh runner continues a state the
    first one returned mid-run (RWA: the plain roulette may split at a
    near tie; these inputs have none)."""
    from repro_torch.core.tempering import (TemperingConfig,
                                            TemperingRunner,
                                            solve_tempering)

    problem = maxcut_to_ising(complete_bipolar(96, seed=3))
    cfg = TemperingConfig(num_steps=600, t_min=0.05, t_max=9.8,
                          num_replicas=8, swap_every=10, mode=mode,
                          backend="fused", coupling_format=fmt)
    cpu = solve_tempering(problem, 5, cfg, device="cpu")
    card = solve_tempering(problem, 5, cfg, device=cuda_device)
    for name, want, got in zip(cpu._fields, cpu, card):
        assert torch.equal(got.cpu(), want), name
    first = TemperingRunner(problem, 5, cfg, device=cuda_device)
    state = first.init()
    for k in range(30):
        state = first.run_chunk(state, k)
    second = TemperingRunner(problem, 5, cfg, device=cuda_device)
    for k in range(30, second.total_units):
        state = second.run_chunk(state, k)
    for name, want, got in zip(cpu._fields, cpu,
                               second.finalize(state, [])):
        assert torch.equal(got.cpu(), want), f"resumed {name}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 6, 2, 256, 256, 64),
    (1, 4, 4, 128, 128, 32),     # MHA
    (2, 8, 1, 128, 128, 64),     # MQA
    (1, 2, 2, 192, 192, 16),     # non-power-of-two seq
    (1, 28, 4, 256, 256, 128),   # qwen2-7b's heads
    (1, 4, 2, 160, 96, 80),      # ragged rows and keys, Sq > Skv
    (1, 6, 3, 100, 200, 160),    # Sq < Skv
    (1, 4, 1, 64, 64, 192),
    (1, 2, 1, 70, 70, 256),
    (1, 8, 2, 200, 200, 192),    # nemotron's head dim, GQA
    (2, 28, 4, 200, 200, 128),   # rep = 7, Sq no multiple of 128
])
def test_flash_kernel_matches_plain(cuda_device, b, hq, hkv, sq, skv, d,
                                    causal, dtype):
    q, k, v = _qkv((b, hq, sq, d), (b, hkv, skv, d), dtype, cuda_device)
    # bf16 goes to the tensor-core entry, f32 to the CUDA-core one.
    mine, other = ((fa.tc_counter, fa.f32_counter) if dtype == torch.bfloat16
                   else (fa.f32_counter, fa.tc_counter))
    before = (mine.count, other.count)
    got = fa.flash_attention(q, k, v, causal, d ** -0.5, sq, skv)
    assert (mine.count, other.count) == (before[0] + 1, before[1])
    want = ref.flash_attention(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _qkv((1, 4, 64, 24), (1, 2, 64, 24), torch.float32, cuda_device)
    before = (fa.tc_counter.count, fa.f32_counter.count)
    with pytest.raises(ValueError, match="head dim 24"):
        fa.flash_attention(q, k, v, True, 0.2)
    # Each entry's own check refuses the launch as well (no silent run).
    out = torch.empty_like(q)
    for entry, _ in fa.ENTRIES.values():
        rc = fa._fn(entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), 1, 4, 2, 64, 64, 24, 0.2, 1,
                           torch.cuda.current_stream().cuda_stream)
        assert rc != 0, entry
    q, k, v = _qkv((1, 4, 64, 32), (1, 2, 64, 32), torch.float16, cuda_device)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q, k, v, True, 0.2)
    q, k, v = _qkv((1, 4, 64, 32), (1, 2, 64, 32), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                           v, True, 0.2)
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, v, True, 0.2, 48, 48)
    qb = torch.empty(4 * 64 * 32 + 1, dtype=torch.bfloat16,
                     device=cuda_device)[1:].view(1, 4, 64, 32)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(qb, k.bfloat16(), v.bfloat16(), True, 0.2)
    assert (fa.tc_counter.count, fa.f32_counter.count) == before


def test_lm_serving_path_on_card(cuda_device):
    """qwen2-7b smoke on the card: the bf16 flash forward launches the
    tensor-core kernel once a layer (the f32 one never) and agrees with the
    chunked path and with the CPU's flash forward, and decode reproduces
    the forward (bf16; 0.03 of max |logit|, the bound
    tests/test_arch_smoke.py uses for bf16 path differences)."""
    import dataclasses as dc
    cfg = dc.replace(get_config("qwen2-7b", smoke=True), attn_impl="flash")
    params = init_params(lm_model.model_specs(cfg),
                         torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                         device=cuda_device)
    fa.tc_counter.reset()
    fa.f32_counter.reset()
    flash = lm_model.forward(cfg, params, tokens=toks).logits.float()
    assert fa.tc_counter.count == cfg.num_layers
    assert fa.f32_counter.count == 0
    chunked = lm_model.forward(dc.replace(cfg, attn_impl="chunked"), params,
                               tokens=toks).logits.float()
    cpu = lm_model.forward(cfg, _to_cpu(params),
                           tokens=toks.cpu()).logits.float()
    scale = float(flash.abs().max())
    assert float((flash - chunked).abs().max()) / scale < 0.03
    assert float((flash.cpu() - cpu).abs().max()) / scale < 0.03
    cache = lm_model.init_decode_cache(cfg, 2, 64, device=cuda_device)
    outs = []
    for t in range(64):
        lg, cache = lm_model.decode_step(cfg, params, cache, t,
                                         tokens=toks[:, t:t + 1])
        outs.append(lg[:, 0].float())
    dec = torch.stack(outs, dim=1)
    assert float((flash - dec).abs().max()) / scale < 0.03


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_family_smoke_models_on_card_equal_cpu(cuda_device, arch):
    """The MoE, RWKV and hybrid smoke models on the card: logits, MoE
    losses and loads against the CPU's, and decode against the forward."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="flash")
    params = init_params(lm_model.model_specs(cfg),
                         torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                         device=cuda_device)
    card = lm_model.forward(cfg, params, tokens=toks)
    cpu = lm_model.forward(cfg, _to_cpu(params), tokens=toks.cpu())
    flash = card.logits.float()
    scale = float(flash.abs().max())
    assert float((flash.cpu() - cpu.logits.float()).abs().max()) / scale < 0.03
    assert abs(float(card.aux_loss) - float(cpu.aux_loss)) < 1e-4
    if cfg.num_experts:
        torch.testing.assert_close(card.expert_load.cpu(), cpu.expert_load)
    cache = lm_model.init_decode_cache(cfg, 2, 16, device=cuda_device)
    outs = []
    for t in range(16):
        lg, cache = lm_model.decode_step(cfg, params, cache, t,
                                         tokens=toks[:, t:t + 1])
        outs.append(lg[:, 0].float())
    assert float((flash - torch.stack(outs, dim=1)).abs().max()) / scale < 0.03


def test_store_cache_moves_a_cpu_store_to_the_card_once(cuda_device):
    """The service's store cache: a CPU problem's store is moved to the
    card once; a hit hands back the same device tensors and moves
    nothing."""
    from repro_torch.serve import LRUStoreCache

    problem = maxcut_to_ising(complete_bipolar(64, seed=1))      # CPU
    cache = LRUStoreCache(capacity=2, device=cuda_device)
    store, hit = cache.get_or_build(problem, "bitplane")
    assert not hit and store.planes.pos.is_cuda
    assert cache.bytes_to_device == store.nbytes
    again, hit = cache.get_or_build(
        maxcut_to_ising(complete_bipolar(64, seed=1)), "bitplane")
    assert hit and again is store and cache.bytes_to_device == store.nbytes
