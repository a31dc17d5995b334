"""Kernel A's RSA route on the card (``csrc/sweep_rsa.cu``), against its
plain version (``ref.mcmc_sweep``):

* RSA + PWL bitwise at every cluster width it runs, on the three tiers, for
  R = 1, 8, 64 and T = 1, 256, 4,096, at N = 2,000, 4,096, 14,481, 16,384
  and 20,011 (the widths walk one trajectory, the tiers one trajectory);
* the keyed (DRAW) kernel bitwise the reading one; a device fold, a
  temperature column per replica and the coalesced ``rows_fetched`` as the
  plain version has them;
* the exact sigmoid split from the plain version only where the accept
  uniform lies within a few ulp of the flip probability;
* every RSA launch of the wrappers on ``rsa_hopper_counter``, none of RWA
  or of the forced earlier route, which still matches its plain version.

Marked ``cuda``; each test skips (inside the ``cuda_device`` fixture)
without a card. The file imports neither JAX nor the JAX package. Run on a
GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sweep_rsa_card.py
"""
import functools
import math

import pytest
import torch

from repro_torch.core import ising, pwl, rng
from repro_torch.core.coupling import CouplingStore
from repro_torch.graphs import sparse_bipolar_edges
from repro_torch.kernels import common, ref, sweep

pytestmark = pytest.mark.cuda

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
TIERS = ("dense", "bitplane", "bitplane_hbm")
SIZES = (2000, 4096, 14481, 16384, 20011)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _edges(n):
    """The sparse G(n, 8n) instance and its dense J on the card."""
    edges = sparse_bipolar_edges(n, 8 * n, seed=n)
    return edges, torch.from_numpy(edges.to_dense()).to("cuda")


@functools.lru_cache(maxsize=None)
def _instance(n, fmt):
    """The instance as the tier's operand, and its dense J."""
    edges, J = _edges(n)
    op = (J if fmt == "dense"
          else CouplingStore.build(edges, fmt).to("cuda").planes)
    return op, J


def _state(J, r, t, seed=0, ladder=False):
    """Random spins, their fields and energies, and temperatures across an
    anneal (or a ladder, a column per replica)."""
    dev = J.device
    n = J.shape[0]
    key = rng.fold_in(rng.key(0, device=dev), seed)
    s0 = ising.random_spins(rng.stream(key, rng.Salt.INIT,
                                       torch.arange(r, device=dev)),
                            (n,)).to(torch.float32)
    u0 = s0 @ J.T
    e0 = -0.5 * (s0 * u0).sum(1)
    if ladder:
        temps = torch.logspace(math.log10(0.05), math.log10(9.0), r,
                               device=dev)[None, :].expand(t, r)
    else:
        temps = torch.linspace(4.0, 0.1, t, device=dev)[:, None].expand(t, r)
    return u0, s0, e0, temps.contiguous()


def _differ(a_list, b_list):
    return [name for name, a, b in zip(NAMES, a_list, b_list)
            if not torch.equal(a, b)]


def _widths(n, fmt, op, segs=64):
    planes = 0 if fmt == "dense" else op.num_planes
    return sweep.widths(n, common.default_lane(n), segs, False,
                        num_planes=planes)


@pytest.mark.parametrize("t", [1, 256, 4096])
@pytest.mark.parametrize("r", [1, 8, 64])
@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("n", SIZES)
def test_rsa_pwl_bitwise_plain_at_every_width(cuda_device, n, fmt, r, t):
    op, J = _instance(n, fmt)
    u0, s0, e0, temps = _state(J, r, t, seed=r)
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), r + t))
    unif = sweep.sweep_uniforms(words, 0, t, r, device=cuda_device)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rsa",
                          coupling=fmt)
    widths = _widths(n, fmt, op)
    assert len(widths) >= 7 and widths[-1] >= 15
    for width in widths:
        got = sweep.mcmc_sweep_at_width(width, op, u0, s0, e0, temps, tbl,
                                        uniforms=unif, mode="rsa",
                                        coupling=fmt)
        assert not _differ(got, want), (width, _differ(got, want))
    assert torch.equal(want[0], want[1] @ J.T)
    if t > 1:
        assert 0 < int(want[5].sum()) < r * t


def test_rsa_tiers_walk_one_trajectory(cuda_device):
    n, r, t = 20011, 8, 256
    tbl = pwl.pwl_table(device=cuda_device)
    runs = []
    for fmt in TIERS:
        op, J = _instance(n, fmt)
        u0, s0, e0, temps = _state(J, r, t)
        runs.append(sweep.mcmc_sweep_keyed(op, u0, s0, e0, (3, 4), 0, temps,
                                           tbl, mode="rsa", coupling=fmt,
                                           coalesce=False))
    for other in runs[1:]:
        assert not _differ(runs[0], other)


@pytest.mark.parametrize("fold", [None, 3])
@pytest.mark.parametrize("fmt", TIERS)
def test_draw_equals_read_with_fold_and_ladder(cuda_device, fmt, fold):
    n, r, t = 14481, 8, 130
    op, J = _instance(n, fmt)
    u0, s0, e0, temps = _state(J, r, t, ladder=True)
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), 11))
    unif = sweep.sweep_uniforms(words, 2, t, r, device=cuda_device,
                                fold=fold)
    kw = dict(mode="rsa", coupling=fmt)
    drawn = sweep.mcmc_sweep_keyed(op, u0, s0, e0, words, 2, temps, tbl,
                                   fold=fold, **kw)
    read = sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    plain = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    assert not _differ(drawn, read)
    assert not _differ(read, plain)


@pytest.mark.parametrize("block_r", [1, 4, 8])
@pytest.mark.parametrize("n", [14481, 20011])
def test_coalesced_rows_fetched_equals_plain(cuda_device, n, block_r):
    r, t = 8, 200
    op, J = _instance(n, "bitplane_hbm")
    u0, s0, e0, temps = _state(J, r, t, seed=6)
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), 9))
    unif = sweep.sweep_uniforms(words, 0, t, r, device=cuda_device)
    # Replicas 0-3 share the state and the uniforms, so their sites too.
    u0[:4], s0[:4], e0[:4] = u0[0], s0[0], e0[0]
    unif[:, :4] = unif[:, :1]
    unif = unif.contiguous()
    kw = dict(mode="rsa", coupling="bitplane_hbm", block_r=block_r)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    for width in _widths(n, "bitplane_hbm", op):
        got = sweep.mcmc_sweep_at_width(width, op, u0, s0, e0, temps, tbl,
                                        uniforms=unif, **kw)
        assert not _differ(got, want), width
    if block_r == 1:
        assert int(want[6].sum()) == r * t
    else:
        assert int(want[6].sum()) < r * t


@pytest.mark.parametrize("fmt,n", [("dense", 2000),
                                   ("bitplane_hbm", 20011)])
def test_exact_sigmoid_splits_only_within_ulps(cuda_device, fmt, n):
    """One RSA step from 512 states with the exact sigmoid: the kernel's
    expf and torch.sigmoid may round p an ulp apart, so a replica may
    split from the plain version only where its accept uniform lies within
    4 ulp of p."""
    r = 512
    op, J = _instance(n, fmt)
    u0, s0, e0, _ = _state(J, r, 1, seed=4)
    temps = torch.linspace(0.1, 3.0 * math.sqrt(n), r,
                           device=cuda_device)[None, :].contiguous()
    words = rng.words(rng.fold_in(rng.key(0), 5))
    unif = sweep.sweep_uniforms(words, 0, 1, r, device=cuda_device)
    kw = dict(mode="rsa", coupling=fmt)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, None, **kw)
    j = common.site_from_uniform(unif[0, :, 0], n)
    rows = torch.arange(r, device=cuda_device)
    p = common.flip_probability(2.0 * s0[rows, j] * u0[rows, j], temps[0],
                                None)
    near = (unif[0, :, 1] - p).abs() <= 4 * torch.finfo(torch.float32).eps
    for width in _widths(n, fmt, op, segs=0):
        got = sweep.mcmc_sweep_at_width(width, op, u0, s0, e0, temps, None,
                                        uniforms=unif, **kw)
        same = torch.ones(r, dtype=torch.bool, device=cuda_device)
        for a, b in zip(got, want):
            same &= (a == b).reshape(r, -1).all(dim=1)
        assert bool((same | near).all()), width
    assert int(near.sum()) <= 0.05 * r


def test_counter_and_forced_pr16_route(cuda_device):
    n, r, t = 2000, 8, 130
    op, J = _instance(n, "dense")
    u0, s0, e0, temps = _state(J, r, t)
    words = rng.words(rng.fold_in(rng.key(0), 5))
    unif = sweep.sweep_uniforms(words, 0, t, r, device=cuda_device)
    tbl = pwl.pwl_table(device=cuda_device)
    for c in (sweep.counter, sweep.rsa_hopper_counter,
              sweep.rwa_hopper_counter):
        c.reset()
    new = sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rsa")
    sweep.mcmc_sweep_keyed(op, u0, s0, e0, words, 0, temps, tbl, mode="rsa")
    sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rwa")
    old = sweep.mcmc_sweep_at_width(8, op, u0, s0, e0, temps, tbl,
                                    uniforms=unif, mode="rsa", pr16=True)
    assert (sweep.counter.count, sweep.rsa_hopper_counter.count,
            sweep.rwa_hopper_counter.count) == (4, 2, 1)
    assert not _differ(old, new)
    with pytest.raises(ValueError, match="cluster width"):
        sweep.mcmc_sweep_at_width(16, op, u0, s0, e0, temps, tbl,
                                  uniforms=unif, mode="rsa", pr16=True)
