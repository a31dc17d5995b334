"""Kernel A's RWA route on the card (``csrc/sweep_rwa.cu``), against its
plain version (``ref.mcmc_sweep`` with ``common.roulette_pick_tree``):

* RWA + PWL bitwise at every cluster width it runs, on the three tiers,
  for R = 1, 8, 64 and T = 1, 256, 4,096 (the widths walk one
  trajectory, the tiers one trajectory);
* the exact sigmoid (and its uniformized form) split from the plain
  version only at near ties;
* the keyed (DRAW) kernel bitwise the reading one; a device fold, a
  temperature column per replica and the coalesced ``rows_fetched`` as
  the plain version has them;
* every RWA launch of the wrappers on ``rwa_hopper_counter``, none of RSA
  or of the forced PR 16 route, which still matches its plain version
  except near ties.

Marked ``cuda``; each test skips (inside the ``cuda_device`` fixture)
without a card. The file imports neither JAX nor the JAX package. Run on a
GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sweep_rwa_card.py
"""
import math

import pytest
import torch

from repro_torch.core import ising, pwl, rng
from repro_torch.core.coupling import CouplingStore
from repro_torch.graphs import sparse_bipolar_edges
from repro_torch.kernels import common, parity, ref, sweep

pytestmark = pytest.mark.cuda

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
TIERS = (("dense", 2000), ("bitplane", 4096), ("bitplane_hbm", 14481))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _operands(n, fmt, r, t, dev, seed=0, ladder=False):
    """The sparse G(n, 8n) instance as the tier's operand, its dense J, a
    state and temperatures across an anneal (or a ladder, a column per
    replica)."""
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
    if ladder:
        temps = torch.logspace(math.log10(0.05), math.log10(9.0), r,
                               device=dev)[None, :].expand(t, r)
    else:
        temps = torch.linspace(4.0, 0.1, t, device=dev)[:, None].expand(t, r)
    return op, J, (u0, s0, e0, temps.contiguous())


def _equal(a_list, b_list):
    return [name for name, a, b in zip(NAMES, a_list, b_list)
            if not torch.equal(a, b)]


@pytest.mark.parametrize("t", [1, 256, 4096])
@pytest.mark.parametrize("r", [1, 8, 64])
@pytest.mark.parametrize("fmt,n", TIERS)
def test_rwa_pwl_bitwise_plain_at_every_width(cuda_device, fmt, n, r, t):
    op, J, (u0, s0, e0, temps) = _operands(n, fmt, r, t, cuda_device,
                                           seed=r)
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), r + t))
    unif = sweep.sweep_uniforms(words, 0, t, r, device=cuda_device)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rwa",
                          coupling=fmt)
    widths = sweep.widths(n, common.default_lane(n), 64, True)
    assert widths == [1, 2, 4, 8, 16]
    for width in widths:
        got = sweep.mcmc_sweep_at_width(width, op, u0, s0, e0, temps, tbl,
                                        uniforms=unif, mode="rwa",
                                        coupling=fmt)
        assert not _equal(got, want), (width, _equal(got, want))
    assert torch.equal(want[0], want[1] @ J.T)


def test_rwa_tiers_walk_one_trajectory(cuda_device):
    n, r, t = 4096, 8, 256
    tbl = pwl.pwl_table(device=cuda_device)
    runs = []
    for fmt in ("dense", "bitplane", "bitplane_hbm"):
        op, _, (u0, s0, e0, temps) = _operands(n, fmt, r, t, cuda_device)
        runs.append(sweep.mcmc_sweep_keyed(op, u0, s0, e0, (3, 4), 0, temps,
                                           tbl, mode="rwa", coupling=fmt,
                                           coalesce=False))
    for other in runs[1:]:
        assert not _equal(runs[0], other)


@pytest.mark.parametrize("uniformized", [False, True])
@pytest.mark.parametrize("fmt,n", [("dense", 2000),
                                   ("bitplane_hbm", 14481)])
def test_exact_sigmoid_splits_only_at_near_ties(cuda_device, fmt, n,
                                                uniformized):
    r = 512
    op, _, (u0, s0, e0, _) = _operands(n, fmt, r, 1, cuda_device, seed=4)
    temps = torch.linspace(0.1, 3.0 * math.sqrt(n), r,
                           device=cuda_device)[None, :].contiguous()
    words = rng.words(rng.fold_in(rng.key(0), 5))
    unif = sweep.sweep_uniforms(words, 0, 1, r, device=cuda_device)
    kw = dict(mode="rwa", uniformized=uniformized, coupling=fmt)
    got = sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, None, **kw)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, None, **kw)
    p_all = common.flip_probability(2.0 * s0 * u0, temps[0][:, None], None)
    tie = parity.roulette_near_tie(p_all, unif[0, :, 2], unif[0, :, 3],
                                   uniformized)
    same = torch.ones(r, dtype=torch.bool, device=cuda_device)
    for a, b in zip(got, want):
        same &= (a == b).reshape(r, -1).all(dim=1)
    assert bool((same | tie).all())
    assert int(tie.sum()) <= 0.35 * r


@pytest.mark.parametrize("fold", [None, 3])
@pytest.mark.parametrize("fmt,n", TIERS)
def test_draw_equals_read_with_fold_and_ladder(cuda_device, fmt, n, fold):
    r, t = 8, 130
    op, _, (u0, s0, e0, temps) = _operands(n, fmt, r, t, cuda_device,
                                           ladder=True)
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), 11))
    unif = sweep.sweep_uniforms(words, 2, t, r, device=cuda_device,
                                fold=fold)
    kw = dict(mode="rwa", coupling=fmt)
    drawn = sweep.mcmc_sweep_keyed(op, u0, s0, e0, words, 2, temps, tbl,
                                   fold=fold, **kw)
    read = sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    plain = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    assert not _equal(drawn, read)
    assert not _equal(read, plain)


@pytest.mark.parametrize("block_r", [1, 4, 8])
def test_coalesced_rows_fetched_equals_plain(cuda_device, block_r):
    n, r, t = 14481, 8, 200
    op, _, (u0, s0, e0, temps) = _operands(n, "bitplane_hbm", r, t,
                                           cuda_device, seed=6)
    tbl = pwl.pwl_table(device=cuda_device)
    words = rng.words(rng.fold_in(rng.key(0), 9))
    unif = sweep.sweep_uniforms(words, 0, t, r, device=cuda_device)
    # Replicas 0-3 share the state and the uniforms, so their sites too.
    u0[:4], s0[:4], e0[:4] = u0[0], s0[0], e0[0]
    unif[:, :4] = unif[:, :1]
    unif = unif.contiguous()
    kw = dict(mode="rwa", coupling="bitplane_hbm", block_r=block_r)
    got = sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, **kw)
    assert not _equal(got, want)
    if block_r == 1:
        assert int(got[6].sum()) == r * t
    else:
        assert int(got[6].sum()) < r * t


def test_counter_and_forced_pr16_route(cuda_device):
    n, r = 2000, 512
    op, _, (u0, s0, e0, _) = _operands(n, "dense", r, 1, cuda_device,
                                       seed=4)
    temps = torch.linspace(0.1, 3.0 * math.sqrt(n), r,
                           device=cuda_device)[None, :].contiguous()
    words = rng.words(rng.fold_in(rng.key(0), 5))
    unif = sweep.sweep_uniforms(words, 0, 1, r, device=cuda_device)
    tbl = pwl.pwl_table(device=cuda_device)
    sweep.counter.reset()
    sweep.rwa_hopper_counter.reset()
    sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rwa")
    sweep.mcmc_sweep_keyed(op, u0, s0, e0, words, 0, temps, tbl, mode="rwa")
    sweep.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rsa")
    old = sweep.mcmc_sweep_at_width(8, op, u0, s0, e0, temps, tbl,
                                    uniforms=unif, mode="rwa", pr16=True)
    assert (sweep.counter.count, sweep.rwa_hopper_counter.count) == (4, 2)
    want = ref.mcmc_sweep(op, u0, s0, e0, unif, temps, tbl, mode="rwa")
    tie = parity.roulette_near_tie(
        common.flip_probability(2.0 * s0 * u0, temps[0][:, None], tbl),
        unif[0, :, 2], unif[0, :, 3], False)
    same = torch.ones(r, dtype=torch.bool, device=cuda_device)
    for a, b in zip(old, want):
        same &= (a == b).reshape(r, -1).all(dim=1)
    assert bool((same | tie).all())
    with pytest.raises(ValueError, match="cluster width"):
        sweep.mcmc_sweep_at_width(16, op, u0, s0, e0, temps, tbl,
                                  uniforms=unif, mode="rwa", pr16=True)
