"""Kernel A's RWA roulette as a tree that does not depend on the width
(``common.roulette_pick_tree``, the plain version of
``csrc/sweep_rwa.cu``'s pick), on the CPU:

* the tree pick against JAX's ``roulette_pick`` on weights whose partial
  sums are exact (multiples of 1/64, so no order of the sums can matter),
  at N = 2,000, 4,096, 14,481 and 16,384: site, total and degenerate flag
  bitwise;
* its picks from one state follow p_i/W (the statistical tier's χ² gate);
* ``ref.mcmc_sweep``'s RWA trajectory bitwise the same whether the tree
  is summed as 1, 2, 4, 8 or 16 subtrees, as the card's cluster ranks sum
  it;
* no phantom site (past N) is picked when the radius rounds to the total;
* the degenerate total and the uniformized null transition against JAX's
  ``roulette_pick`` and ``mcmc_sweep`` (near ties masked, N not a
  multiple of the 128-site leaf);
* ``widths``, ``cluster_width``, ``max_n`` and ``route`` at N = 14,481
  and at the ceiling.

The card's side is ``tests/test_torch_sweep_rwa_card.py`` (no JAX there).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pwl as jpwl
from repro.kernels import common as jcommon
from repro.kernels import ref as jref
from repro_torch.core import coupling as tcoupling
from repro_torch.core import pwl as tpwl
from repro_torch.kernels import common, parity, ref, sweep

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")


@pytest.mark.parametrize("n", [2000, 4096, 14481, 16384])
def test_tree_pick_matches_jax_away_from_ties(n):
    g = np.random.default_rng(n)
    p = (g.integers(0, 65, size=(32, n)) / 64.0).astype(np.float32)
    p[3] = 0.0
    p[4, : n // 2] = 0.0
    u = g.random(32).astype(np.float32)
    lane = common.default_lane(n)
    sj, tj, dj = jcommon.roulette_pick(jnp.asarray(p), jnp.asarray(u), lane)
    st, tt, dt = common.roulette_pick_tree(torch.from_numpy(p),
                                           torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_tree_pick_law_passes_chi2():
    g = np.random.default_rng(11)
    n, draws = 1000, 40_000
    p = torch.from_numpy(g.random(n).astype(np.float32) ** 3)
    u = torch.from_numpy(g.random(draws).astype(np.float32))
    picks = torch.cat([common.roulette_pick_tree(p.expand(len(c), n), c)[0]
                       for c in u.split(10_000)])
    x2, _, crit = parity.pick_law_chi2(p.double().numpy(), picks.numpy(),
                                       32)
    assert x2 < 2.0 * crit, (x2, crit)
    # A wrong law (the weights squared) fails the same gate.
    x2w, _, _ = parity.pick_law_chi2((p.double() ** 2).numpy(),
                                     picks.numpy(), 32)
    assert x2w > 2.0 * crit


@pytest.mark.parametrize("uniformized", [False, True])
def test_plain_sweep_bitwise_across_subtree_splits(monkeypatch, uniformized):
    n, r, t = 2000, 4, 48
    g = np.random.default_rng(5)
    J = np.triu(g.choice([-1.0, 1.0], size=(n, n)).astype(np.float32), 1)
    J = torch.from_numpy(J + J.T)
    s0 = torch.from_numpy(g.choice([-1.0, 1.0], size=(r, n)).astype(
        np.float32))
    u0 = s0 @ J.T
    e0 = -0.5 * (s0 * u0).sum(dim=1)
    unif = torch.from_numpy(g.random((t, r, 4)).astype(np.float32))
    temps = torch.full((t, r), 20.0)
    table = tpwl.pwl_table()
    pick = common.roulette_pick_tree
    outs = []
    for k in (1, 2, 4, 8, 16):
        monkeypatch.setattr(common, "roulette_pick_tree",
                            functools.partial(pick, subtrees=k))
        outs.append(ref.mcmc_sweep(J, u0, s0, e0, unif, temps, table,
                                   mode="rwa", uniformized=uniformized))
    for out in outs[1:]:
        for name, a, b in zip(NAMES, outs[0], out):
            assert torch.equal(a, b), name
    assert int(outs[0][5].sum()) > 0


@pytest.mark.parametrize("n", [128, 129, 200, 14481])
def test_no_phantom_site_when_the_radius_rounds_to_the_total(n):
    """u = 1 puts the radius on the total itself; u just below 1 rounds to
    it at these totals. The pick stays below N (the padding past N is
    never returned), with and without zero-weight sites at the end."""
    g = np.random.default_rng(n)
    p = torch.from_numpy(g.random((3, n)).astype(np.float32))
    p[1, n - 3:] = 0.0                  # trailing zero-weight real sites
    p[2, : n - 1] = 0.0                 # one site holds all the weight
    for u in (1.0, 1.0 - 2.0 ** -24):
        site, total, _ = common.roulette_pick_tree(p, torch.full((3,), u))
        assert ((site >= 0) & (site < n)).all(), (u, site)
    assert int(site[2]) == n - 1
    lane = common.default_lane(n)
    sj, _, _ = jcommon.roulette_pick(jnp.asarray(p.numpy()),
                                     jnp.ones(3, jnp.float32), lane)
    assert (np.asarray(sj) < n).all()


@pytest.mark.parametrize("n", [200, 14481])
def test_degenerate_total_matches_jax(n):
    p = torch.zeros((2, n))
    u = torch.tensor([0.3, 0.9])
    site, total, degenerate = common.roulette_pick_tree(p, u)
    sj, tj, dj = jcommon.roulette_pick(jnp.zeros((2, n), jnp.float32),
                                       jnp.asarray(u.numpy()),
                                       common.default_lane(n))
    assert degenerate.all() and (total == 0).all()
    np.testing.assert_array_equal(np.asarray(sj), site.numpy())
    np.testing.assert_array_equal(np.asarray(dj), degenerate.numpy())
    nan = torch.full((1, n), float("nan"))
    assert bool(common.roulette_pick_tree(nan, u[:1])[2].all())


@pytest.mark.parametrize("uniformized", [False, True])
@pytest.mark.parametrize("n", [300, 1000])
def test_one_step_against_jax_except_near_ties(n, uniformized):
    """One RWA step from 256 states at temperatures across the anneal,
    N a multiple of no 128-site leaf: the plain sweep (the card's tree)
    against JAX's reference sweep, bitwise except near ties."""
    r = 256
    g = np.random.default_rng(n)
    J = np.triu(g.choice([-1.0, 1.0], size=(n, n)).astype(np.float32), 1)
    J = J + J.T
    s0 = g.choice([-1.0, 1.0], size=(r, n)).astype(np.float32)
    u0 = (s0 @ J.T).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, u0)).astype(np.float32)
    unif = g.random((1, r, 4)).astype(np.float32)
    temps = g.uniform(0.2, 3.0 * np.sqrt(n), size=(1, r)).astype(np.float32)
    args = (J, u0, s0, e0, unif, temps)
    kw = dict(mode="rwa", uniformized=uniformized)
    got = ref.mcmc_sweep(*map(torch.from_numpy, args), tpwl.pwl_table(),
                         **kw)
    want = jref.mcmc_sweep(*map(jnp.asarray, args), jpwl.pwl_table(), **kw)
    p_all = common.flip_probability(torch.from_numpy(2.0 * s0 * u0),
                                    torch.from_numpy(temps[0])[:, None],
                                    tpwl.pwl_table())
    tie = parity.roulette_near_tie(p_all, torch.from_numpy(unif[0, :, 2]),
                                   torch.from_numpy(unif[0, :, 3]),
                                   uniformized).numpy()
    keep = ~tie
    assert keep.sum() >= 0.95 * r
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a)[keep], b.numpy()[keep],
                                      err_msg=name)


def test_widths_rule_and_ceiling():
    n = 14481                      # default_lane(14481) == 9
    assert common.tree_leaves(n) == 128
    assert sweep.widths(n, 9, 64, True) == [1, 2, 4, 8, 16]
    assert sweep.widths(n, 9, 64, True, pr16=True) == [1]
    assert sweep.widths(16384, 128, 64, True) == [1, 2, 4, 8, 16]
    for r, c in ((1, 16), (8, 16), (16, 8), (64, 2), (132, 1), (200, 1)):
        assert sweep.cluster_width(n, 9, 64, True, True, r) == c
        assert sweep.cluster_width(16384, 128, 64, True, True, r) == c
    assert sweep.cluster_width(2048, 128, 64, True, False, 64) == 2
    # At R=8: the narrowest width of at most 4 leaves a block.
    for n_, c in ((2000, 4), (4096, 8), (16384, 16), (2048, 4)):
        assert sweep.cluster_width(n_, 128, 64, True, False, 8) == c
    top = sweep.max_n(True)
    assert top == tcoupling.SWEEP_STATE_MAX_N
    assert top >= sweep.max_n(True, pr16=True)
    assert sweep.widths(top, 1, 64, True) == [16]
    assert sweep.rwa_shared_bytes(top, 64, 16) <= sweep.MAX_SHARED_BYTES
    assert sweep.widths(top + 1, 1, 64, True) == []
    # One block of 128 leaves (16,384 sites) is the most a block holds.
    assert sweep.widths(16385, 1, 64, True) == [2, 4, 8, 16]
    with pytest.raises(ValueError, match="cluster width"):
        sweep.cluster_width(top + 1, 1, 64, True)
    assert sweep.route("rwa") == "sweep_rwa"
    assert sweep.route("rwa", pr16=True) == "sweep"
    assert sweep.route("rsa") == "sweep_rsa"
    assert sweep.route("rsa", pr16=True) == "sweep"
