"""Kernel D's route (``csrc/colored_sweep_hopper.cu``) on the CPU: its
shared-memory budget and ring, its widths and ceiling, and the plain
version it is held to on the card.

* ``colored_shared_bytes`` and ``colored_ring`` mirror the kernel's
  ``layout`` and ``ring_slots``: the constants and the layout's lines are
  read from the source and the sizes recomputed here from them, ring
  included; the earlier kernel's budget (``pr17=True``) still mirrors
  ``colored_sweep.cu``'s ``smem_layout``.
* ``colored_widths(n, 3072, 64)`` is non-empty at every N of a sweep from
  the window to ``colored_max_n(3072)`` and at named N, and the ceiling is
  not below the earlier kernel's 288,256.
* The plain ``ref.colored_sweep`` with PWL and integer J and h is bitwise
  ``repro.kernels.ref.colored_sweep`` at N = 20,000 on the ``bitplane``
  tier, where W = 625 is not a multiple of 4 and the last slice at C = 16
  is shorter (800 of 1,280 spins): the shapes of the kernel's 4-byte copy
  path, which the card tests take
  (``tests/test_torch_colored_hopper_card.py``).
"""
import re
from pathlib import Path

import jax  # noqa: F401  (both packages side by side, as in every port test)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core.pwl import pwl_table as jpwl_table
from repro.graphs import sparse_bipolar_edges as jsparse
from repro.graphs.coloring import greedy_coloring as jcoloring
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.kernels import ref, sweep

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
CSRC = Path(sweep.__file__).parent / "csrc"
SOURCE = (CSRC / "colored_sweep_hopper.cu").read_text()
SOURCE17 = (CSRC / "colored_sweep.cu").read_text()


def _constant(name, source=SOURCE):
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", source)
    assert m, name
    return m.group(1).strip()


def test_budget_constants_match_the_source():
    assert _constant("kMinRing") == str(sweep.COLORED_MIN_RING)
    assert _constant("kMaxRing") == str(sweep.COLORED_MAX_RING)
    assert _constant("kThreads") == str(32 * sweep.COLORED_WARPS)
    assert _constant("kWarps") == "kThreads / 32"
    assert _constant("kMaxCluster") == str(sweep.COLORED_CLUSTERS[-1])
    assert eval(_constant("kBudget")) == sweep.MAX_SHARED_BYTES
    assert _constant("kRing", SOURCE17) == str(sweep.COLORED_RING)


#: The kernel's layout, line by line: (field, bytes it takes).
LAYOUT = (("state", "3 * 32 * (size_t)slice_pitch(nc) * 4"),
          ("pwl", "align16(8 * (size_t)segs)"),
          ("mail", "align16(2 * 8 * (size_t)mask_words(S))"),
          ("part", "2 * 8 * (size_t)C * kWarps"),
          ("bars", "16"),
          ("hdr", "align16(4 * (size_t)(B == 0 ? max(K, S) : K))"),
          ("ring", "(size_t)K * slot_bytes(nc, B)"))
#: The helpers the layout uses, as the source writes them.
HELPERS = ("return C == 1 ? N : 32 * (((N + C - 1) / C + 31) / 32);",
           "return (slice_words(ncs) + 3) & ~3;",
           "return B == 0 ? 4 * (size_t)((ncs + 3) & ~3)\n"
           "                : 4 * (size_t)2 * B * run_words(ncs);",
           "int k = (int)((kBudget - base) / (slot_bytes(slice_len(N, C), B) "
           "+ 4));",
           "while (k >= kMinRing && layout(N, S, segs, C, B, k).total > "
           "kBudget) --k;")


def _slice_len(n, c):
    return n if c == 1 else 32 * ((-(-n // c) + 31) // 32)


def _slot_bytes(ncs, b):
    run_words = (-(-ncs // 32) + 3) & ~3
    return 4 * ((ncs + 3) & ~3) if b == 0 else 4 * 2 * b * run_words


def _c_layout(n, s, segs, c, b, k):
    """The source's ``layout(N, S, segs, C, B, K).total``, from ``LAYOUT``."""
    env = {"nc": _slice_len(n, c), "S": s, "segs": segs, "C": c, "B": b,
           "K": k, "kWarps": sweep.COLORED_WARPS,
           "slice_pitch": lambda nc: -(-nc // 32) | 1,
           "mask_words": lambda w: -(-w // 32) + 1,
           "slot_bytes": _slot_bytes,
           "align16": lambda x: -(-x // 16) * 16}
    return sum(eval(expr.replace("(size_t)", "").replace(
        "B == 0 ? max(K, S) : K", "max(K, S) if B == 0 else K"), env)
        for _, expr in LAYOUT)


def _c_ring(n, s, segs, c, b):
    """The source's ``ring_slots``: as many slots as fit, at most 512; 0
    below 2."""
    base = _c_layout(n, s, segs, c, b, 0)
    if base >= sweep.MAX_SHARED_BYTES:
        return 0
    k = min((sweep.MAX_SHARED_BYTES - base)
            // (_slot_bytes(_slice_len(n, c), b) + 4), 512)
    while k >= 2 and _c_layout(n, s, segs, c, b, k) > sweep.MAX_SHARED_BYTES:
        k -= 1
    return k if k >= 2 else 0


def test_shared_bytes_mirror_the_kernels_layout():
    lines = re.findall(r"l\.(\w+) = at;\s+at \+= ([^;]+);", SOURCE)
    assert tuple(lines) == LAYOUT
    for helper in HELPERS:
        assert helper in SOURCE, helper
    g = np.random.default_rng(0)
    ns = [96, 300, 1024, 2000, 2002, 4096, 16_384, 20_000, 32_768, 100_000,
          288_256, sweep.colored_max_n(3072)] + \
        [int(x) for x in g.integers(64, 290_000, 24)]
    for n in ns:
        for s in (64, 640, 3072):
            if s > n:
                continue
            for c in sweep.COLORED_CLUSTERS:
                for b in (0, 1, 2):
                    for segs in (0, 64):
                        k = _c_ring(n, s, segs, c, b)
                        kw = dict(dense=b == 0, num_planes=max(b, 1))
                        assert sweep.colored_ring(n, s, segs, c, **kw) == k, \
                            (n, s, c, b)
                        assert k == 0 or 2 <= k <= 512
                        assert sweep.colored_shared_bytes(n, s, segs, c,
                                                          **kw) == \
                            _c_layout(n, s, segs, c, b, k or 2), (n, s, c, b)


def test_the_earlier_kernels_budget_still_mirrors_its_source():
    lines = re.findall(r"m\.(\w+) = at;[^\n]*\n\s+at = ([^;]+);", SOURCE17)
    assert [name for name, _ in lines] == ["state", "pwl", "mail", "part",
                                           "wpart", "list"]
    assert "if (dense) at = align16(at + (size_t)kRing * ((nc + 3) / 4) * " \
           "16);" in SOURCE17
    assert sweep.colored_max_n(3072, pr17=True) == 288_256
    # The route keeps no accepted-slot list (S words) and no thread rings:
    # without its own ring a block takes less than the earlier one's.
    for n, s, c in ((16_384, 3072, 16), (1024, 512, 1), (20_000, 3072, 4)):
        for dense in (False, True):
            assert _c_layout(n, s, 64, c, 0 if dense else 1, 0) < \
                sweep.colored_shared_bytes(n, s, 64, c, dense, pr17=True)


def test_every_n_up_to_the_ceiling_has_a_width():
    top = sweep.colored_max_n(3072)
    assert top >= 288_256 and top % (32 * 16) == 0
    named = [3072, 16_384, 20_000, 32_768, 288_256, top - 1, top]
    for n in list(range(3072, top + 1, 997)) + named:
        fits = sweep.colored_widths(n, 3072, 64)
        assert fits, n
        assert sweep.colored_width(n, 3072, 64, 8) in fits
        for c in fits:
            assert sweep.colored_ring(n, 3072, 64, c) >= sweep.COLORED_MIN_RING
    assert not sweep.colored_widths(top + 1, 3072, 64)
    # Two planes a row: a lower ceiling, every N below it still fits.
    top2 = sweep.colored_max_n(3072, num_planes=2)
    assert 250_000 < top2 < top
    for n in range(3072, top2 + 1, 7919):
        assert sweep.colored_widths(n, 3072, 64, num_planes=2), n


def test_the_rule_keeps_every_cluster_on_the_card():
    # The route's rule: the widest width whose R clusters the card holds at
    # once, on the planes one whose slice is whole 16-byte runs of words
    # where one is, or the narrowest that fits.
    held = sweep.COLORED_CLUSTERS_HELD
    for n, s in ((16384, 3072), (1024, 640), (4096, 2048), (20000, 3072)):
        for dense in (False, True):
            fits = sweep.colored_widths(n, s, 64, dense)
            for r in (1, 7, 8, 9, 15, 16, 30, 32, 64, 66, 132, 256):
                c = sweep.colored_width(n, s, 64, r, dense)
                ok = [w for w in fits if r <= held[w]]
                runs = [w for w in ok if dense or w == 1
                        or sweep.colored_slice_len(n, w) // 32 % 4 == 0]
                assert c == ((runs or ok)[-1] if ok else fits[0]), (n, r)
                if ok:
                    assert r <= held[c]
    assert sweep.colored_width(16384, 3072, 64, 8) == 8
    assert sweep.colored_width(16384, 3072, 64, 8, dense=True) == 9
    # The anchor's ring holds a step's ~340 accepted rows at C = 8 and 16,
    # a few at C = 1.
    rings = [sweep.colored_ring(16384, 3072, 64, c) for c in (1, 2, 4, 8, 16)]
    assert rings[-2:] == [394, 512] and rings[0] < 16


def _edges(n, m, seed):
    jedges = jsparse(n, m, seed=seed)
    return jedges, interop.edges_from_numpy(jedges.rows, jedges.cols,
                                            jedges.weights, n)


def test_plain_colored_sweep_bitwise_jax_at_the_4_byte_copy_shape():
    n, r, t = 20_000, 2, 12
    jedges, tedges = _edges(n, 3 * n, seed=n)
    h = np.round(np.linspace(-2, 2, n)).astype(np.float32)
    jprob = jising.IsingProblem.create_sparse(jedges, h=h)
    tprob = tising.IsingProblem.create_sparse(tedges, h=h)
    jplan = jops.ColoredPlan(jcoloring(jprob.coupling_source), jprob,
                             "bitplane")
    col = jplan.coloring
    planes = (np.asarray(jplan.store.planes.pos),
              np.asarray(jplan.store.planes.neg))
    tplan = interop.colored_plan_from_numpy(col.colors, col.perm,
                                            col.offsets, tprob, "bitplane",
                                            planes)
    op = tplan.store.kernel_operand
    assert op.num_words == 625 and op.num_words % 4
    assert sweep.colored_slice_len(n, 16) == 1280 and n - 15 * 1280 == 800
    win = jplan.window
    # The problem in color order: u0 = J s + h and e0 from the COO.
    pe = jplan.problem.edges
    rows, cols = np.asarray(pe.rows), np.asarray(pe.cols)
    w = np.asarray(pe.weights, dtype=np.float64)
    hp = np.asarray(jplan.problem.fields, dtype=np.float64)
    g = np.random.default_rng(3)
    s0 = np.where(g.random((r, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    uj = np.zeros((r, n))
    for k in range(r):
        np.add.at(uj[k], rows, w * s0[k, cols])
        np.add.at(uj[k], cols, w * s0[k, rows])
    u0 = (uj + hp).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, uj) - s0 @ hp).astype(np.float32)
    unif = g.random((t, r, win)).astype(np.float32)
    temps = np.broadcast_to(np.geomspace(3.0, 0.05, t).astype(
        np.float32)[:, None], (t, r)).copy()
    sched = np.asarray(jops.colored_class_schedule(
        jplan.wstarts, jplan.offsets, jplan.sizes, jnp.arange(t)))
    args = (u0, s0, e0, unif, temps, sched)
    want = jref.colored_sweep(jplan.store.kernel_operand,
                              *map(jnp.asarray, args), jpwl_table(),
                              block_r=2)
    got = ref.colored_sweep(op, *(torch.from_numpy(np.array(a))
                                  for a in args), tpwl.pwl_table(),
                            block_r=2)
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy(),
                                      err_msg=name)
    assert 0 < int(got[6].sum()) <= int(got[5].sum())


def test_forced_route_and_measurement_entry_are_card_only():
    u = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        sweep.colored_sweep_at_width(1, torch.zeros((64, 64)), u, u,
                                     torch.zeros(2), torch.ones((1, 2)),
                                     torch.zeros((1, 3), dtype=torch.int32),
                                     base_words=(1, 2), window=32,
                                     pr17=True)
    assert sweep.colored_route() == "colored_sweep_hopper"
    assert sweep.colored_route(pr17=True) == "colored_sweep"
    assert set(sweep.COLORED_ENTRIES) == {"colored_sweep",
                                          "colored_sweep_hopper"}
