"""Kernel A's RSA route (``csrc/sweep_rsa.cu``) on the CPU: its width rule,
its shared-memory budget, and the plain version it is held to on the card.

* Every N from 19,000 to 20,100, and 14,481, 20,011, 39,986, 100,003 and
  154,965 (the port's ceiling), has an RSA width whose block fits the
  budget; the earlier route (``pr16=True``) has none at most of them. Past the
  ceiling no width fits and the rule raises.
* ``rsa_shared_bytes`` and ``rsa_ring`` mirror the kernel's ``layout`` and
  ``ring_slots``: the constants and the layout's lines are read from the
  source, and the sizes are recomputed here from them.
* The plain RSA + PWL sweep on an integer J and h at N = 19,138, an N the
  card refused before, is bitwise ``repro.kernels.ref.mcmc_sweep`` (R=2,
  T=64) on the same planes and uniforms.

The card's kernel against the plain version is in
``tests/test_torch_sweep_rsa_card.py``.
"""
import re
from pathlib import Path

import jax  # noqa: F401  (both packages side by side, as in every port test)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbit
from repro.core import ising as jising
from repro.core import pwl as jpwl
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import bitplane as tbit
from repro_torch.core import coupling as tcoupling
from repro_torch.core import pwl as tpwl
from repro_torch.kernels import common, sweep

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")
SOURCE = (Path(sweep.__file__).parent / "csrc" / "sweep_rsa.cu").read_text()
TOP = tcoupling.SWEEP_STATE_MAX_N


def _fits(n, segs=64, num_planes=0):
    fits = sweep.widths(n, common.default_lane(n), segs, False,
                        num_planes=num_planes)
    assert fits, n
    for c in fits:
        assert sweep.shared_bytes(n, common.default_lane(n), segs, False, c,
                                  num_planes=num_planes) \
            <= sweep.MAX_SHARED_BYTES, (n, c)
        # The last block holds a site below N.
        assert (c - 1) * sweep.rsa_slice(n, c) < n <= c * sweep.rsa_slice(
            n, c), (n, c)
    return fits


def test_every_n_from_19000_to_20100_has_an_rsa_width():
    refused = 0
    span = range(19_000, 20_101)
    for n in span:
        _fits(n)
        _fits(n, segs=0, num_planes=2)
        refused += not sweep.widths(n, common.default_lane(n), 64, False,
                                    pr16=True)
    # The earlier route took most of these N (731 of 1,101) at no width.
    assert refused > len(span) // 2


@pytest.mark.parametrize("n", [14_481, 20_011, 39_986, 100_003, TOP])
def test_named_n_have_an_rsa_width(n):
    fits = _fits(n)
    width = sweep.cluster_width(n, common.default_lane(n), 64, False, True,
                                8, num_planes=1)
    assert width in _fits(n, num_planes=1)
    assert sweep.cluster_width(n, common.default_lane(n), 64, False,
                               r=8) in fits
    if n != 14_481:
        assert not sweep.widths(n, common.default_lane(n), 64, False,
                                pr16=True)


def test_past_the_ceiling_nothing_fits():
    assert sweep.max_n(False) == TOP
    for n in range(TOP + 1, TOP + 64):
        assert sweep.widths(n, common.default_lane(n), 64, False) == []
    with pytest.raises(ValueError, match="cluster width"):
        sweep.cluster_width(TOP + 1, 1, 64, False)
    # At the ceiling only the widest clusters hold a dense row's ring.
    assert sweep.widths(TOP, 1, 64, False)[-1] == 16


def _constant(name):
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE)
    assert m, name
    return m.group(1).strip()


def test_budget_constants_match_the_source():
    assert _constant("kSlab") == str(sweep.RSA_SLAB)
    assert _constant("kMinRing") == str(sweep.RSA_MIN_RING)
    assert _constant("kMaxRing") == str(sweep.RSA_MAX_RING)
    assert _constant("kWindow") == str(common.SWEEP_WINDOW)
    assert _constant("kDecSlots") == "2 * kWindow"
    assert sweep.RSA_DEC_SLOTS == 2 * common.SWEEP_WINDOW
    assert _constant("kMaxWidth") == str(sweep.RSA_CLUSTERS[-1])
    assert eval(_constant("kBudget")) == sweep.MAX_SHARED_BYTES


#: The kernel's layout, line by line: (field, bytes it takes).
LAYOUT = (("u", "4 * (size_t)S"), ("s", "S"), ("bs", "S"),
          ("ring", "K * l.slot"), ("pwl", "align16(8 * (size_t)segs)"),
          ("wj", "4 * 2 * kWindow"), ("wacc", "4 * 2 * kWindow"),
          ("wtemp", "4 * 2 * kWindow"), ("dec", "16 * kDecSlots"),
          ("bar_dec", "8 * kDecSlots"), ("bar_ring", "8 * kMaxRing"),
          ("bar_free", "8 * 2"))


def _c_layout(S, B, segs, K):
    """The source's ``layout(S, B, segs, K).total``, from ``LAYOUT``."""
    env = {"S": S, "K": K, "segs": segs, "kWindow": common.SWEEP_WINDOW,
           "kDecSlots": sweep.RSA_DEC_SLOTS, "kMaxRing": sweep.RSA_MAX_RING,
           "l": type("L", (), {"slot": 4 * S if B == 0
                               else B * 2 * (S // 32) * 4})}
    env["align16"] = lambda x: -(-x // 16) * 16
    return sum(eval(expr.replace("(size_t)", ""), env) for _, expr in LAYOUT)


def _c_ring(S, B, segs):
    slot = 4 * S if B == 0 else B * 2 * (S // 32) * 4
    base = _c_layout(S, B, segs, 0)
    if base + 2 * slot > sweep.MAX_SHARED_BYTES:
        return 0
    return min((sweep.MAX_SHARED_BYTES - base) // slot, 4)


def test_shared_bytes_mirror_the_kernels_layout():
    lines = re.findall(r"l\.(\w+) = at;\s+at \+= ([^;]+);", SOURCE)
    assert tuple(lines) == LAYOUT
    assert "return B == 0 ? 4 * (size_t)S : (size_t)B * 2 * (S / 32) * 4;" \
        in SOURCE
    g = np.random.default_rng(0)
    ns = [2, 127, 128, 129, 2000, 4096, 14_481, 16_384, 19_138, 20_011,
          100_003, TOP] + list(g.integers(2, TOP, 40))
    for n in ns:
        n = int(n)
        for c in sweep.RSA_CLUSTERS:
            S = -(-n // c)
            S = -(-S // 128) * 128
            assert sweep.rsa_slice(n, c) == S
            for B in (0, 1, 2, 5):
                for segs in (0, 64):
                    K = _c_ring(S, B, segs)
                    assert sweep.rsa_ring(n, segs, c, B) == K, (n, c, B)
                    assert sweep.rsa_shared_bytes(n, segs, c, B) == \
                        _c_layout(S, B, segs, K or 2), (n, c, B, segs)


def _edges(n, seed, amax=3):
    """A random edge list with integer weights in [−amax, amax] (B=2)."""
    g = np.random.default_rng(seed)
    m = 6 * n
    rows = g.integers(0, n, size=m)
    cols = g.integers(0, n - 1, size=m)
    cols = np.where(cols >= rows, cols + 1, cols)
    w = g.integers(1, amax + 1, size=m) * g.choice([-1, 1], size=m)
    jedges = jising.EdgeList.create(rows, cols, w, n)
    jedges = jising.EdgeList.create(jedges.rows, jedges.cols,
                                    np.clip(jedges.weights, -amax, amax), n)
    return jedges, interop.edges_from_numpy(jedges.rows, jedges.cols,
                                            jedges.weights, n)


@pytest.mark.parametrize("tier", ["bitplane", "bitplane_hbm"])
def test_rsa_pwl_plain_bitwise_jax_at_an_n_the_card_refused(tier):
    n, r, t = 19_138, 2, 64
    assert not sweep.widths(n, common.default_lane(n), 64, False,
                            pr16=True)
    jedges, tedges = _edges(n, seed=5)
    align = tcoupling.FORMATS[tier].align_words
    jplanes = jbit.encode_edges(jedges, 2, align)
    tplanes = tbit.encode_edges(tedges, 2, align)
    g = np.random.default_rng(7)
    s0 = np.where(g.random((r, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    h = np.rint(g.normal(size=n)).astype(np.float32)
    rows = np.asarray(jedges.rows)
    cols = np.asarray(jedges.cols)
    w = np.asarray(jedges.weights, dtype=np.float64)
    uj = np.zeros((r, n))
    for k in range(r):   # J s from the canonical COO (both triangles)
        np.add.at(uj[k], rows, w * s0[k, cols])
        np.add.at(uj[k], cols, w * s0[k, rows])
    u0 = (uj + h).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, uj) - s0 @ h).astype(np.float32)
    unif = g.random((t, r, 4)).astype(np.float32)
    temps = np.broadcast_to(np.geomspace(6.0, 0.05, t).astype(
        np.float32)[:, None], (t, r)).copy()
    args = (u0, s0, e0, unif, temps)
    want = jref.mcmc_sweep(jplanes, *map(jnp.asarray, args),
                           jpwl.pwl_table(), mode="rsa")
    got = sweep.mcmc_sweep(tplanes, *(torch.from_numpy(a) for a in args),
                           tpwl.pwl_table(), mode="rsa", coupling=tier)
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert 0 < int(got[5].sum()) < r * t
    assert int(got[6].sum()) <= r * t


def test_measurement_builds_go_through_the_kernels_cache(tmp_path,
                                                         monkeypatch):
    """``scripts/rsa_variants.py``'s builds (the stamped one and the bulk
    fill) are compiled by ``_build.build`` with the kernel's own flags and
    their define, cached, and rebuilt when the kernel source they include
    changes. A stand-in nvcc writes its arguments as the library."""
    import shutil
    import sys

    from repro_torch.kernels import _build
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    try:
        import rsa_variants
    finally:
        sys.path.pop(0)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\na = sys.argv\n"
                    "open(a[a.index('-o') + 1], 'w').write(' '.join(a[1:]))\n"
                    "print('ptxas info    : 0 bytes spill stores')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    variants = rsa_variants.VARIANTS
    assert set(variants) == {"rsa_stamps", "rsa_bulk"}

    first = _build.build([], variants=variants)
    assert set(first) == set(variants)
    for name, (source, base, extra) in variants.items():
        args = first[name].path.read_text().split()
        assert args[:len(_build.NVCC_FLAGS[base])] == list(
            _build.NVCC_FLAGS[base])
        assert "-fmad=false" in args and set(extra) <= set(args)
        assert args[-1] == str(source) and ["-I", str(csrc)] == args[
            args.index("-I"):args.index("-I") + 2]
        assert first[name].seconds > 0.0 and "spill" in first[name].log
    assert first["rsa_stamps"].path != first["rsa_bulk"].path

    again = _build.build([], variants=variants)
    assert {k: (b.path, b.seconds) for k, b in again.items()} == {
        k: (b.path, 0.0) for k, b in first.items()}

    kernel = csrc / "sweep_rsa.cu"
    kernel.write_text(kernel.read_text() + "\n// edited\n")
    edited = _build.build([], variants=variants)
    for name in variants:
        assert edited[name].path != first[name].path
        assert edited[name].seconds > 0.0
    src = (csrc / "sweep_rsa.cu").read_text()
    assert "#ifdef RSA_BULK_FILL" in src and "#ifndef RSA_STAMP" in src
