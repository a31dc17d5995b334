"""The plain versions of the port's two kernels against the JAX package.

``local_field_init``: bitwise equal to ``ising.local_fields`` for integer J.
``mcmc_sweep`` (dense), given JAX's own uniforms and temperatures:

* RSA + PWL: all outputs bitwise equal to ``repro.kernels.ref.mcmc_sweep``
  and to the Pallas kernel in interpret mode.
* RWA, uniformized RWA and the exact sigmoid: one step from 512 random
  states must agree exactly on every state except near ties (the roulette
  radius within 1e-5·W of a cumulative boundary, recomputed in float64);
  RSA with the exact sigmoid agrees except where the accept uniform lies
  within 4 ulp of p.
* Every path keeps the invariants exactly after a T-step run:
  u == J s + h, e == energy(s), best_e == energy(best_s), Σ rows == R·T.

These run the wrappers on CPU tensors, which take the plain versions; the
CUDA kernels are held against them on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax  # noqa: F401  (both packages side by side, as in every port test)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core import pwl as jpwl
from repro.kernels import ref as jref
from repro.kernels.sweep import mcmc_sweep as jkernel
from repro_torch import interop
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.core import coupling as tcoupling
from repro_torch.core import rng as trng
from repro_torch.core import schedules as tsched
from repro_torch.core.solver import SolverConfig
from repro_torch.kernels import common, local_field, ops, parity, sweep
from repro_torch.kernels import ref as tref

NAMES = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips", "rows_fetched")


def _coupling(seed, n, scale=1.0):
    g = np.random.default_rng(seed)
    J = np.triu(np.rint(g.normal(size=(n, n)) * scale), 1)
    return (J + J.T).astype(np.float32)


def _state(J, h, r, seed):
    g = np.random.default_rng(seed)
    s0 = np.where(g.random((r, J.shape[0])) < 0.5, 1.0, -1.0).astype(
        np.float32)
    u0 = (s0 @ J.T + h).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, s0 @ J.T) - s0 @ h).astype(
        np.float32)
    return u0, s0, e0


def _inputs(n, r, t, seed, temps=None, h_scale=0.0):
    J = _coupling(seed, n)
    h = np.rint(np.random.default_rng(seed + 1).normal(size=n) * h_scale
                ).astype(np.float32)
    u0, s0, e0 = _state(J, h, r, seed + 2)
    g = np.random.default_rng(seed + 3)
    unif = g.random((t, r, 4)).astype(np.float32)
    if temps is None:
        temps = np.broadcast_to(np.geomspace(12.0, 0.05, t).astype(
            np.float32)[:, None], (t, r)).copy()
    return J, h, (J, u0, s0, e0, unif, temps)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


def _invariants(J, h, out, t):
    u, s, e, be, bs, nf, rf = out
    prob = tising.IsingProblem.create(J, h)
    assert torch.equal(u, tising.local_fields(prob, s))
    assert torch.equal(e, tising.energy(prob, s))
    assert torch.equal(be, tising.energy(prob, bs))
    assert int(rf.sum()) == rf.numel() * t
    assert bool(((s == 1) | (s == -1)).all())


@pytest.mark.parametrize("n", [64, 250])
def test_local_field_plain_bitwise(n):
    J = _coupling(n, n, scale=3.0)
    h = np.rint(np.random.default_rng(1).normal(size=n)).astype(np.float32)
    s = np.where(np.random.default_rng(2).random((8, n)) < 0.5, 1, -1
                 ).astype(np.float32)
    got = local_field.local_field_init(*_torch((s, J, h)))
    want = jising.local_fields(jising.IsingProblem.create(J, h),
                               jnp.asarray(s))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.local_field_init(*map(jnp.asarray, (s, J, h)))),
        got.numpy())


def test_local_field_plain_close_for_real_j():
    g = np.random.default_rng(0)
    J = g.normal(size=(128, 128)).astype(np.float32)
    s = np.where(g.random((8, 128)) < 0.5, 1, -1).astype(np.float32)
    h = g.normal(size=128).astype(np.float32)
    got = local_field.local_field_init(*_torch((s, J, h)))
    np.testing.assert_allclose(got.numpy(), s @ J.T + h, rtol=1e-5,
                               atol=1e-4)


def _kernel_order_fields(s, J, h):
    """u = s Jᵀ + h summed in float32 in the CUDA kernel's order
    (``csrc/local_field.cu``): lane L of the row's warp adds its columns of
    each 1024-column tile, 4·L + 128·q + {0..3} where N is a multiple of 4,
    L + 32·q otherwise, one rounded product and one rounded add at a time;
    then the butterfly adds over 16, 8, 4, 2, 1 lanes, then h."""
    r, n = s.shape
    acc = np.zeros((32, r, n), np.float32)            # (lane, replica, row)
    for k0 in range(0, n, 1024):
        kn = min(1024, n - k0)
        for q in range(32):
            cols = (4 * np.arange(32)[:, None] + 128 * (q // 4) + q % 4
                    if n % 4 == 0 else np.arange(32)[:, None] + 32 * q)
            cols = cols[:, 0]
            for lane in np.flatnonzero(cols < kn):
                c = k0 + cols[lane]
                acc[lane] = acc[lane] + (s[:, c:c + 1] * J[:, c][None, :])
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ off]
    return acc[0] + h[None, :]


@pytest.mark.parametrize("n,r", [(250, 3), (1001, 2), (2000, 1)])
def test_local_field_kernel_order_exact_on_integer_j(n, r):
    """The CUDA kernel's summation order, emulated, equals the plain version
    bitwise on integer J and h (every partial sum is an exact integer)."""
    J = _coupling(n, n, scale=3.0)
    h = np.rint(np.random.default_rng(1).normal(size=n) * 4).astype(np.float32)
    s = np.where(np.random.default_rng(2).random((r, n)) < 0.5, 1, -1
                 ).astype(np.float32)
    want = local_field.local_field_init(*_torch((s, J, h))).numpy()
    np.testing.assert_array_equal(_kernel_order_fields(s, J, h), want)


@pytest.mark.parametrize("n,r", [(250, 3), (1001, 2), (2000, 1)])
def test_local_field_kernel_order_within_stated_bound(n, r):
    """Normal J, h and real-valued spins: the kernel's order, emulated in
    float32, stays within ``order_error_bound`` of the float64 product, and
    the bound is tight enough to matter (below 1e-4 of Σ|J s|)."""
    g = np.random.default_rng(n)
    J = g.normal(size=(n, n)).astype(np.float32)
    h = g.normal(size=n).astype(np.float32)
    s = g.normal(size=(r, n)).astype(np.float32)
    got = _kernel_order_fields(s, J, h).astype(np.float64)
    exact = s.astype(np.float64) @ J.astype(np.float64).T + h
    lim = local_field.order_error_bound(*_torch((s, J, h))).numpy()
    assert np.all(np.abs(got - exact) <= lim)
    mag = np.abs(s.astype(np.float64)) @ np.abs(J.astype(np.float64)).T
    assert np.all(lim <= 1e-4 * (mag + np.abs(h)))


RSA_VARIANTS = {
    "warm": dict(),
    "zero_t": dict(temps="zero"),
    "ladder": dict(temps="ladder"),
    "fields": dict(h_scale=2.0),
}


@pytest.mark.parametrize("n", [64, 250])
@pytest.mark.parametrize("variant", sorted(RSA_VARIANTS))
def test_rsa_pwl_plain_bitwise_with_reference_and_pallas(n, variant):
    opts = RSA_VARIANTS[variant]
    r, t = 8, 128
    temps = None
    if opts.get("temps") == "zero":
        temps = np.zeros((t, r), np.float32)
    elif opts.get("temps") == "ladder":
        temps = np.broadcast_to(np.geomspace(8.0, 0.1, r).astype(
            np.float32)[None, :], (t, r)).copy()
    J, h, args = _inputs(n, r, t, seed=n, temps=temps,
                         h_scale=opts.get("h_scale", 0.0))
    got = sweep.mcmc_sweep(*_torch(args), tpwl.pwl_table(), mode="rsa")
    jargs = tuple(map(jnp.asarray, args))
    want_ref = jref.mcmc_sweep(*jargs, jpwl.pwl_table(), mode="rsa")
    want_kernel = jkernel(*jargs, jpwl.pwl_table(), mode="rsa", block_r=4,
                          interpret=True)
    for name, a, b, c in zip(NAMES, want_ref + (None,), want_kernel, got):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), c.numpy(),
                                          err_msg=f"{name} vs ref")
        np.testing.assert_array_equal(np.asarray(b), c.numpy(),
                                      err_msg=f"{name} vs Pallas kernel")
    _invariants(J, h, got, t)


def test_gather_values_give_identical_results():
    _, _, args = _inputs(64, 8, 32, seed=1)
    outs = [sweep.mcmc_sweep(*_torch(args), tpwl.pwl_table(), mode="rwa",
                             gather=g) for g in sweep.GATHERS]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gather"):
        sweep.mcmc_sweep(*_torch(args), mode="rsa", gather="mxu")
    with pytest.raises(ValueError, match="mode"):
        sweep.mcmc_sweep(*_torch(args), mode="gibbs")
    with pytest.raises(ValueError, match="lane"):
        sweep.mcmc_sweep(*_torch(args), mode="rwa", lane=7)


STEP_VARIANTS = {
    "rwa_pwl": dict(mode="rwa", pwl=True, uniformized=False),
    "rwa_uniformized_pwl": dict(mode="rwa", pwl=True, uniformized=True),
    "rwa_exact": dict(mode="rwa", pwl=False, uniformized=False),
    "rwa_uniformized_exact": dict(mode="rwa", pwl=False, uniformized=True),
    "rsa_exact": dict(mode="rsa", pwl=False, uniformized=False),
}


@pytest.mark.parametrize("n", [64, 250])
@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
def test_one_step_from_512_states_agrees_except_near_ties(n, variant):
    v = STEP_VARIANTS[variant]
    r = 512
    g = np.random.default_rng(n + 17)
    temps = g.uniform(0.2, 3.0 * np.sqrt(n), size=(1, r)).astype(np.float32)
    J, h, args = _inputs(n, r, 1, seed=n + 5, temps=temps)
    jt = jpwl.pwl_table() if v["pwl"] else None
    tt = tpwl.pwl_table() if v["pwl"] else None
    kw = dict(mode=v["mode"], uniformized=v["uniformized"])
    got = sweep.mcmc_sweep(*_torch(args), tt, **kw)
    jargs = tuple(map(jnp.asarray, args))
    want_ref = jref.mcmc_sweep(*jargs, jt, **kw)
    want_kernel = jkernel(*jargs, jt, block_r=r, interpret=True, **kw)
    _, u0, s0, _, unif, _ = _torch(args)
    if v["mode"] == "rwa":
        p_all = common.flip_probability(2.0 * s0 * u0,
                                        torch.from_numpy(temps[0])[:, None],
                                        tt)
        tie = parity.roulette_near_tie(p_all, unif[0, :, 2], unif[0, :, 3],
                                       v["uniformized"]).numpy()
    else:
        j = common.site_from_uniform(unif[0, :, 0], n)
        rows = torch.arange(r)
        de = 2.0 * s0[rows, j] * u0[rows, j]
        p = common.flip_probability(de, torch.from_numpy(temps[0]), tt)
        gap = (unif[0, :, 1] - p).abs() / torch.abs(p).clamp_min(
            np.finfo(np.float32).tiny)
        tie = (gap <= 4 * 2.0 ** -23).numpy()
    keep = ~tie
    assert keep.sum() >= 0.9 * r
    for want in (want_ref, want_kernel):
        for name, a, b in zip(NAMES, want, got):
            np.testing.assert_array_equal(np.asarray(a)[keep],
                                          b.numpy()[keep],
                                          err_msg=f"{variant}:{name}")
    _invariants(J, h, got, 1)


@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
def test_invariants_hold_after_a_long_run(variant):
    v = STEP_VARIANTS[variant]
    J, h, args = _inputs(250, 8, 256, seed=9, h_scale=1.0)
    got = sweep.mcmc_sweep(*_torch(args),
                           tpwl.pwl_table() if v["pwl"] else None,
                           mode=v["mode"], uniformized=v["uniformized"])
    _invariants(J, h, got, 256)
    if v["mode"] == "rwa" and not v["uniformized"]:
        assert torch.equal(got[5], torch.full((8,), 256, dtype=torch.int32))


@pytest.mark.parametrize("mode,uniformized", [("rwa", False), ("rwa", True),
                                              ("rsa", False)])
def test_degenerate_total_matches_reference_bitwise(mode, uniformized):
    """All-ferromagnetic J at the all-up state and T=0: every ΔE > 0, so
    W = 0 — the RSA fallback or the uniformized null transition."""
    r, n, t = 8, 64, 48
    J = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    u0, s0, e0 = _state(J, np.zeros(n, np.float32), r, 0)
    s0[:] = 1.0
    u0 = (s0 @ J.T).astype(np.float32)
    e0 = (-0.5 * np.einsum("ri,ri->r", s0, u0)).astype(np.float32)
    unif = np.random.default_rng(0).random((t, r, 4)).astype(np.float32)
    args = (J, u0, s0, e0, unif, np.zeros((t, r), np.float32))
    got = sweep.mcmc_sweep(*_torch(args), tpwl.pwl_table(), mode=mode,
                           uniformized=uniformized)
    want = jref.mcmc_sweep(*map(jnp.asarray, args), jpwl.pwl_table(),
                           mode=mode, uniformized=uniformized)
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_interop_state_round_trip_feeds_a_chunk():
    """A mid-run JAX state crosses through interop and continues bitwise."""
    _, _, args = _inputs(64, 8, 64, seed=3)
    J, u0, s0, e0, unif, temps = args
    jargs = tuple(map(jnp.asarray, args))
    mid = jref.mcmc_sweep(jargs[0], *jargs[1:4], jargs[4][:32], jargs[5][:32],
                          jpwl.pwl_table(), mode="rsa")
    state = interop.state_from_numpy(tuple(np.asarray(x) for x in mid))
    assert [x.dtype for x in state] == list(interop.STATE_DTYPES)
    back = interop.state_to_numpy(state)
    for a, b in zip(mid, back):
        np.testing.assert_array_equal(np.asarray(a), b)
    u, s, e = state[:3]
    got = sweep.mcmc_sweep(torch.from_numpy(J), u, s, e,
                           torch.from_numpy(unif[32:].copy()),
                           torch.from_numpy(temps[32:].copy()),
                           tpwl.pwl_table(), mode="rsa")
    want = jref.mcmc_sweep(jargs[0], *mid[:3], jargs[4][32:], jargs[5][32:],
                           jpwl.pwl_table(), mode="rsa")
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_shared_memory_ceiling():
    """The split's limits. The earlier route (``sweep.cu``,
    ``pr16=True``): each of at most 8 blocks holds a slice of N/c spins (u,
    s, best_s) with the PWL table, the staged window and, for RWA, the
    slice's block sums and a lane buffer. RWA (``sweep_rwa.cu``): each of
    at most 16 blocks holds a subtree of tree_leaves(N)/c leaves of 128
    sites (u and p in f32, s and best_s in int8), the PWL table, two staged
    windows and the leaf sums, up to the port's ceiling. RSA
    (``sweep_rsa.cu``): each of at most 16 blocks holds a slice of a
    multiple of 128 sites (u in f32, s and best_s in int8) with a ring of 2
    to 4 row parts, up to the port's ceiling. Neither ceiling falls below
    the earlier route's."""
    assert sweep.shared_bytes(2000, 125, 64, True, pr16=True) == 4 * (
        3 * 2000 + 128 + 320 + 16 + 128)
    assert sweep.shared_bytes(16384, 128, 64, True, 8, pr16=True) == 4 * (
        3 * 2048 + 128 + 320 + 16 + 128)
    assert sweep.shared_bytes(2000, 125, 64, False, pr16=True) == 4 * (
        3 * 2000 + 128 + 320)
    assert sweep.shared_bytes(2000, 125, 64, True) == (
        10 * 2048 + 4 * 128 + 8 * 320 + 4 * 16)
    assert sweep.shared_bytes(16384, 128, 64, True, 8) == (
        10 * 2048 + 4 * 128 + 8 * 320 + 4 * 16)
    # RSA: 2,048 sites, a ring of 4 dense row parts (or B=1 plane words),
    # the table, the windows, 128 decision slots and the mbarriers.
    assert sweep.shared_bytes(2000, 125, 64, False) == (
        6 * 2048 + 4 * 4 * 2048 + 4 * 128 + 12 * 128 + 24 * 128 + 48)
    assert sweep.shared_bytes(16384, 128, 64, False, 8, num_planes=1) == (
        6 * 2048 + 4 * 2048 // 4 + 4 * 128 + 12 * 128 + 24 * 128 + 48)
    for rwa in (False, True):
        for pr16 in (False, True):
            if rwa and pr16:
                continue
            n = sweep.max_n(rwa, pr16=pr16)
            lane = common.default_lane(n)
            top = sweep.MAX_CLUSTER if pr16 else sweep.RWA_CLUSTERS[-1]
            assert top in sweep.widths(n, lane, 64, rwa, pr16)
            assert sweep.shared_bytes(n, lane, 64, rwa, top, pr16) <= \
                sweep.MAX_SHARED_BYTES
            assert 150_000 < n <= tcoupling.SWEEP_STATE_MAX_N
            # Past it no width fits.
            for m in range(n + 1, n + 64):
                assert not sweep.widths(m, common.default_lane(m), 64, rwa,
                                        pr16)
    assert sweep.max_n(True) >= sweep.max_n(True, pr16=True) > 150_000
    assert sweep.max_n(False) >= sweep.max_n(False, pr16=True) > 150_000
    # The rule of sweep.cu: RWA and dense RSA take the widest width that
    # fits; RSA on planes the narrowest whose slice one decode pass covers
    # (8192 spins).
    assert sweep.widths(16384, 128, 64, False, pr16=True) == [1, 2, 4, 8]
    assert sweep.widths(32768, 128, 64, False, pr16=True) == [2, 4, 8]
    assert sweep.cluster_width(32768, 128, 64, False, pr16=True) == 8
    assert sweep.cluster_width(2000, 125, 64, False, pr16=True) == 8
    assert sweep.cluster_width(16384, 128, 64, True, planes=True,
                               pr16=True) == 8
    for n, c in ((4096, 1), (16384, 2), (32768, 4), (65536, 8),
                 (131072, 8)):
        assert sweep.cluster_width(n, 128, 64, False, planes=True,
                                   pr16=True) == c
    assert sweep.widths(1001, 91, 64, True, pr16=True) == [1]
    assert sweep.widths(1001, 91, 64, True) == [1, 2, 4, 8]
    # The RSA kernel takes any width whose last block holds a site below N
    # (slices of 128 sites: 5, 6 and 7 blocks leave the last one empty).
    assert sweep.widths(1001, 91, 64, False) == [1, 2, 3, 4, 8]
    assert sweep.widths(16384, 128, 64, False) == [
        2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16]
    assert sweep.widths(16384, 128, 64, False, num_planes=1)[0] == 1
    for pr16 in (False, True):
        big = sweep.max_n(False, pr16=pr16) + 1024
        with pytest.raises(ValueError, match="cluster width"):
            sweep.cluster_width(big, common.default_lane(big), 64, False,
                                pr16=pr16)


def _keyed_inputs(n, r, t, seed):
    J, h, (J, u0, s0, e0, _, temps) = _inputs(n, r, t, seed)
    return J, h, _torch((J, u0, s0, e0, temps))


@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
@pytest.mark.parametrize("chunk", [0, 5])
def test_keyed_sweep_plain_equals_sweep_on_the_drawn_uniforms(variant, chunk):
    """On the CPU the keyed entry (the solve's) is ``ref.mcmc_sweep`` fed
    ``rng.uniform01(rng.stream(base, SWEEP, c), (T, R, 4))``; T = 100 is not
    a multiple of the kernel's 64-step window."""
    v = STEP_VARIANTS[variant]
    r, t = 8, 100
    J, h, (tj, u0, s0, e0, temps) = _keyed_inputs(64, r, t, seed=21)
    tbl = tpwl.pwl_table() if v["pwl"] else None
    base = trng.fold_in(trng.key(0), 2**31 + 5)
    words = trng.words(base)
    kw = dict(mode=v["mode"], uniformized=v["uniformized"])
    got = sweep.mcmc_sweep_keyed(tj, u0, s0, e0, words, chunk, temps, tbl,
                                 **kw)
    unif = trng.uniform01(trng.stream(base, trng.Salt.SWEEP, chunk),
                          (t, r, 4))
    want = tref.mcmc_sweep(tj, u0, s0, e0, unif, temps, tbl, **kw)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name
    _invariants(J, h, got, t)


@pytest.mark.parametrize("kind", ["geometric", "linear"])
@pytest.mark.parametrize("steps,chunk_steps", [(20000, 256), (1000, 256),
                                               (777, 100), (64, 256)])
def test_solve_temperature_table_slices_equal_chunk_temps(kind, steps,
                                                          chunk_steps):
    """The (steps, R) table copied once per solve, sliced per chunk, is
    ``chunk_temps`` bitwise, the remainder chunk included."""
    sched = getattr(tsched, kind)(16.0, 0.05, steps)
    cfg = SolverConfig(num_steps=steps, schedule=sched, num_replicas=8)
    chunk_len, chunks = ops.chunk_list(cfg, chunk_steps)
    table = ops.anneal_temps(cfg, chunk_len, chunks, "cpu")
    assert table.shape == (steps, 8) and table.is_contiguous()
    for c, clen in chunks:
        part = table[c * chunk_len:c * chunk_len + clen]
        assert part.is_contiguous()
        assert torch.equal(part, ops.chunk_temps(cfg, c, clen, chunk_len,
                                                 "cpu")), (c, clen)
