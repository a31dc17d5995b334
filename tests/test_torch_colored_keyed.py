"""The keyed colored sweep and its shape rule, on the CPU.

* ``ref.colored_uniforms`` (the plain version of the card's in-kernel
  draw) equals ``rng.uniform01(stream(base, SWEEP, chunk), (T, R, S))``
  bitwise at every class slot, and reads 1 (never accepted) elsewhere.
* ``ops.colored_sweep_chunk`` on the keyed entry equals the chunk on
  host-drawn uniforms and the JAX package's ``colored_sweep_chunk`` (the
  Pallas kernel in interpret mode), seed for seed, across chunk
  boundaries: a χ=2 torus and a small sparse graph, on the dense,
  ``bitplane`` and ``bitplane_hbm`` tiers, PWL with integer J and h.
* ``colored_anneal``, with its temperature and class-schedule tables made
  once per solve, still equals JAX's ``colored_anneal``.
* The width rule: every cluster width fits one block's shared memory and
  leaves the last block a nonempty slice, also where N does not split
  into equal whole words; the rule's pick is one of them; past
  ``colored_max_n`` it raises, naming the ceiling.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core import rng as jrng
from repro.core.pwl import pwl_table as jpwl_table
from repro.core.schedules import linear as jlinear
from repro.core.solver import SolverConfig as JConfig
from repro.graphs import sparse_bipolar_edges as jsparse
from repro.graphs import torus_grid_edges as jtorus
from repro.graphs.coloring import greedy_coloring as jcoloring
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import ising as tising
from repro_torch.core import pwl as tpwl
from repro_torch.core import rng
from repro_torch.graphs import sparse_bipolar_edges, torus_grid_edges
from repro_torch.kernels import ops, ref, sweep

TIERS = ("dense", "bitplane", "bitplane_hbm")
GRAPHS = {
    "torus": (lambda: jtorus(8, 8, seed=5),
              lambda: torus_grid_edges(8, 8, seed=5)),
    "sparse": (lambda: jsparse(96, 400, seed=11),
               lambda: sparse_bipolar_edges(96, 400, seed=11)),
}
STATE = ("fields", "spins", "energy", "best_energy", "best_spins",
         "num_flips")
FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy", "rows_fetched")


def _configs(steps, trace_every, fmt):
    jcfg = JConfig(steps, jlinear(3.0, 0.1, steps), mode="rsa",
                   num_replicas=4, trace_every=trace_every,
                   flip_mode="colored", coupling_format=fmt)
    return jcfg, interop.config_from_dict(dataclasses.asdict(jcfg))


def _assert_results(jres, tres, msg):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jres, name)),
                                      getattr(tres, name).numpy(),
                                      err_msg=f"{msg}:{name}")


def _plans(graph, fmt):
    """The reference's colored plan and the port's plan carried from it,
    with integer h."""
    jedges, tedges = GRAPHS[graph][0](), GRAPHS[graph][1]()
    n = tedges.num_spins
    h = np.round(np.linspace(-2, 2, n)).astype(np.float32)
    if fmt == "dense":
        jprob = jising.IsingProblem.create(np.asarray(jedges.to_dense()), h)
        tprob = tising.IsingProblem.create(tedges.to_dense(), h)
    else:
        jprob = jising.IsingProblem.create_sparse(jedges, h=h)
        tprob = tising.IsingProblem.create_sparse(tedges, h=h)
    jplan = jops.ColoredPlan(jcoloring(jprob.coupling_source), jprob, fmt)
    planes = None
    if jplan.store.planes is not None:
        planes = (np.asarray(jplan.store.planes.pos),
                  np.asarray(jplan.store.planes.neg))
    col = jplan.coloring
    tplan = interop.colored_plan_from_numpy(col.colors, col.perm,
                                            col.offsets, tprob, fmt, planes)
    return jplan, tplan, jprob, tprob


def _state(jplan, r, seed):
    """A consistent (u, s, e, best_e, best_s, num_flips) of the permuted
    problem, as numpy arrays."""
    g = np.random.default_rng(seed)
    J = (np.asarray(jplan.problem.couplings) if jplan.problem.edges is None
         else np.asarray(jplan.problem.edges.to_dense()))
    h = np.asarray(jplan.problem.fields)
    s = np.where(g.random((r, J.shape[0])) < 0.5, 1.0, -1.0).astype(
        np.float32)
    u = (s @ J.T + h[None, :]).astype(np.float32)
    e = (-0.5 * np.einsum("ri,ri->r", s, s @ J.T) - s @ h).astype(np.float32)
    return (u, s, e, e.copy(), s.copy(), np.zeros(r, np.int32))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("seed,chunk", [(0, 0), (7, 3), (2**32 - 1, 1000)])
def test_colored_uniforms_equal_uniform01_at_class_slots(graph, seed, chunk):
    _, tplan, _, _ = _plans(graph, "bitplane")
    n, win, t, r = tplan.coloring.num_spins, tplan.window, 37, 5
    sched = ops.colored_class_schedule(tplan.wstarts, tplan.offsets,
                                       tplan.sizes, torch.arange(t) + 11)
    base = rng.fold_in(rng.key(0), seed)
    words = rng.words(base)
    got = ref.colored_uniforms(words, chunk, sched, r, win, n)
    assert got.shape == (t, r, win) and got.dtype == torch.float32
    want = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, chunk), (t, r, win))
    w = sched[:, 0].clamp(0, n - win).to(torch.int64)
    idx = w[:, None] + torch.arange(win)[None, :]
    klass = ((idx >= sched[:, 1:2]) & (idx < sched[:, 1:2] + sched[:, 2:3]))
    klass = klass[:, None, :].expand(t, r, win)
    assert int(klass.sum()) > 0
    assert torch.equal(got[klass], want[klass])
    assert bool((got[~klass] == 1.0).all())


@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_keyed_chunks_equal_host_drawn_and_jax(graph, fmt):
    """Three 16-step chunks from one state: the keyed chunk, the chunk on
    uniforms drawn on the host and JAX's chunk agree bitwise after each."""
    jplan, tplan, _, _ = _plans(graph, fmt)
    r, clen, seed = 8, 16, 5
    base = rng.fold_in(rng.key(0), seed)
    words = rng.words(base)
    jbase = jax.random.fold_in(jax.random.key(0), seed)
    temps = np.broadcast_to(np.geomspace(3.0, 0.1, 3 * clen).astype(
        np.float32)[:, None], (3 * clen, r)).copy()
    sched = ops.colored_class_schedule(tplan.wstarts, tplan.offsets,
                                       tplan.sizes, torch.arange(3 * clen))
    jop = (jnp.asarray(jplan.problem.couplings) if fmt == "dense"
           else jplan.store.kernel_operand)
    op = tplan.store.kernel_operand
    init = _state(jplan, r, seed=3)
    jstate = tuple(jnp.asarray(x) for x in init)
    keyed = tuple(torch.from_numpy(x.copy()) for x in init)
    drawn = keyed
    for c in range(3):
        rows = slice(c * clen, (c + 1) * clen)
        t_temps = torch.from_numpy(temps[rows])
        jstate, jrf = jops.colored_sweep_chunk(
            jop, jstate, jrng.stream(jbase, jrng.Salt.SWEEP, c), clen,
            jnp.asarray(temps[rows]), jnp.asarray(sched[rows].numpy()),
            window=jplan.window, pwl_table=jpwl_table(), block_r=4,
            coupling=fmt, with_rows_fetched=True, interpret=True)
        before = sweep.colored_counter.count
        keyed, krf = ops.colored_sweep_chunk(
            op, keyed, words, c, t_temps, sched[rows], window=tplan.window,
            pwl_table=tpwl.pwl_table(), block_r=4, coupling=fmt,
            with_rows_fetched=True)
        assert sweep.colored_counter.count == before   # the plain version
        unif = rng.uniform01(rng.stream(base, rng.Salt.SWEEP, c),
                             (clen, r, tplan.window))
        out = sweep.colored_sweep(op, *drawn[:3], unif, t_temps, sched[rows],
                                  tpwl.pwl_table(), coupling=fmt, block_r=4)
        drawn, drf = ops._merge(drawn, out, True)
        for name, a, b, d in zip(STATE, jstate, keyed, drawn):
            np.testing.assert_array_equal(
                np.asarray(a, np.float32), b.to(torch.float32).numpy(),
                err_msg=f"chunk {c} {name}: keyed against JAX")
            assert torch.equal(b, d), (c, name)
        np.testing.assert_array_equal(np.asarray(jrf), krf.numpy())
        assert torch.equal(krf, drf)
    assert int(keyed[5].sum()) > 0


@pytest.mark.parametrize("fmt", TIERS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_colored_anneal_with_solve_tables_equals_jax(graph, fmt):
    """300 untraced steps in 128-step chunks (a remainder chunk of 44), and
    240 steps traced every 80: the once-per-solve tables give JAX's
    solve."""
    _, _, jprob, tprob = _plans(graph, fmt)
    jcfg, tcfg = _configs(steps=300, trace_every=0, fmt=fmt)
    jres = jops.colored_anneal(jprob, 2, jcfg, chunk_steps=128)
    tres = ops.colored_anneal(tprob, 2, tcfg, chunk_steps=128, device="cpu")
    _assert_results(jres, tres, f"{graph}/{fmt}")
    jcfg, tcfg = _configs(steps=240, trace_every=80, fmt=fmt)
    _assert_results(jops.colored_anneal(jprob, 9, jcfg),
                    ops.colored_anneal(tprob, 9, tcfg, device="cpu"),
                    f"{graph}/{fmt} traced")


def test_solve_tables_are_the_chunks_own():
    """The once-per-solve tables' row slices equal each chunk's own
    temperatures and class schedule, bitwise."""
    _, tplan, _, _ = _plans("sparse", "bitplane")
    _, cfg = _configs(steps=300, trace_every=0, fmt="bitplane")
    chunk_len, chunks = ops.chunk_list(cfg, 128)
    temps = ops.anneal_temps(cfg, chunk_len, chunks, "cpu")
    sched = ops.colored_class_schedule(tplan.wstarts, tplan.offsets,
                                       tplan.sizes,
                                       torch.arange(temps.shape[0]))
    assert [c for c, _ in chunks] == [0, 1, 2] and chunks[-1][1] == 44
    for c, clen in chunks:
        rows = slice(c * chunk_len, c * chunk_len + clen)
        assert torch.equal(temps[rows], ops.chunk_temps(cfg, c, clen,
                                                        chunk_len, "cpu"))
        own = ops.colored_class_schedule(
            tplan.wstarts, tplan.offsets, tplan.sizes,
            c * chunk_len + torch.arange(clen))
        assert torch.equal(sched[rows], own)
        assert temps[rows].is_contiguous() and sched[rows].is_contiguous()


@pytest.mark.parametrize("n,window,r,dense", [
    (16384, 3072, 8, False), (16384, 3072, 8, True), (1024, 512, 8, False),
    (2048, 384, 6, True), (300, 64, 8, False), (96, 96, 4, True),
    (32768, 3072, 8, False), (65536, 6144, 16, False),
    (20000, 3072, 8, False), (100000, 3072, 32, False)])
def test_colored_shapes_fit(n, window, r, dense):
    """Every width's blocks cover N in whole words, the last one nonempty,
    and fit one block's shared memory; the rule picks one of them."""
    widths = sweep.colored_widths(n, window, 64, dense)
    assert widths
    for c in widths:
        assert c in sweep.COLORED_WIDTHS
        nc = sweep.colored_slice_len(n, c)
        assert nc == n if c == 1 else nc % 32 == 0
        assert (c - 1) * nc < n <= c * nc
        assert sweep.colored_shared_bytes(n, window, 64, c, dense) <= \
            sweep.MAX_SHARED_BYTES
    assert sweep.colored_width(n, window, 64, r, dense) in widths
    for c in widths:
        assert sweep.colored_ring(n, window, 64, c, dense) >= \
            sweep.COLORED_MIN_RING
    # The earlier kernel's block (its state and list) halves with the
    # slice; the route's ring takes what the state leaves over.
    if n % 64 == 0:
        assert sweep.colored_shared_bytes(n, window, 64, 2, dense,
                                          pr17=True) < \
            sweep.colored_shared_bytes(n, window, 64, 1, dense, pr17=True)


def test_colored_shape_rule_and_ceiling():
    # The earlier kernel's rule (colored_sweep.cu, forced with pr17): the
    # widest width whose R·C blocks the card's SMs hold.
    old = dict(pr17=True)
    assert sweep.colored_width(16384, 3072, 64, 8, **old) == 16
    assert sweep.colored_width(16384, 3072, 64, 8, dense=True, **old) == 16
    assert sweep.colored_width(16384, 3072, 64, 32, **old) == 4
    assert sweep.colored_width(1024, 512, 64, 8, **old) == 16
    assert sweep.colored_width(4096, 2048, 64, 8, **old) == 16
    assert sweep.colored_width(20000, 3072, 64, 8, **old) == 16
    assert sweep.colored_widths(300, 64, 64, **old) == [1, 2, 4]
    assert sweep.colored_width(300, 64, 64, 8, **old) == 4
    assert sweep.colored_widths(20000, 3072, 64, **old) == [2, 4, 8, 16]
    # The route's rule: the widest width whose R clusters the card holds
    # at once (sweep.COLORED_CLUSTERS_HELD: 7 of 16 blocks, 9 of 9, 15 of
    # 8), on the planes one whose slice is whole 16-byte runs of words
    # where one is.
    assert sweep.colored_width(16384, 3072, 64, 8) == 8
    assert sweep.colored_width(16384, 3072, 64, 8, dense=True) == 9
    assert sweep.colored_width(16384, 3072, 64, 7) == 16
    assert sweep.colored_width(16384, 3072, 64, 32) == 2
    # Small N takes the widest width that fits, down to 32-spin slices.
    assert sweep.colored_widths(300, 64, 64) == [1, 2, 3, 4, 5, 10]
    assert sweep.colored_width(300, 64, 64, 8) == 3
    assert sweep.colored_width(1024, 512, 64, 8) == 8
    assert sweep.colored_width(4096, 2048, 64, 8) == 8
    # Past the SMs: the narrowest width that fits.
    assert sweep.colored_width(16384, 3072, 64, 256) == 1
    assert sweep.colored_width(100000, 3072, 64, 32, **old) == 8
    assert sweep.colored_width(100000, 3072, 64, 32) == 6
    # N=20,000 splits into no equal whole words: a shorter last slice.
    assert sweep.colored_widths(20000, 3072, 64)[::6] == [2, 8, 14]
    assert sweep.colored_slice_len(20000, 16) == 1280
    assert 20000 - 15 * 1280 == 800
    assert sweep.colored_width(20000, 3072, 64, 8) == 9
    # N=16384 fits one block; N=32768 no longer does (the old ceiling,
    # ~18.8k at S=3072, held all of N in one block) but fits a cluster.
    assert 1 in sweep.colored_widths(16384, 3072, 64)
    assert 1 not in sweep.colored_widths(32768, 3072, 64)
    assert sweep.colored_widths(32768, 3072, 64)
    # The earlier kernel's ceiling (colored_sweep.cu, forced with pr17);
    # the route's ring takes the room of its accepted-slot list, so its
    # ceiling is a little higher.
    old = sweep.colored_max_n(3072, pr17=True)
    assert 16 * 18100 > old > 16 * 17000 and old % (32 * 16) == 0
    top = sweep.colored_max_n(3072)
    assert top >= old and top % (32 * 16) == 0
    for n in (3072, 18000, 18900, 20000, 100000, 123457, top - 1, top):
        assert sweep.colored_widths(n, 3072, 64), n
    assert not sweep.colored_widths(top + 1, 3072, 64)
    with pytest.raises(ValueError, match="colored_max_n") as err:
        sweep.colored_width(top + 1, 3072, 64, 8)
    assert str(top) in str(err.value) and "item" not in str(err.value)
    # A bigger window holds a bigger list and mailboxes: a lower ceiling.
    assert sweep.colored_max_n(16384) < top


def test_keyed_entry_checks():
    jplan, tplan, _, tprob = _plans("torus", "bitplane")
    u, s, e = (torch.from_numpy(x) for x in _state(jplan, 4, 0)[:3])
    temps = torch.ones((4, 4))
    sched = ops.colored_class_schedule(tplan.wstarts, tplan.offsets,
                                       tplan.sizes, torch.arange(4))
    op = tplan.store.kernel_operand
    words = rng.words(rng.key(1))
    with pytest.raises(ValueError, match="sched"):
        sweep.colored_sweep_keyed(op, u, s, e, words, 0, temps, sched[:3],
                                  window=tplan.window, coupling="bitplane")
    with pytest.raises(ValueError, match="window"):
        sweep.colored_sweep_keyed(op, u, s, e, words, 0, temps, sched,
                                  window=tprob.num_spins + 1,
                                  coupling="bitplane")
    with pytest.raises(ValueError, match="CUDA"):
        sweep.colored_sweep_at_width(1, op, u, s, e, temps, sched,
                                     base_words=words, window=tplan.window,
                                     coupling="bitplane")
    with pytest.raises(ValueError, match="not both"):
        sweep.colored_sweep_at_width(1, op, u, s, e, temps, sched,
                                     coupling="bitplane")

