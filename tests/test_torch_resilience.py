"""The port's resilient supervisor (``repro_torch.core.resilience``): the
port of ``tests/test_resilience.py`` and ``tests/test_chunk_plan.py``
without tempering and meshes, on the CPU.

* ``run_resilient`` equals the monolithic solve bitwise (every result
  field) on the dense, ``bitplane`` and ``bitplane_hbm`` tiers, colored
  and reference, and equals the JAX package's ``run_resilient`` bitwise on
  the anchor (RSA + PWL, integer J and h) for each path the port's tests
  already hold bitwise to JAX.
* Resume from every chunk boundary equals the uninterrupted run; corrupt,
  truncated and mismatched snapshots fall back or are refused; budgets and
  interrupts stop with the best-so-far and resume to parity.
* The tier ladder moves between device tiers only, on allocation failures
  only (``torch.cuda.OutOfMemoryError`` among them), records every
  downgrade, and leaves no reference to the failed tier's store.
* The chunk plan covers the steps exactly and each chunk's key is a pure
  function of (seed, chunk index), equal to JAX's.

The fault helpers are the JAX suite's own (``tests/fault_injection.py``).
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core import rng as jrng
from repro.core import schedules as jschedules
from repro.core.resilience import run_resilient as jrun_resilient
from repro.core.solver import SolverConfig as JConfig
from repro_torch import interop
from repro_torch.checkpoint import snapshot_steps
from repro_torch.core import backend as tbackend
from repro_torch.core import ising, rng, schedules
from repro_torch.core.resilience import (STOP_COMPLETED, STOP_DEADLINE,
                                         STOP_INTERRUPTED, STOP_MAX_STEPS,
                                         STOP_TARGET, BudgetConfig,
                                         inject_faults, is_allocation_failure,
                                         next_tier, run_resilient)
from repro_torch.core.solver import (SolverConfig, anneal_chunk_plan,
                                     chunk_list, solve)
from repro_torch.kernels import ops

from fault_injection import (SimulatedCrash, corrupt_snapshot, fake_oom,
                             kill_after_chunk_hook, oom_once_hook)

N = 64
STEPS = 120
TRACE = 20          # -> 6 chunks
REPLICAS = 4
FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy", "rows_fetched")
#: The trajectory: what every tier computes alike (rows_fetched is the
#: tier's own telemetry: bitplane_hbm counts unique rows).
TRAJECTORY = FIELDS[:-1]


def _problem(offset=1.5):
    g = np.random.default_rng(0)
    J = np.clip(np.rint(g.normal(size=(N, N)) * 1.5), -3, 3)
    J = np.triu(J, 1)
    J = J + J.T
    h = g.normal(size=(N,)).astype(np.float32)
    return ising.IsingProblem.create(J, h, offset=offset)


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _cfg(mode="rwa", fmt="auto", flip_mode="single"):
    return SolverConfig(num_steps=STEPS,
                        schedule=schedules.linear(3.0, 0.1, STEPS),
                        mode=mode, num_replicas=REPLICAS, trace_every=TRACE,
                        coupling_format=fmt, flip_mode=flip_mode)


def _assert_same(mono, got, fields=FIELDS):
    for field in fields:
        a, b = getattr(mono, field), getattr(got, field)
        if a is None or b is None:
            assert a is None and b is None, field
            continue
        assert torch.equal(a, b), field


def _run(problem, cfg, **kw):
    return run_resilient(problem, 7, cfg, device="cpu", **kw)


def _mono(problem, cfg, backend="auto"):
    return solve(problem, 7, cfg, backend, device="cpu")


def _interrupted_then_resumed(problem, config, tmp_path, boundary, *,
                              backend="auto"):
    run_dir = str(tmp_path / f"run_b{boundary}")
    with pytest.raises(SimulatedCrash):
        _run(problem, config, run_dir=run_dir, backend=backend,
             on_event=kill_after_chunk_hook(boundary))
    res = _run(problem, config, run_dir=run_dir, backend=backend)
    assert res.resumed_from_chunk == boundary
    assert res.stop_reason == STOP_COMPLETED
    return res


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("fmt,mode", [("dense", "rsa"), ("dense", "rwa"),
                                      ("bitplane", "rwa"),
                                      ("bitplane_hbm", "rsa"),
                                      ("bitplane_hbm", "rwa")])
def test_resilient_matches_monolithic_fused(problem, fmt, mode):
    cfg = _cfg(mode, fmt)
    res = _run(problem, cfg)
    assert res.stop_reason == STOP_COMPLETED
    assert res.chunks_done == res.total_chunks == STEPS // TRACE
    assert res.steps_done == STEPS
    _assert_same(_mono(problem, cfg, "fused"), res.result)


@pytest.mark.parametrize("fmt", ["dense", "bitplane", "bitplane_hbm"])
def test_resilient_matches_monolithic_colored(problem, fmt):
    cfg = _cfg("rsa", fmt, "colored")
    res = _run(problem, cfg)
    _assert_same(_mono(problem, cfg, "colored"), res.result)


@pytest.mark.parametrize("mode", ["rsa", "rwa"])
def test_resilient_matches_monolithic_reference(problem, mode):
    cfg = _cfg(mode)
    res = _run(problem, cfg, backend="reference")
    assert res.stop_reason == STOP_COMPLETED
    _assert_same(_mono(problem, cfg, "reference"), res.result)


def test_untraced_run_covers_remainder_chunk(problem):
    cfg = SolverConfig(num_steps=STEPS,
                       schedule=schedules.linear(3.0, 0.1, STEPS),
                       num_replicas=REPLICAS)
    mono = ops.fused_anneal(problem, 7, cfg, chunk_steps=50, device="cpu")
    res = _run(problem, cfg, chunk_steps=50)
    assert res.total_chunks == 3 and res.steps_done == STEPS
    _assert_same(mono, res.result)


def _anchor():
    """Integer J and h, RSA + PWL: the path held bitwise to JAX."""
    g = np.random.default_rng(4)
    J = np.triu(np.rint(g.normal(size=(N, N)) * 1.5), 1)
    J = (J + J.T).astype(np.float32)
    h = np.rint(g.normal(size=N)).astype(np.float32)
    return J, h, -2.0


@pytest.mark.parametrize("backend,fmt,flip_mode", [
    ("fused", "dense", "single"), ("fused", "bitplane", "single"),
    ("fused", "bitplane_hbm", "single"), ("colored", "bitplane", "colored"),
    ("reference", "auto", "single")])
def test_resilient_equals_jax_on_the_anchor(tmp_path, backend, fmt,
                                            flip_mode):
    J, h, offset = _anchor()
    jcfg = JConfig(num_steps=STEPS, schedule=jschedules.linear(
        12.0, 0.05, STEPS), mode="rsa", num_replicas=REPLICAS,
        trace_every=TRACE, coupling_format=fmt, flip_mode=flip_mode)
    jres = jrun_resilient(jising.IsingProblem.create(J, h, offset=offset), 5,
                          jcfg, run_dir=str(tmp_path / "jax"),
                          backend=backend).result
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    tprob = interop.problem_from_numpy(J, h, offset)
    run_dir = str(tmp_path / "port")
    with pytest.raises(SimulatedCrash):
        run_resilient(tprob, 5, tcfg, run_dir, backend=backend, device="cpu",
                      on_event=kill_after_chunk_hook(2))
    res = run_resilient(tprob, 5, tcfg, run_dir, backend=backend,
                        device="cpu")
    assert res.resumed_from_chunk == 2
    for field in TRAJECTORY:
        np.testing.assert_array_equal(np.asarray(getattr(jres, field)),
                                      getattr(res.result, field).numpy(),
                                      err_msg=field)


# ---------------------------------------------------------------- resume

def test_resume_parity_every_boundary(problem, tmp_path):
    cfg = _cfg("rwa", "bitplane")
    mono = _mono(problem, cfg, "fused")
    for boundary in range(1, STEPS // TRACE):
        res = _interrupted_then_resumed(problem, cfg, tmp_path, boundary)
        _assert_same(mono, res.result)


@pytest.mark.parametrize("fmt,mode", [("dense", "rsa"),
                                      ("bitplane_hbm", "rwa")])
def test_resume_parity_one_boundary(problem, tmp_path, fmt, mode):
    cfg = _cfg(mode, fmt)
    res = _interrupted_then_resumed(problem, cfg, tmp_path, 2)
    _assert_same(_mono(problem, cfg, "fused"), res.result)


def test_resume_parity_reference_every_boundary(problem, tmp_path):
    cfg = _cfg("rwa")
    mono = _mono(problem, cfg, "reference")
    for boundary in range(1, STEPS // TRACE):
        res = _interrupted_then_resumed(problem, cfg, tmp_path, boundary,
                                        backend="reference")
        _assert_same(mono, res.result)


def test_resume_parity_colored_every_boundary(problem, tmp_path):
    cfg = _cfg("rsa", "bitplane_hbm", "colored")
    mono = _mono(problem, cfg, "colored")
    for boundary in range(1, STEPS // TRACE):
        res = _interrupted_then_resumed(problem, cfg, tmp_path, boundary)
        _assert_same(mono, res.result)


def test_snapshot_state_round_trips(problem, tmp_path):
    """A snapshot restores every state tensor with its dtype and values."""
    from repro_torch.checkpoint import restore

    run_dir = str(tmp_path / "run")
    for backend, cfg in (("fused", _cfg("rwa", "bitplane")),
                         ("reference", _cfg("rsa"))):
        runner = tbackend.get_backend(backend).runner(problem, 7, cfg,
                                                      device="cpu")
        state = runner.run_chunk(runner.init(), 0)
        res = _run(problem, cfg, run_dir=run_dir + backend, backend=backend,
                   budget=BudgetConfig(max_steps=TRACE))
        assert res.chunks_done == 1
        got = restore(run_dir + backend, 1, {"state": runner.init(),
                                             "trace": np.zeros((1, 4))})
        assert type(got["state"]) is type(state)
        for a, b in zip(state, got["state"]):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------ corruption

def test_corrupt_newest_snapshot_falls_back(problem, tmp_path):
    cfg = _cfg("rwa", "bitplane")
    run_dir = str(tmp_path / "run")
    with pytest.raises(SimulatedCrash):
        _run(problem, cfg, run_dir=run_dir, keep=10,
             on_event=kill_after_chunk_hook(4))
    assert snapshot_steps(run_dir) == [1, 2, 3, 4]
    corrupt_snapshot(run_dir, 4, how="flip")
    events = []
    res = _run(problem, cfg, run_dir=run_dir, keep=10,
               on_event=lambda k, i: events.append(k))
    assert res.resumed_from_chunk == 3
    assert "snapshot_corrupt" in events
    _assert_same(_mono(problem, cfg, "fused"), res.result)


@pytest.mark.parametrize("how", ["truncate", "manifest", "legacy_empty"])
def test_all_snapshots_corrupt_restarts_fresh(problem, tmp_path, how):
    cfg = _cfg("rwa", "bitplane")
    run_dir = str(tmp_path / f"run_{how}")
    with pytest.raises(SimulatedCrash):
        _run(problem, cfg, run_dir=run_dir,
             on_event=kill_after_chunk_hook(3))
    for step in snapshot_steps(run_dir):
        corrupt_snapshot(run_dir, step, how=how)
    res = _run(problem, cfg, run_dir=run_dir)
    assert res.resumed_from_chunk is None
    assert res.stop_reason == STOP_COMPLETED
    _assert_same(_mono(problem, cfg, "fused"), res.result)


def test_legacy_snapshot_truncated_npz_falls_back(problem, tmp_path):
    cfg = _cfg("rwa", "bitplane")
    run_dir = str(tmp_path / "run")
    with pytest.raises(SimulatedCrash):
        _run(problem, cfg, run_dir=run_dir, keep=10,
             on_event=kill_after_chunk_hook(4))
    corrupt_snapshot(run_dir, 4, how="legacy_empty")
    events = []
    res = _run(problem, cfg, run_dir=run_dir, keep=10,
               on_event=lambda k, i: events.append(k))
    assert res.resumed_from_chunk == 3
    assert "snapshot_corrupt" in events
    _assert_same(_mono(problem, cfg, "fused"), res.result)


def test_mismatched_run_dir_is_refused(problem, tmp_path):
    cfg = _cfg("rwa", "bitplane")
    run_dir = str(tmp_path / "run")
    with pytest.raises(SimulatedCrash):
        _run(problem, cfg, run_dir=run_dir, on_event=kill_after_chunk_hook(2))
    with pytest.raises(ValueError, match="signature mismatch"):
        _run(problem, _cfg("rsa", "bitplane"), run_dir=run_dir)
    with pytest.raises(ValueError, match="mismatch"):
        run_resilient(problem, 8, cfg, run_dir, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        _run(_problem(offset=2.5), cfg, run_dir=run_dir)


def test_run_identity_is_hashed_once_and_only_with_a_run_dir(
        problem, tmp_path, monkeypatch):
    """The problem's fingerprint (a dense J copied to the host and hashed)
    is made once for a run with snapshots, and not at all without."""
    from repro_torch.core import resilience

    calls = []
    real = resilience.problem_fingerprint
    monkeypatch.setattr(resilience, "problem_fingerprint",
                        lambda p: calls.append(1) or real(p))
    cfg = _cfg("rwa", "dense")
    mono = _mono(problem, cfg)
    _assert_same(mono, _run(problem, cfg).result)
    assert calls == []
    _assert_same(mono, _run(problem, cfg, run_dir=str(tmp_path / "r"))
                 .result)
    assert calls == [1]
    fp = real(problem)
    assert resilience.run_signature(
        problem, 7, cfg, backend="fused", chunk_steps=256,
        fingerprint=fp) == resilience.run_signature(
            problem, 7, cfg, backend="fused", chunk_steps=256)


def test_build_event_reports_the_runner(problem):
    """Each runner build is an event carrying its tier and host seconds,
    and the runner (the CLI reads the colored plan from it)."""
    events = []
    cfg = dataclasses.replace(_cfg("rsa", "bitplane"), flip_mode="colored")
    res = _run(problem, cfg, on_event=lambda k, i: events.append((k, i)))
    builds = [i for k, i in events if k == "build"]
    assert len(builds) == 1 and builds[0]["fmt"] == "bitplane"
    assert builds[0]["seconds"] >= 0 and builds[0]["chunk"] == 0
    plan = builds[0]["runner"].plan
    assert plan.store.fmt == "bitplane" and plan.window > 0
    _assert_same(_mono(problem, cfg), res.result)


# --------------------------------------------------------------- budgets

def test_budget_max_steps(problem):
    res = _run(problem, _cfg("rwa", "bitplane"),
               budget=BudgetConfig(max_steps=40))
    assert res.stop_reason == STOP_MAX_STEPS
    assert res.steps_done == 40 and res.chunks_done == 2
    assert bool(torch.isfinite(res.result.best_energy).all())
    assert res.result.trace_energy.shape == (2, REPLICAS)


def test_budget_deadline(problem):
    res = _run(problem, _cfg("rwa", "bitplane"),
               budget=BudgetConfig(deadline_seconds=0.0))
    assert res.stop_reason == STOP_DEADLINE
    assert res.chunks_done == 0


def test_budget_target_energy(problem):
    cfg = _cfg("rwa", "bitplane")
    res = _run(problem, cfg, budget=BudgetConfig(target_energy=1e9))
    assert res.stop_reason == STOP_TARGET and res.chunks_done == 0
    res = _run(problem, cfg, budget=BudgetConfig(target_energy=-1e9))
    assert res.stop_reason == STOP_COMPLETED


def test_budget_stop_then_resume_to_parity(problem, tmp_path):
    cfg = _cfg("rwa", "bitplane")
    run_dir = str(tmp_path / "run")
    res = _run(problem, cfg, run_dir=run_dir,
               budget=BudgetConfig(max_steps=60))
    assert res.stop_reason == STOP_MAX_STEPS and res.chunks_done == 3
    res = _run(problem, cfg, run_dir=run_dir)
    assert res.resumed_from_chunk == 3
    assert res.stop_reason == STOP_COMPLETED
    _assert_same(_mono(problem, cfg, "fused"), res.result)


def test_keyboard_interrupt_returns_best_so_far(problem, tmp_path):
    cfg = _cfg("rwa", "bitplane")
    run_dir = str(tmp_path / "run")

    def interrupt(kind, info):
        if kind == "chunk" and info["chunk"] == 2:
            raise KeyboardInterrupt()

    res = _run(problem, cfg, run_dir=run_dir, on_event=interrupt)
    assert res.stop_reason == STOP_INTERRUPTED
    assert res.chunks_done == 2
    assert res.result.trace_energy.shape == (2, REPLICAS)
    res = _run(problem, cfg, run_dir=run_dir)
    assert res.resumed_from_chunk == 2
    _assert_same(_mono(problem, cfg, "fused"), res.result)


# ---------------------------------------------------------- tier ladder

def test_is_allocation_failure_classification():
    assert is_allocation_failure(fake_oom())
    assert is_allocation_failure(MemoryError("x"))
    assert is_allocation_failure(torch.cuda.OutOfMemoryError("no message"))
    assert is_allocation_failure(RuntimeError("Failed to allocate 8 bytes"))
    assert is_allocation_failure(RuntimeError(
        "CUDA out of memory. Tried to allocate 200.00 GiB"))
    assert not is_allocation_failure(ValueError("J must be symmetric"))
    # A kernel's launch or build failure is a fault to report, not a tier
    # to leave.
    assert not is_allocation_failure(RuntimeError(
        "mcmc_sweep launch failed: CUDA error 2"))
    assert not is_allocation_failure(RuntimeError(
        "nvcc failed building sweep.cu: room for one more register"))


def test_next_tier_ladder(problem):
    assert next_tier("dense", problem) == "bitplane"
    assert next_tier("bitplane", problem) == "bitplane_hbm"
    assert next_tier("bitplane_hbm", problem) is None
    frac = ising.IsingProblem.create(
        np.array([[0.0, 0.5], [0.5, 0.0]], np.float32))
    assert next_tier("dense", frac) is None


def test_downgrade_chain_on_build_oom(problem):
    cfg = _cfg("rwa", "auto")
    with inject_faults(oom_once_hook("store_build",
                                     fmts=("dense", "bitplane"))):
        res = _run(problem, cfg)
    assert [d[:2] for d in res.downgrades] == [
        ("dense", "bitplane"), ("bitplane", "bitplane_hbm")]
    _assert_same(_mono(problem, cfg, "fused"), res.result, TRAJECTORY)


def test_downgrade_on_a_real_torch_oom_error(problem):
    cfg = _cfg("rsa", "auto")

    def hook(site, info):
        if site == "store_build" and info["fmt"] == "dense":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    with inject_faults(hook):
        res = _run(problem, cfg)
    assert res.downgrades == (("dense", "bitplane", 0),)
    _assert_same(_mono(problem, cfg, "fused"), res.result, TRAJECTORY)


def test_downgrade_midrun_restores_from_snapshot(problem, tmp_path):
    cfg = _cfg("rwa", "auto")
    run_dir = str(tmp_path / "run")
    events = []
    with inject_faults(oom_once_hook("chunk_start", at_chunk=3)):
        res = _run(problem, cfg, run_dir=run_dir,
                   on_event=lambda k, i: events.append((k, i)))
    assert res.downgrades == (("dense", "bitplane", 3),)
    assert "tier_downgrade" in [k for k, _ in events]
    assert any(k == "resume" and i["chunk"] == 3 for k, i in events)
    _assert_same(_mono(problem, cfg, "fused"), res.result, TRAJECTORY)
    res2 = _run(problem, cfg, run_dir=run_dir)
    assert res2.downgrades == (("dense", "bitplane", 3),)


def test_downgrade_drops_the_failed_tier(problem, monkeypatch):
    """After a mid-run downgrade nothing holds the failed runner or its
    store: the next tier's build sees the memory the failed one held."""
    built = []
    original = tbackend.FusedBackend.runner

    def recording(self, *args, **kw):
        runner = original(self, *args, **kw)
        built.append((runner.fmt, weakref.ref(runner),
                      weakref.ref(runner.store.kernel_operand)))
        return runner

    monkeypatch.setattr(tbackend.FusedBackend, "runner", recording)
    with inject_faults(oom_once_hook("chunk_start", at_chunk=2)):
        res = _run(problem, _cfg("rwa", "auto"))
    assert res.downgrades == (("dense", "bitplane", 2),)
    assert [fmt for fmt, _, _ in built] == ["dense", "bitplane"]
    gc.collect()
    # The dense store is the problem's own J, which the caller holds; the
    # failed runner itself must be gone.
    assert built[0][1]() is None
    assert built[1][1]() is None and built[1][2]() is None


def test_explicit_format_propagates_oom(problem):
    with inject_faults(oom_once_hook("store_build", fmts=("dense",))):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            _run(problem, _cfg("rwa", "dense"))


def test_ladder_ends_at_bitplane_hbm(problem):
    with inject_faults(oom_once_hook("store_build", fmts=(
            "dense", "bitplane", "bitplane_hbm"))):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            _run(problem, _cfg("rwa", "auto"))


@pytest.mark.parametrize("error", [ValueError("some real bug"),
                                   RuntimeError("mcmc_sweep launch failed: "
                                                "CUDA error 700")])
def test_non_alloc_error_propagates(problem, error):
    def bad(site, info):
        if site == "chunk_start":
            raise error

    with inject_faults(bad):
        with pytest.raises(type(error), match=str(error)[:12]):
            _run(problem, _cfg("rwa", "auto"))


# ----------------------------------------- ports of tests/test_chunk_plan.py

def _pcfg(num_steps: int, trace_every: int) -> SolverConfig:
    return SolverConfig(num_steps=num_steps,
                        schedule=schedules.linear(3.0, 0.1, num_steps),
                        num_replicas=2, trace_every=trace_every)


def _cases(seed, n, *, traced):
    g = np.random.default_rng(seed)
    for _ in range(n):
        num_steps = int(g.integers(1, 5000))
        chunk_steps = int(g.integers(1, 700))
        trace_every = int(g.integers(1, 400)) if traced else 0
        yield num_steps, chunk_steps, trace_every


def test_untraced_chunks_exactly_cover_num_steps():
    for num_steps, chunk_steps, _ in _cases(0, 300, traced=False):
        cl, nc, rem = anneal_chunk_plan(_pcfg(num_steps, 0), chunk_steps)
        case = f"num_steps={num_steps} chunk_steps={chunk_steps}"
        assert cl * nc + rem == num_steps, case
        assert 1 <= cl <= max(min(chunk_steps, num_steps), 1), case
        assert nc >= 1 and 0 <= rem < cl, case


def test_traced_chunks_follow_trace_cadence():
    for num_steps, chunk_steps, trace_every in _cases(1, 300, traced=True):
        cfg = _pcfg(num_steps, trace_every)
        cl, nc, rem = anneal_chunk_plan(cfg, chunk_steps)
        assert cl == trace_every and rem == 0
        assert nc == max(num_steps // trace_every, 1)
        assert anneal_chunk_plan(cfg, chunk_steps * 2 + 1) == (cl, nc, rem)


def test_plan_is_deterministic_and_units_cover_the_steps():
    for num_steps, chunk_steps, trace_every in _cases(2, 200, traced=False):
        cfg = _pcfg(num_steps, trace_every)
        assert ops.anneal_chunk_plan is anneal_chunk_plan
        chunk_len, chunks = chunk_list(cfg, chunk_steps)
        assert chunk_list(cfg, chunk_steps) == (chunk_len, chunks)
        assert sum(n for _, n in chunks) == num_steps
        assert [c for c, _ in chunks] == list(range(len(chunks)))


def _chunk_key(seed: int, c: int) -> np.ndarray:
    return rng.stream(rng.fold_in(rng.key(0), seed), rng.Salt.SWEEP,
                      c).numpy()


def test_chunk_keys_equal_jax_and_are_distinct():
    keys = []
    for seed in (0, 1, 5, 2**31, 2**32 - 1):
        base = jax.random.fold_in(jax.random.key(0), np.uint32(seed))
        for c in range(64):
            want = np.asarray(jax.random.key_data(
                jrng.stream(base, jrng.Salt.SWEEP, c)))
            got = _chunk_key(seed, c)
            np.testing.assert_array_equal(want, got)
            keys.append(got)
    keys = np.stack(keys)
    assert len(np.unique(keys, axis=0)) == len(keys)


def test_chunk_keys_are_pure_functions_of_seed_and_index():
    g = np.random.default_rng(3)
    for _ in range(50):
        seed = int(g.integers(0, 2**32))
        c = int(g.integers(0, 10_000))
        first = _chunk_key(seed, c)
        _chunk_key(seed, c + 1), _chunk_key(seed + 1, c)
        np.testing.assert_array_equal(first, _chunk_key(seed, c))


def test_chunk_uniforms_match_contiguous_stream_slices():
    """Chunk c's uniforms drawn alone are what a whole run draws for it, and
    the keyed sweep's plain draw (the card's kernel mirrors it) reads the
    same numbers."""
    from repro_torch.kernels import ref

    r = 4
    for seed in (0, 11):
        base = rng.fold_in(rng.key(0), seed)
        words = rng.words(base)
        per_chunk = [rng.uniform01(rng.stream(base, rng.Salt.SWEEP, c),
                                   (8, r, 4)) for c in range(5)]
        for c, u in enumerate(per_chunk):
            assert torch.equal(u, ref.sweep_uniforms(words, c, 8, r))
        flat = torch.stack([u.flatten() for u in per_chunk])
        assert len(torch.unique(flat, dim=0)) == len(flat)


def test_async_snapshot_write_errors_surface(tmp_path):
    """A write that fails on the manager's thread raises from ``wait``."""
    from repro_torch.checkpoint import CheckpointManager

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the run directory should be")
    mgr = CheckpointManager(str(blocker), async_save=True)
    mgr.save(1, {"state": (torch.zeros(3),)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()   # the error is raised once
