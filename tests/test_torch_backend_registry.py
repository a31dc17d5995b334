"""The port's backend registry (``repro_torch.core.backend``): the port of
``tests/test_backend_registry.py`` over its seven registered paths.

Every registered path is a ``Backend`` and holds the driver contract
through the registry alone, on the CPU:

* **runner / monolithic parity**: the chunked runner driven to the end
  equals ``Backend.run`` bitwise, every ``SolveResult`` field
  (``rows_fetched`` included: the fused and colored runners carry it in
  their state);
* **resume parity**: a mid-run state handed to a freshly built runner
  continues to the same result bitwise (no RNG state lives in a runner).

The parity tests parametrize over ``backend_names()``, so a path that
registers joins them ("tempering" with a ``TemperingConfig``, its units
swap rounds; "distributed" with a ``DistSolverConfig``). The mesh paths
("sharded", "sharded_2d", "distributed") run on a gloo world of 1 in this
process: a (spins=1) mesh, and a degenerate (groups=1, rows=1) mesh that
still runs the 2-D code path; without a mesh they raise.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import ising, schedules
from repro_torch.core.backend import (BACKENDS, Backend, backend_names,
                                      capability_rows, fallback_enabled,
                                      get_backend, resolve_backend)
from repro_torch.core.resilience import STOP_COMPLETED, run_resilient
from repro_torch.core.solver import SolverConfig, solve
from repro_torch.core.tempering import TemperingConfig
from repro_torch.distributed import DistSolverConfig
from repro_torch.distributed import mesh as M

N = 64
STEPS = 120
TRACE = 20
REPLICAS = 4

#: Every execution path the port ships.
EXPECTED = ("colored", "distributed", "fused", "reference", "sharded",
            "sharded_2d", "tempering")
#: The paths that run on a mesh.
LATER = ("sharded", "sharded_2d", "distributed")


def _problem():
    g = np.random.default_rng(0)
    J = np.clip(np.rint(g.normal(size=(N, N)) * 1.5), -3, 3)
    J = np.triu(J, 1)
    J = J + J.T
    h = g.normal(size=(N,)).astype(np.float32)
    return ising.IsingProblem.create(J, h, offset=1.5)


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module")
def meshes():
    """A gloo world of 1 in this process and its two meshes."""
    M.init_world("gloo", rank=0, world_size=1, device_type="cpu")
    try:
        yield {"1d": M.build_mesh("1", "cpu"),
               "2d": M.build_mesh("1x1", "cpu")}
    finally:
        dist.destroy_process_group()


def _mesh(meshes, name):
    """The mesh backend ``name`` runs on (None off the mesh paths)."""
    if name == "sharded_2d":
        return meshes["2d"]
    return meshes["1d"] if name in LATER else None


def _scfg(**kw):
    return SolverConfig(num_steps=STEPS,
                        schedule=schedules.linear(3.0, 0.1, STEPS),
                        mode="rwa", num_replicas=REPLICAS, trace_every=TRACE,
                        **kw)


def _tcfg(**kw):
    return TemperingConfig(num_steps=STEPS, t_min=0.1, t_max=3.0,
                           num_replicas=REPLICAS, swap_every=TRACE,
                           mode="rwa", backend="fused", **kw)


def _setup(name):
    if name == "tempering":
        return _tcfg()
    if name == "distributed":
        return DistSolverConfig(base=_scfg(), exchange_every=2,
                                backend="fused")
    return _scfg(flip_mode="colored") if name == "colored" else _scfg()


def _untraced(name):
    """A 600-step config whose plan is three units: 256-step chunks with a
    remainder, or three 200-step swap rounds (the distributed solve's plan
    is 64-step chunks, nine of them)."""
    if name == "tempering":
        return dataclasses.replace(_tcfg(), num_steps=600, swap_every=200)
    if name == "distributed":
        return dataclasses.replace(_setup(name), base=dataclasses.replace(
            _scfg(), num_steps=600, trace_every=0))
    return dataclasses.replace(_setup(name), num_steps=600, trace_every=0)


def _assert_same(mono, got):
    assert type(mono) is type(got)
    for field in mono._fields:
        a, b = getattr(mono, field), getattr(got, field)
        if a is None or b is None:
            assert a is None and b is None, field
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _drive(runner, *, state=None, rows=None, start=0, stop=None):
    if state is None:
        state = runner.init()
    rows = list(rows or [])
    stop = runner.total_units if stop is None else stop
    for k in range(start, stop):
        state = runner.run_chunk(state, k)
        if runner.collect_trace:
            rows.append(runner.trace_row(state))
    return state, rows


class TestRoster:
    def test_every_execution_path_is_registered(self):
        assert backend_names() == EXPECTED
        for name in backend_names():
            assert isinstance(get_backend(name), Backend)
            assert get_backend(name).name == name
            assert BACKENDS[name] is get_backend(name)

    def test_unknown_backend_error_lists_the_registry(self):
        with pytest.raises(ValueError, match="registered backends are"):
            get_backend("nope")
        for name in backend_names():
            with pytest.raises(ValueError, match=name):
                get_backend("nope")

    @pytest.mark.parametrize("name", LATER)
    def test_later_backends_raise_naming_their_item(self, name, problem):
        """The mesh paths resolve; without a mesh every entry raises,
        naming what it needs."""
        backend = get_backend(name)
        assert backend.name == name and backend.capabilities.needs_mesh
        cfg = _setup(name)
        with pytest.raises(ValueError, match="needs a .*mesh"):
            solve(problem, 0, cfg, backend=name, device="cpu")
        with pytest.raises(ValueError, match="needs a .*mesh"):
            backend.runner(problem, 0, cfg, device="cpu")
        with pytest.raises(ValueError, match="needs a .*mesh"):
            run_resilient(problem, 0, cfg, backend=name, device="cpu")

    def test_capability_table_covers_every_backend(self):
        rows = capability_rows()
        assert [r[0] for r in rows] == list(backend_names())
        caps = {n: get_backend(n).capabilities for n in backend_names()}
        assert caps["reference"].fixed_fmt == "dense"
        assert not caps["reference"].edge_list
        assert not caps["reference"].auto
        assert not caps["reference"].tier_fallback
        assert caps["fused"].edge_list and caps["fused"].tier_fallback
        assert caps["fused"].supports_store
        assert caps["colored"].edge_list and caps["colored"].tier_fallback
        assert not caps["colored"].supports_store
        assert caps["tempering"].edge_list and caps["tempering"].tier_fallback
        assert caps["tempering"].supports_store
        assert caps["tempering"].fixed_fmt is None
        for name, c in caps.items():
            assert c.supports_resume, "every registered path must resume"
            assert c.needs_mesh == (name in LATER)
        assert caps["sharded"].fixed_fmt == "bitplane_sharded"
        assert caps["sharded_2d"].fixed_fmt == "bitplane_sharded_2d"
        assert not caps["sharded_2d"].auto
        for name in LATER:
            assert caps[name].edge_list and not caps[name].tier_fallback
            assert not caps[name].supports_store

    def test_auto_resolves_from_config(self, meshes):
        assert resolve_backend(_scfg(), mesh=meshes["1d"]) == "sharded"
        # A 2-D mesh still resolves to "sharded" (its driver takes
        # multi-dim meshes); "sharded_2d" is named explicitly.
        assert resolve_backend(_scfg(), mesh=meshes["2d"]) == "sharded"
        assert resolve_backend(_setup("distributed"),
                               mesh=meshes["1d"]) == "distributed"
        assert resolve_backend(_setup("distributed")) == "distributed"
        assert resolve_backend(_scfg()) == "fused"
        assert resolve_backend(_scfg(flip_mode="colored")) == "colored"
        assert resolve_backend(_tcfg()) == "tempering"
        assert resolve_backend(_scfg(), "reference") == "reference"
        with pytest.raises(TypeError, match="unrecognized config"):
            resolve_backend(object())
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(_scfg(), "nope")

    def test_config_type_mismatch_is_rejected(self):
        for name in backend_names():
            cls = get_backend(name).config_cls().__name__
            with pytest.raises(TypeError, match=cls):
                get_backend(name).check_config({"num_steps": 1})
        with pytest.raises(TypeError, match="TemperingConfig"):
            get_backend("tempering").check_config(_scfg())
        with pytest.raises(TypeError, match="SolverConfig"):
            get_backend("fused").check_config(_tcfg())

    def test_tempering_is_registered_and_resolves_from_its_config(
            self, problem):
        """"tempering" left the later slices: registered, the "auto" path
        of a ``TemperingConfig`` (alone: no ``SolverConfig`` reaches it),
        and it refuses colored flips on every entry."""
        assert isinstance(get_backend("tempering"), Backend)
        assert resolve_backend(_tcfg()) == "tempering"
        assert resolve_backend(_tcfg(), "tempering") == "tempering"
        assert resolve_backend(_scfg()) != "tempering"
        colored = _tcfg(flip_mode="colored")
        with pytest.raises(ValueError, match="single-flip"):
            get_backend("tempering").run(problem, 0, colored, device="cpu")
        with pytest.raises(ValueError, match="single-flip"):
            get_backend("tempering").runner(problem, 0, colored,
                                            device="cpu")
        with pytest.raises(ValueError, match="single-flip"):
            run_resilient(problem, 0, colored, device="cpu")

    def test_tier_fallback_needs_auto_and_the_capability(self):
        assert fallback_enabled(_tcfg(), "tempering")
        assert not fallback_enabled(_tcfg(coupling_format="dense"),
                                    "tempering")
        assert fallback_enabled(_scfg(), "fused")
        assert not fallback_enabled(_scfg(coupling_format="dense"), "fused")
        assert not fallback_enabled(_scfg(), "reference")

    def test_solve_dispatches_through_the_registry(self, problem):
        cfg = _scfg()
        _assert_same(solve(problem, 7, cfg, "auto", device="cpu"),
                     solve(problem, 7, cfg, device="cpu"))
        colored = _scfg(flip_mode="colored")
        _assert_same(solve(problem, 7, colored, "auto", device="cpu"),
                     solve(problem, 7, colored, "colored", device="cpu"))
        with pytest.raises(ValueError, match="single-flip"):
            get_backend("reference").run(problem, 7, colored, device="cpu")
        with pytest.raises(ValueError, match="color-sorted"):
            get_backend("colored").run(problem, 7, colored, device="cpu",
                                       store=object())
        with pytest.raises(ValueError, match="dense J"):
            get_backend("reference").run(problem, 7, cfg, device="cpu",
                                         store=object())


@pytest.mark.parametrize("name", backend_names())
class TestRegistryParity:
    def test_chunked_runner_matches_monolithic(self, problem, meshes, name):
        backend = get_backend(name)
        cfg, mesh = _setup(name), _mesh(meshes, name)
        mono = backend.run(problem, 7, cfg, mesh=mesh, device="cpu")
        runner = backend.runner(problem, 7, cfg, mesh=mesh, device="cpu")
        state, rows = _drive(runner)
        _assert_same(mono, runner.finalize(state, rows))

    def test_untraced_runner_matches_monolithic(self, problem, meshes, name):
        """Untraced: the runner's plan is its ``chunk_steps`` with a
        remainder chunk; the monolithic solve's default plan is 256 steps,
        so the runner takes the same."""
        backend = get_backend(name)
        cfg, mesh = _untraced(name), _mesh(meshes, name)
        mono = backend.run(problem, 3, cfg, mesh=mesh, device="cpu")
        runner = backend.runner(problem, 3, cfg, mesh=mesh, device="cpu")
        assert runner.total_units == (600 // 64 if name == "distributed"
                                      else 3)
        _assert_same(mono, runner.finalize(*_drive(runner)))

    def test_fresh_runner_resumes_bit_identically(self, problem, meshes,
                                                  name):
        backend = get_backend(name)
        cfg, mesh = _setup(name), _mesh(meshes, name)
        runner = backend.runner(problem, 7, cfg, mesh=mesh, device="cpu")
        assert runner.total_units >= 2, "parity needs a real chunk split"
        split = runner.total_units // 2
        state, rows = _drive(runner, stop=split)
        resumed = backend.runner(problem, 7, cfg, mesh=mesh, device="cpu")
        state, rows = _drive(resumed, state=state, rows=rows, start=split)
        _assert_same(backend.run(problem, 7, cfg, mesh=mesh, device="cpu"),
                     resumed.finalize(state, rows))


def test_resilient_supervisor_accepts_every_registered_backend(problem,
                                                                 meshes):
    for name in backend_names():
        res = run_resilient(problem, 7, _setup(name), backend=name,
                            mesh=_mesh(meshes, name), device="cpu")
        assert res.stop_reason == STOP_COMPLETED, name
        assert bool(torch.isfinite(res.result.best_energy).all())
