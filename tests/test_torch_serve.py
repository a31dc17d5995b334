"""The port's serving layer (``repro_torch.serve``) against the contracts of
``tests/test_serve.py`` and against the JAX package's ``repro.serve``.

* Every contract of ``tests/test_serve.py``, on the port with
  ``device="cpu"``: exact energies under padding, the "vmap" lane equal to
  its solo solve, span slicing of the "stack" lane, zero re-encodes on a
  warm instance, a met target answered without a launch, admission.
* Cross-package parity: ``coupling_digest`` and ``problem_digest`` give
  the same strings; ``bucket_spins``, ``bucket_replicas`` and
  ``plan_batches`` the same plans on a seeded random mix; one burst
  (stack, vmap, single, budgeted and cached lanes) drained by both
  services on the anchor (RSA + PWL, linear schedule, integer J and h,
  N = 48 padded to 64) gives per ticket the same lane, cache hits and stop
  reason, bitwise the same ``best_energy``, ``best_spins`` and
  ``num_flips``, and the same ``stats``.
* The store cache hands back a store already on its device; without a
  card a service with no device raises, and ``mesh=`` raises naming its
  ROADMAP item.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core.resilience import BudgetConfig as JBudget
from repro.core.schedules import linear as jlinear
from repro.core.solver import SolverConfig as JConfig
from repro import serve as jserve
from repro_torch import interop
from repro_torch.core import coupling, ising, schedules
from repro_torch.core.resilience import BudgetConfig
from repro_torch.core.solver import SolverConfig, solve
from repro_torch.serve import (AdmissionError, LRUStoreCache, ServeConfig,
                               SolveRequest, SolverService, WarmStartCache,
                               bucket_replicas, bucket_spins,
                               coupling_digest, pad_problem, plan_batches,
                               problem_digest)

N = 48
STEPS = 96
REPLICAS = 2
CPU = "cpu"


def _arrays(seed: int = 0):
    rng = np.random.default_rng(seed)
    J = rng.integers(-3, 4, size=(N, N)).astype(np.float32)
    J = np.round((J + J.T) / 2)
    np.fill_diagonal(J, 0)
    h = rng.integers(-2, 3, size=N).astype(np.float32)
    return J, h


def _problem(seed: int = 0) -> ising.IsingProblem:
    return ising.IsingProblem.create(*_arrays(seed))


def _cfg(**kw) -> SolverConfig:
    base = dict(num_steps=STEPS,
                schedule=schedules.geometric(3.0, 0.1, STEPS), mode="rsa",
                num_replicas=REPLICAS, trace_every=16)
    base.update(kw)
    return SolverConfig(**base)


def _edge_problem(seed: int) -> ising.IsingProblem:
    prob = _problem(seed)
    J = prob.couplings.numpy()
    rows, cols = np.nonzero(np.triu(J, 1))
    return ising.IsingProblem.create_sparse(
        ising.EdgeList.create(rows, cols, J[rows, cols], num_spins=N),
        prob.fields.numpy())


def _service(config: ServeConfig = ServeConfig()) -> SolverService:
    return SolverService(config, device=CPU)


class TestBuckets:
    def test_spin_buckets_round_up(self):
        assert bucket_spins(1) == 64
        assert bucket_spins(64) == 64
        assert bucket_spins(65) == 128
        assert bucket_spins(300) == 384
        assert bucket_spins(16384) == 16384
        assert bucket_spins(16385) == 32768
        with pytest.raises(ValueError):
            bucket_spins(0)

    def test_replica_buckets_power_of_two(self):
        assert [bucket_replicas(r) for r in (1, 2, 3, 5, 8, 9)] == \
            [1, 2, 4, 8, 8, 16]
        with pytest.raises(ValueError):
            bucket_replicas(0)


class TestPadding:
    def test_padded_energies_exact(self):
        prob = _problem(3)
        padded = pad_problem(prob, 64)
        assert padded.num_spins == 64 and padded.device == prob.device
        rng = np.random.default_rng(0)
        s = rng.choice(np.asarray([-1.0, 1.0], np.float32), size=N)
        s_pad = np.concatenate([s, rng.choice(
            np.asarray([-1.0, 1.0], np.float32), size=64 - N)])
        assert float(ising.energy(prob, torch.from_numpy(s))) == \
            float(ising.energy(padded, torch.from_numpy(s_pad)))

    def test_pad_noop_and_shrink_rejected(self):
        prob = _problem(3)
        assert pad_problem(prob, N) is prob
        with pytest.raises(ValueError, match="pad"):
            pad_problem(prob, N - 1)

    def test_edge_list_padding_stays_dense_j_free(self):
        ep = _edge_problem(4)
        padded = pad_problem(ep, 64)
        assert padded.couplings is None and padded.num_spins == 64
        assert padded.edges.nnz == ep.edges.nnz
        assert torch.equal(padded.fields[:N], ep.fields)
        assert not bool(padded.fields[N:].any())

    def test_padding_matches_jax(self):
        J, h = _arrays(5)
        jp = jserve.pad_problem(jising.IsingProblem.create(J, h, offset=2.5),
                                64)
        tp = pad_problem(interop.problem_from_numpy(J, h, 2.5), 64)
        np.testing.assert_array_equal(np.asarray(jp.couplings),
                                      tp.couplings.numpy())
        np.testing.assert_array_equal(np.asarray(jp.fields),
                                      tp.fields.numpy())
        assert float(jp.offset) == tp.offset
        assert jserve.problem_digest(jp) == problem_digest(tp)


@dataclasses.dataclass
class Req:
    problem_key: str
    config: object
    seed: object = None


class TestPlanBatches:
    def test_seed_free_same_instance_stacks(self):
        cfg = _cfg()
        plans = plan_batches([Req("p1", cfg) for _ in range(3)])
        assert len(plans) == 1 and plans[0].kind == "stack"
        assert plans[0].spans == ((0, 2), (2, 2), (4, 2))
        assert plans[0].launch_replicas == 8
        assert plans[0].config.num_replicas == 8

    def test_pinned_seeds_take_the_vmap_lane(self):
        cfg = _cfg()
        plans = plan_batches([Req("p1", cfg, seed=i) for i in range(3)])
        assert len(plans) == 1 and plans[0].kind == "vmap"
        assert len(plans[0].requests) == 3

    def test_distinct_instances_never_mix(self):
        cfg = _cfg()
        plans = plan_batches([Req("p1", cfg), Req("p2", cfg),
                              Req("p1", cfg)])
        assert sorted(p.kind for p in plans) == ["single", "stack"]
        stack = next(p for p in plans if p.kind == "stack")
        assert all(r.problem_key == "p1" for r in stack.requests)

    def test_config_mismatch_splits_groups(self):
        plans = plan_batches([Req("p1", _cfg()), Req("p1", _cfg(mode="rwa"))])
        assert sorted(p.kind for p in plans) == ["single", "single"]

    def test_flip_mode_mismatch_never_stacks(self):
        reqs = [Req("p1", _cfg()), Req("p1", _cfg()),
                Req("p1", _cfg(flip_mode="colored")),
                Req("p1", _cfg(flip_mode="colored"))]
        plans = plan_batches(reqs)
        assert sorted(p.kind for p in plans) == ["stack", "stack"]
        assert sorted({p.config.flip_mode for p in plans}) == \
            ["colored", "single"]
        for p in plans:
            assert {r.config.flip_mode for r in p.requests} == \
                {p.config.flip_mode}

    def test_stack_cap_splits_launches(self):
        cfg = _cfg(num_replicas=100)
        plans = plan_batches([Req("p1", cfg) for _ in range(3)],
                             max_stack_replicas=256)
        assert sorted(p.kind for p in plans) == ["single", "stack"]

    def test_lone_pinned_seed_launches_single(self):
        plans = plan_batches([Req("p1", _cfg(), seed=5)])
        assert len(plans) == 1 and plans[0].kind == "single"

    def test_buckets_and_plans_match_jax_on_a_random_mix(self):
        """A seeded mix of 60 requests over 3 problems, 2 modes, 1-40
        replicas and pinned or free seeds: both packages plan the same
        launches (kinds, requests, spans, widths), as do the buckets."""
        rng = np.random.default_rng(7)
        sizes = rng.integers(1, 40000, 200)
        assert [jserve.bucket_spins(int(n)) for n in sizes] == \
            [bucket_spins(int(n)) for n in sizes]
        assert [jserve.bucket_replicas(int(r)) for r in sizes[:50] % 300 + 1] \
            == [bucket_replicas(int(r)) for r in sizes[:50] % 300 + 1]
        mix = [(f"p{rng.integers(3)}", ("rsa", "rwa")[rng.integers(2)],
                int(rng.integers(1, 41)),
                None if rng.random() < 0.6 else int(rng.integers(3)))
               for _ in range(60)]

        def plans(cfg_cls, sched, planner):
            reqs = [Req(key, cfg_cls(num_steps=STEPS, schedule=sched,
                                     mode=mode, num_replicas=r), seed)
                    for key, mode, r, seed in mix]
            index = {id(r): i for i, r in enumerate(reqs)}
            return [(p.kind, tuple(index[id(r)] for r in p.requests),
                     p.spans, p.launch_replicas, p.config.num_replicas)
                    for p in planner(reqs, max_stack_replicas=64)]

        want = plans(JConfig, jlinear(3.0, 0.1, STEPS), jserve.plan_batches)
        got = plans(SolverConfig, schedules.linear(3.0, 0.1, STEPS),
                    plan_batches)
        assert got == want
        assert {k for k, *_ in got} == {"stack", "vmap", "single"}


class TestServiceLanes:
    def test_vmap_lane_bit_identical_to_solo_solve(self):
        prob = _problem(1)
        cfg = _cfg()
        svc = _service()
        t1 = svc.submit(SolveRequest(prob, cfg, seed=11))
        t2 = svc.submit(SolveRequest(prob, cfg, seed=12))
        out = svc.drain()
        assert out[t1].batched == "vmap" and out[t2].batched == "vmap"
        padded = pad_problem(prob, bucket_spins(N))
        for ticket, seed in ((t1, 11), (t2, 12)):
            ref = solve(padded, seed, cfg, backend="fused", device=CPU)
            got = out[ticket].result
            assert torch.equal(ref.best_energy, got.best_energy)
            assert torch.equal(ref.best_spins[:, :N], got.best_spins)
            assert torch.equal(ref.num_flips, got.num_flips)
            assert torch.equal(ref.rows_fetched, got.rows_fetched)

    def test_stack_lane_slices_spans_to_request_shape(self):
        prob = _problem(1)
        svc = _service()
        t1 = svc.submit(SolveRequest(prob, _cfg()))
        t2 = svc.submit(SolveRequest(prob, _cfg(num_replicas=3)))
        out = svc.drain()
        assert out[t1].batched == "stack" and out[t2].batched == "stack"
        assert out[t1].result.best_energy.shape == (REPLICAS,)
        assert out[t1].result.best_spins.shape == (REPLICAS, N)
        assert out[t2].result.best_energy.shape == (3,)
        assert out[t2].result.trace_energy.shape == (STEPS // 16, 3)
        assert out[t2].result.rows_fetched is None
        assert svc.stats["launches"] == 1
        # Exact for the sliced spins on the unpadded instance.
        for t in (t1, t2):
            res = out[t].result
            assert torch.equal(ising.energy(prob, res.best_spins),
                               res.best_energy)
        # The launch is the solo solve of the padded problem at the first
        # ticket id and the bucketed width, sliced span by span.
        ref = solve(pad_problem(prob, 64), t1, _cfg(num_replicas=8),
                    device=CPU)
        assert torch.equal(ref.best_spins[2:5, :N],
                           out[t2].result.best_spins)
        assert torch.equal(ref.num_flips[:2], out[t1].result.num_flips)

    def test_batching_off_launches_singly_same_results(self):
        prob = _problem(1)
        cfg = _cfg()
        svc = _service(ServeConfig(batching=False))
        t1 = svc.submit(SolveRequest(prob, cfg, seed=11))
        out = svc.drain()
        assert out[t1].batched == "single"
        ref = solve(pad_problem(prob, bucket_spins(N)), 11, cfg,
                    backend="fused", device=CPU)
        assert torch.equal(ref.best_energy, out[t1].result.best_energy)

    def test_colored_and_edge_list_requests_run_singly(self):
        ep = _edge_problem(6)
        svc = _service()
        cfg = _cfg(flip_mode="colored", coupling_format="bitplane")
        t1 = svc.submit(SolveRequest(ep, cfg, seed=3, backend="colored"))
        t2 = svc.submit(SolveRequest(ep, _cfg(coupling_format="bitplane")))
        out = svc.drain()
        assert out[t1].batched == "single" and not out[t1].store_hit
        assert out[t2].batched == "single"
        dense = ising.IsingProblem.create(ep.edges.to_dense(),
                                          ep.fields.numpy())
        for t in (t1, t2):
            res = out[t].result
            assert res.best_spins.shape == (REPLICAS, N)
            assert torch.equal(ising.energy(dense, res.best_spins),
                               res.best_energy)


class TestServiceCaches:
    def test_warm_instance_solves_reencode_nothing(self, monkeypatch):
        calls = {"n": 0}
        real = coupling.encode_couplings

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)
        monkeypatch.setattr(coupling, "encode_couplings", counting)
        prob = _problem(2)
        cfg = _cfg(coupling_format="bitplane")
        svc = _service()
        svc.solve(prob, cfg, seed=1)
        assert calls["n"] == 1
        r = svc.solve(prob, cfg, seed=2)
        assert calls["n"] == 1, "warm-instance solve must not re-encode"
        assert r.store_hit
        r = svc.solve(_problem(2), cfg, seed=3)
        assert calls["n"] == 1 and r.store_hit

    def test_store_cache_lru_eviction(self):
        cache = LRUStoreCache(capacity=2, device=CPU)
        p1, p2, p3 = _problem(1), _problem(2), _problem(3)
        cache.get_or_build(p1, "bitplane")
        cache.get_or_build(p2, "bitplane")
        _, hit = cache.get_or_build(p1, "bitplane")
        assert hit
        cache.get_or_build(p3, "bitplane")       # evicts p2 (LRU)
        assert cache.evictions == 1
        _, hit = cache.get_or_build(p2, "bitplane")
        assert not hit and len(cache) == 2

    def test_store_cache_hands_back_a_store_on_its_device(self):
        """Built once, moved once: a hit returns the very store (its plane
        tensors on the cache's device), and only a build moves bytes; a
        dense store is the request's own J when that is on the device."""
        cache = LRUStoreCache(capacity=4, device=CPU)
        store, hit = cache.get_or_build(_problem(1), "bitplane")
        assert not hit and store.planes.pos.device.type == "cpu"
        again, hit = cache.get_or_build(_problem(1), "bitplane")
        assert hit and again is store
        assert again.planes.pos.data_ptr() == store.planes.pos.data_ptr()
        assert cache.bytes_to_device == 0        # already on the device
        prob = _problem(2)
        dense, _ = cache.get_or_build(prob, "dense")
        assert dense.dense is prob.couplings

    def test_warm_start_cache_answers_met_targets_without_launch(self):
        prob = _problem(2)
        svc = _service()
        first = svc.solve(prob, _cfg())
        best = float(first.result.best_energy.min())
        launches = svc.stats["launches"]
        hit = svc.solve(prob, _cfg(),
                        budget=BudgetConfig(target_energy=best + 1.0))
        assert hit.stop_reason == "cached_target" and hit.warm_hit
        assert svc.stats["launches"] == launches, "no launch on a met target"
        res = hit.result
        assert res.best_spins.dtype == torch.int8
        assert res.num_flips.dtype == torch.int32
        assert res.best_spins.device.type == "cpu"
        assert torch.equal(ising.energy(prob, res.best_spins),
                           res.best_energy)
        miss = svc.solve(prob, _cfg(),
                         budget=BudgetConfig(target_energy=best - 1e9))
        assert miss.batched == "budgeted"
        assert svc.stats["launches"] == launches + 1

    def test_warm_cache_folds_min_and_bounds_capacity(self):
        cache = WarmStartCache(capacity=2)

        class R:
            def __init__(self, e, n=4):
                self.best_energy = torch.tensor([e])
                self.best_spins = torch.ones((1, n), dtype=torch.int8)
        rec = cache.observe("a", R(-5.0))
        assert rec.energy == -5.0
        rec = cache.observe("a", R(-3.0))
        assert rec.energy == -5.0
        cache.observe("b", R(-1.0))
        cache.observe("c", R(-2.0))              # evicts "a"
        assert cache.lookup("a") is None and len(cache) == 2

    def test_budgeted_request_reports_supervisor_stop_reason(self):
        svc = _service()
        r = svc.solve(_problem(2), _cfg(), seed=3,
                      budget=BudgetConfig(max_steps=STEPS // 2))
        assert r.batched == "budgeted"
        assert r.stop_reason == "max_steps"


class TestAdmission:
    def test_over_cap_instance_and_steps_rejected(self):
        svc = _service(ServeConfig(max_spins=16, max_steps=50))
        with pytest.raises(AdmissionError, match="N=48"):
            svc.submit(SolveRequest(_problem(), _cfg()))
        svc2 = _service(ServeConfig(max_steps=50))
        with pytest.raises(AdmissionError, match="num_steps"):
            svc2.submit(SolveRequest(_problem(), _cfg()))

    def test_queue_bound(self):
        svc = _service(ServeConfig(max_pending=1))
        svc.submit(SolveRequest(_problem(), _cfg()))
        with pytest.raises(AdmissionError, match="queue"):
            svc.submit(SolveRequest(_problem(), _cfg()))

    def test_unknown_backend_and_capability_mismatch(self):
        svc = _service()
        with pytest.raises(ValueError, match="backend"):
            svc.submit(SolveRequest(_problem(), _cfg(), backend="nope"))
        with pytest.raises(AdmissionError, match="edge-list"):
            svc.submit(SolveRequest(_edge_problem(4), _cfg(),
                                    backend="reference"))
        # The multi-GPU paths are not ported: refused at the door, naming
        # the ROADMAP item, and nothing is enqueued.
        with pytest.raises(AdmissionError, match="mesh.*item 12"):
            svc.submit(SolveRequest(_problem(), _cfg(), backend="sharded"))
        assert svc.drain() == {}

    def test_rejection_counters(self):
        svc = _service(ServeConfig(max_spins=16))
        with pytest.raises(AdmissionError):
            svc.submit(SolveRequest(_problem(), _cfg()))
        assert svc.stats["rejected"] == 1 and svc.stats["admitted"] == 0

    def test_device_and_mesh(self):
        with pytest.raises(NotImplementedError, match="item 12"):
            SolverService(device=CPU, mesh=object())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                SolverService()
        assert _service().device == torch.device("cpu")


class TestDigests:
    def test_coupling_digest_is_content_not_identity(self):
        assert coupling_digest(_problem(1)) == coupling_digest(_problem(1))
        assert coupling_digest(_problem(1)) != coupling_digest(_problem(2))

    def test_coupling_digest_separates_dtypes_with_identical_bytes(self):
        g = np.random.default_rng(0)
        J_i = np.rint(g.normal(size=(N, N)) * 2).astype(np.int32)
        J_i = np.triu(J_i, 1) + np.triu(J_i, 1).T
        J_f = J_i.view(np.float32)
        h = torch.zeros(N)
        a = ising.IsingProblem(couplings=torch.from_numpy(J_i), fields=h)
        b = ising.IsingProblem(couplings=torch.from_numpy(J_f), fields=h)
        assert coupling_digest(a) != coupling_digest(b)

    def test_edge_list_problems_digest_by_canonical_coo(self):
        a = _edge_problem(4)
        e = a.edges
        perm = np.random.default_rng(0).permutation(e.nnz)
        b = ising.IsingProblem.create_sparse(ising.EdgeList.create(
            e.cols[perm], e.rows[perm], e.weights[perm], num_spins=N))
        assert coupling_digest(a) == coupling_digest(b)
        assert coupling_digest(a).startswith("edges:")

    def test_digests_equal_the_jax_strings(self):
        """Dense f32 J, int32 J and an edge list: both packages give the
        same coupling_digest and problem_digest hex strings."""
        J, h = _arrays(8)
        cases = [(jising.IsingProblem.create(J, h, offset=1.5),
                  interop.problem_from_numpy(J, h, 1.5))]
        J_i = J.astype(np.int32)
        cases.append((jising.IsingProblem(couplings=J_i, fields=h,
                                          offset=0.0),
                      ising.IsingProblem(couplings=torch.from_numpy(J_i),
                                         fields=torch.from_numpy(h))))
        rows, cols = np.nonzero(np.triu(J, 1))
        w = J[rows, cols]
        cases.append((jising.IsingProblem.create_sparse(
            jising.EdgeList.create(rows, cols, w, num_spins=N), h),
            interop.sparse_problem_from_numpy(rows, cols, w, N, h)))
        for jp, tp in cases:
            assert jserve.coupling_digest(jp) == coupling_digest(tp)
            assert jserve.problem_digest(jp) == problem_digest(tp)
        assert coupling_digest(cases[0][1]) != coupling_digest(cases[1][1])


def _burst(make_problem, cfg_cls, sched, budget_cls, request_cls):
    """The parity burst: stack (3 seed-free, 2+2+3 replicas), vmap (2
    pinned seeds), single (a pinned seed on another instance), budgeted
    (max_steps) and a repeat of the stack's instance in fresh arrays."""
    a, b = make_problem(21), make_problem(22)
    cfg = cfg_cls(num_steps=STEPS, schedule=sched, mode="rsa",
                  num_replicas=REPLICAS, trace_every=16)
    three = dataclasses.replace(cfg, num_replicas=3)
    return [request_cls(a, cfg), request_cls(a, cfg), request_cls(a, three),
            request_cls(a, cfg, seed=5), request_cls(make_problem(21), cfg,
                                                     seed=6),
            request_cls(b, cfg, seed=7),
            request_cls(a, cfg, seed=8, budget=budget_cls(max_steps=48))]


def test_burst_drain_equals_jax_ticket_by_ticket():
    """JAX's SolverService and the port's drain one burst, then a second
    drain with a met target (cached) and an unmet one (budgeted): every
    ticket's lane, store and warm hits and stop reason agree, its
    best_energy, best_spins and num_flips are bitwise equal, and so are
    the services' stats."""
    def jprob(seed):
        return jising.IsingProblem.create(*_arrays(seed), offset=-2.0)

    def tprob(seed):
        return interop.problem_from_numpy(*_arrays(seed), -2.0)

    jsvc = jserve.SolverService()
    tsvc = _service()
    jreqs = _burst(jprob, JConfig, jlinear(6.0, 0.05, STEPS), JBudget,
                   jserve.SolveRequest)
    treqs = _burst(tprob, SolverConfig, schedules.linear(6.0, 0.05, STEPS),
                   BudgetConfig, SolveRequest)
    outs = []
    for svc, reqs in ((jsvc, jreqs), (tsvc, treqs)):
        tickets = [svc.submit(r) for r in reqs]
        first = svc.drain()
        best = min(float(np.min(np.asarray(first[t].result.best_energy)))
                   for t in tickets[:3])
        cfg = reqs[0].config
        budget = type(reqs[-1].budget)
        tickets += [svc.submit(type(reqs[0])(reqs[0].problem, cfg,
                                             budget=budget(
                                                 target_energy=best + 1.0))),
                    svc.submit(type(reqs[0])(reqs[0].problem, cfg, seed=9,
                                             budget=budget(
                                                 target_energy=best - 1e6)))]
        outs.append((tickets, {**first, **svc.drain()}))
    (jt, jout), (tt, tout) = outs
    assert jt == tt
    kinds = [jout[t].batched for t in jt]
    assert kinds == ["stack"] * 3 + ["vmap"] * 2 + ["single", "budgeted",
                                                    "cached", "budgeted"]
    for t in jt:
        j, p = jout[t], tout[t]
        assert (j.batched, j.store_hit, j.warm_hit, j.stop_reason) == \
            (p.batched, p.store_hit, p.warm_hit, p.stop_reason), t
        for name in ("best_energy", "best_spins", "num_flips"):
            np.testing.assert_array_equal(
                np.asarray(getattr(j.result, name)),
                getattr(p.result, name).numpy(), err_msg=f"{t} {name}")
    assert jsvc.stats == tsvc.stats
    assert (jsvc.stores.hits, jsvc.stores.misses, jsvc.warm.hits) == \
        (tsvc.stores.hits, tsvc.stores.misses, tsvc.warm.hits)
