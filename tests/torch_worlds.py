"""Rank functions of the port's multi-process CPU tests (gloo worlds run by
``repro_torch.distributed.world.run_world``). Each returns host tensors
and plain values; the test modules compare what the ranks return.

Kept apart from the test modules so that a rank imports the port only,
never JAX.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import ising
from repro_torch.core.schedules import geometric, linear
from repro_torch.core.solver import SolverConfig

N = 512
STEPS = 96
R = 4
MODES = (("rwa", False), ("rwa", True), ("rsa", False))
RESULT_FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
                 "trace_energy")


def int_j(n: int = N, seed: int = 11, amax: int = 3) -> np.ndarray:
    """The symmetric integer J of the JAX package's sharded parity test."""
    g = np.random.default_rng(seed)
    J = np.clip(np.rint(g.normal(size=(n, n)) * 1.5), -amax, amax)
    J = np.triu(J, 1)
    return J + J.T


def parity_config(mode: str, uniformized: bool,
                  steps: int = STEPS) -> SolverConfig:
    """The six-way parity's config on a linear schedule: its temperatures
    are IEEE arithmetic, the same in both packages, so the port's results
    can be held to JAX's bit for bit as well."""
    return SolverConfig(num_steps=steps, schedule=linear(4.0, 0.05, steps),
                        mode=mode, uniformized=uniformized, num_replicas=R,
                        trace_every=24)


def result_dict(res) -> dict:
    return {k: (None if v is None else v.detach().cpu().clone())
            for k, v in res._asdict().items()}


def coalesce_state(groups, seed=0):
    """(u0, s0, e0) of the row-coalescing test: replicas in one group
    share a configuration."""
    J = int_j(N, seed=3)
    g = np.random.default_rng(seed)
    s_g = np.where(g.random((max(groups) + 1, N)) < .5, 1., -1.)
    s0 = s_g[np.asarray(groups)].astype(np.float32)
    u0 = (J @ s0.T).T.astype(np.float32)
    e0 = (-0.5 * np.einsum("rn,rn->r", u0, s0)).astype(np.float32)
    return u0, s0, e0


def coalesce_uniforms(groups, t: int, seed=1):
    g = np.random.default_rng(seed)
    u_g = g.random((t, max(groups) + 1, 4)).astype(np.float32)
    return u_g[:, np.asarray(groups), :]


COALESCE_GROUPS = (([0] * 8, 1), ([0, 0, 0, 0, 1, 1, 1, 1], 2),
                   (list(range(8)), 8))
COALESCE_T = 24


class _Largest(TorchDispatchMode):
    """The largest tensor any op makes while it is on."""

    def __init__(self):
        super().__init__()
        self.numel = 0
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
                self.shapes.add(tuple(t.shape))
        return out


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def sharded_world(run_dir: str) -> dict:
    """Every sharded case of ``tests/test_torch_solver_sharded.py`` on a
    world of 4: the six-way parity's three sharded solves per mode, the
    anchors held to JAX, the chunked and crashed ``run_resilient`` on the
    2×2 mesh, the bare step's collectives, the largest tensor of an
    edge-ingested solve, the row-coalescing counts, and the errors."""
    from repro_torch.core.bitplane import encode_couplings
    from repro_torch.core.resilience import inject_faults, run_resilient
    from repro_torch.distributed import build_mesh, solve_sharded
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed import solver_sharded as ss
    from repro_torch.kernels import ops

    m1 = build_mesh("4", "cpu")
    m2 = build_mesh("2x2", "cpu")
    J = int_j()
    prob = ising.IsingProblem.create(J=J, device="cpu")
    prob_edges = ising.IsingProblem.create_sparse(ising.EdgeList.from_dense(J))
    out = {"parity": {}, "collectives": {}}
    for mode, uni in MODES:
        cfg = parity_config(mode, uni)
        for name, p, mesh in (("bitplane_sharded", prob, m1),
                              ("bitplane_sharded_edges", prob_edges, m1),
                              ("bitplane_sharded_2d", prob, m2)):
            M.COLLECTIVES.reset()
            res = solve_sharded(p, 5, cfg, mesh, device="cpu")
            out["parity"][(mode, uni, name)] = result_dict(res)
            out["collectives"][(mode, uni, name)] = dict(M.COLLECTIVES.counts)

    cfg = parity_config("rwa", False)
    out["resilient"] = result_dict(run_resilient(
        prob, 5, cfg, os.path.join(run_dir, "chunked"),
        backend="sharded_2d", mesh=m2, chunk_steps=24, device="cpu").result)
    crash_dir = os.path.join(run_dir, "crash")

    def crash(site, info):
        if site == "chunk_start" and info["chunk"] == 2:
            raise RuntimeError("injected crash")

    with inject_faults(crash):
        try:
            run_resilient(prob, 5, cfg, crash_dir, backend="sharded_2d",
                          mesh=m2, chunk_steps=24, device="cpu")
        except RuntimeError:
            pass
    rr = run_resilient(prob, 5, cfg, crash_dir, backend="sharded_2d",
                       mesh=m2, chunk_steps=24, device="cpu")
    out["resumed"] = result_dict(rr.result)
    out["resumed_from"] = rr.resumed_from_chunk
    out["writes_snapshots"] = ss.ShardedRunner(
        prob, 5, cfg, m2, device="cpu").writes_snapshots

    # The bare step: collectives per step, by dim, on both meshes.
    steps = 6
    out["step_collectives"] = {}
    for mode, uni in MODES:
        cfg = parity_config(mode, uni)
        for name, mesh in (("1d", m1), ("2d", m2)):
            runner = ss.ShardedRunner(prob, 5, cfg, mesh, device="cpu")
            state = runner.init()
            u, s, e = state[:3]
            lay = runner.layout
            unif = torch.rand(steps, lay.r_loc, 4,
                              generator=torch.Generator().manual_seed(0))
            M.COLLECTIVES.reset()
            got = ss.sharded_sweep(runner.planes, u, s, e, unif,
                                   runner.temps[:steps], runner.pwl, lay,
                                   mode=mode, uniformized=uni)
            out["step_collectives"][(mode, uni, name)] = (
                dict(M.COLLECTIVES.counts), int(got[6].sum()), lay.r_loc)

    # The largest tensor of an edge-ingested solve, against the slab.
    big = _Largest()
    with big:
        runner = ss.ShardedRunner(prob_edges, 5,
                                  parity_config("rwa", False, 24), m1,
                                  device="cpu")
        runner.drive()
    out["largest"] = (big.numel, (J.shape[0], J.shape[0]) in big.shapes,
                      tuple(runner.planes.pos.shape))

    # Row coalescing: duplicate replica groups, coalesced and not.
    planes = encode_couplings(int_j(N, seed=3), 2, align_words=128)
    lay_cfg = SolverConfig(num_steps=COALESCE_T,
                           schedule=linear(3.0, 0.1, COALESCE_T),
                           num_replicas=8,
                           coupling_format="bitplane_sharded")
    lay = ss.Layout(lay_cfg, m1, N)
    slab = type(planes)(planes.pos[:, lay.rows].contiguous(),
                        planes.neg[:, lay.rows].contiguous(), N)
    temps = torch.full((COALESCE_T, 8), 1.0)
    out["coalesce"] = {}
    for mode, uni in (("rsa", False), ("rwa", False), ("rwa", True)):
        for gi, (groups, _) in enumerate(COALESCE_GROUPS):
            u0, s0, e0 = (torch.from_numpy(x) for x in coalesce_state(groups))
            unif = torch.from_numpy(coalesce_uniforms(groups, COALESCE_T))
            for coalesce in (True, False):
                got = ss.sharded_sweep(
                    slab, u0[:, lay.rows].contiguous(),
                    s0[:, lay.rows].contiguous(), e0, unif, temps,
                    ops.solver_pwl_table(lay_cfg),
                    lay, mode=mode, uniformized=uni, coalesce=coalesce)
                full = tuple(lay.over_rows(x) if x.dim() == 2 else x
                             for x in got)
                out["coalesce"][(mode, uni, gi, coalesce)] = full

    # The errors, to hold against JAX's messages.
    def cfg4(r=4):
        return SolverConfig(num_steps=8, schedule=geometric(1.0, 0.1, 8),
                            num_replicas=r)

    def prob_of(n):
        g = np.random.default_rng(0)
        Jn = np.clip(np.rint(g.normal(size=(n, n))), -3, 3)
        Jn = np.triu(Jn, 1)
        return ising.IsingProblem.create(J=Jn + Jn.T, device="cpu")

    p513 = prob_of(513)
    out["errors"] = {
        "1d_513": _error(lambda: solve_sharded(p513, 0, cfg4(), m1,
                                               device="cpu")),
        "2d_513": _error(lambda: solve_sharded(p513, 0, cfg4(), m2,
                                               device="cpu")),
        "lane_192": _error(lambda: solve_sharded(prob_of(192), 0, cfg4(),
                                                 m1, device="cpu")),
        "edges_513": _error(lambda: ss.shard_planes_from_edges(
            ising.EdgeList.from_dense(p513.couplings.numpy()), m1)),
        "replicas_3": _error(lambda: solve_sharded(
            prob_of(512), 0, cfg4(3), m2, device="cpu")),
        "sharded_2d_on_1d": _error(lambda: solve_sharded(
            prob, 0, dataclasses.replace(
                cfg4(), coupling_format="bitplane_sharded_2d"), m1,
            device="cpu")),
    }
    out["nearest"] = ss.nearest_row_shard_counts(513, 4)
    out["fused_store_bytes"] = ops.fused_operands(
        prob, dataclasses.replace(cfg4(), coupling_format="bitplane_hbm"),
        torch.device("cpu"))[1].nbytes
    return out


def dist_world() -> dict:
    """``solve_distributed`` on a 2×2 world: the fused and reference
    backends twice each on the anchor, a plane store, and the chunked
    supervisor."""
    from repro_torch.core.resilience import run_resilient
    from repro_torch.distributed import (DistSolverConfig, build_mesh,
                                         solve_distributed)
    from repro_torch.graphs import complete_bipolar, maxcut_to_ising

    mesh = build_mesh("2x2", "cpu")
    prob = maxcut_to_ising(complete_bipolar(48, seed=3), device="cpu")
    out = {}
    for backend in ("fused", "reference"):
        for mode in ("rsa", "rwa"):
            cfg = dist_config(backend, mode)
            out[(backend, mode)] = [
                result_dict(solve_distributed(prob, 7, cfg, mesh,
                                              device="cpu"))
                for _ in range(2)]
    cfg = dist_config("fused", "rsa", fmt="bitplane")
    out["planes"] = result_dict(solve_distributed(prob, 7, cfg, mesh,
                                                  device="cpu"))
    cfg = dist_config("fused", "rsa")
    out["resilient"] = result_dict(run_resilient(
        prob, 7, cfg, backend="distributed", mesh=mesh, device="cpu").result)
    out["auto"] = result_dict(run_resilient(prob, 7, cfg, mesh=mesh,
                                            device="cpu").result)
    return out


def dist_config(backend: str, mode: str, fmt: str = "auto"):
    from repro_torch.distributed import DistSolverConfig

    base = SolverConfig(num_steps=512, schedule=linear(8.0, 0.05, 512),
                        mode=mode, num_replicas=1, trace_every=64,
                        coupling_format=fmt)
    return DistSolverConfig(base=base, replicas_per_device=2,
                            exchange_every=2, backend=backend)


def serve_world(run_dir: str) -> dict:
    """A mesh-backed ``SolverService`` on a world of 2: a sharded request,
    drained, beside the solo ``solve_sharded`` of its padded problem."""
    from repro_torch.distributed import build_mesh, solve_sharded
    from repro_torch.serve import SolveRequest, SolverService
    from repro_torch.serve.batching import bucket_spins, pad_problem

    mesh = build_mesh("2", "cpu")
    prob = ising.IsingProblem.create(J=int_j(500, seed=4), device="cpu")
    cfg = parity_config("rsa", False)
    svc = SolverService(device="cpu", mesh=mesh)
    ticket = svc.submit(SolveRequest(prob, cfg, seed=3, backend="sharded"))
    got = svc.drain()[ticket]
    padded = pad_problem(prob, bucket_spins(500))
    solo = solve_sharded(padded, 3, cfg, mesh, device="cpu")
    return {"served": result_dict(got.result), "batched": got.batched,
            "solo": result_dict(solo), "n": padded.num_spins}


# ---------------------------------------------------------------------------
# The LM sharding (tests/test_torch_lm_sharded.py)
# ---------------------------------------------------------------------------

LM_MESHES = ((2, 2), (1, 4))
LM_B, LM_S = 4, 32
DECODE_B, DECODE_L = 2, 32
RECURRENT_S = 16
TRAIN_STEPS, TRAIN_LR = 3, 1e-3


def lm_cfg(arch: str, compute: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=compute)


def lm_tokens(vocab: int, shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def lm_train_batch(cfg, step: int) -> dict:
    from repro_torch.data import DataConfig, SyntheticLMData

    return SyntheticLMData(cfg, DataConfig(seed=1, global_batch=LM_B,
                                           seq_len=LM_S), "cpu").batch(step)


def _block(t: torch.Tensor):
    """A block and its slices of the whole tensor."""
    from repro_torch.models import sharding

    s = sharding.sharding_of(t)
    shape = s.global_shape(t.shape)
    return t.detach().float().clone(), s.block(shape)


def _params_blocks(params: dict) -> dict:
    from repro_torch.models.params import tree_paths

    return {path: _block(t) for path, t in tree_paths(params)}


def lm_sharded_world(jparams: dict, run_dir: str) -> dict:
    """Every sharded case of ``tests/test_torch_lm_sharded.py`` on a world
    of 4, on JAX's parameters (``jparams``: arch -> numpy tree): the
    forward, the seq-sharded decode, the MoE forward and the sharded train
    step on the (2, 2) and (1, 4) meshes, the global norm, a checkpoint
    saved on (2, 2) and restored on (1, 4), the recurrent blocks, the
    meshes and the errors. Each logits block comes with its slices of the
    whole."""
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import mesh as M
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import (ShardingRules, abstract_params,
                                    decode_step, forward, gather_params,
                                    init_decode_cache, init_params,
                                    model_specs, param_shardings,
                                    shard_params, sharding, use_sharding)
    from repro_torch.models.params import tree_paths
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train import step as tstep

    meshes = {shape: make_host_mesh(model_parallel=shape[1],
                                    device_type="cpu")
              for shape in LM_MESHES}
    out = {"mesh_names": {s: tuple(m.mesh_dim_names)
                          for s, m in meshes.items()}}
    pods = make_host_mesh(model_parallel=2, pods=2, device_type="cpu")
    out["pod_mesh"] = (tuple(pods.mesh_dim_names), tuple(pods.shape))
    out["errors"] = {
        "tp3": _error(lambda: make_host_mesh(3, device_type="cpu")),
        "production": _error(lambda: make_production_mesh(
            device_type="cpu"))}
    rules = ShardingRules()

    def sharded(arch, compute, mesh, rules=rules):
        cfg = lm_cfg(arch, compute)
        full = interop.lm_params_from_numpy(jparams[arch], "cpu")
        return cfg, shard_params(full, param_shardings(model_specs(cfg),
                                                       mesh, rules))

    toks = torch.from_numpy(lm_tokens(512, (LM_B, LM_S))).long()
    out["forward"], out["collectives"] = {}, {}
    for shape, mesh in meshes.items():
        for arch, compute in (("qwen2-7b", "float32"),
                              ("qwen2-7b", "bfloat16"),
                              ("granite-moe-1b-a400m", "float32")):
            cfg, params = sharded(arch, compute, mesh)
            M.COLLECTIVES.reset()
            with use_sharding(mesh, rules), torch.no_grad():
                res = forward(cfg, params, tokens=toks)
            out["collectives"][(shape, arch, compute)] = dict(
                M.COLLECTIVES.counts)
            out["forward"][(shape, arch, compute)] = {
                "logits": _block(res.logits), "aux": float(res.aux_loss),
                "load": None if res.expert_load is None
                else res.expert_load.clone()}

    seq_rules = ShardingRules(kv_heads=None, cache_seq="model")
    dtoks = torch.from_numpy(lm_tokens(512, (DECODE_B, DECODE_L))).long()
    out["decode"] = {}
    for shape, mesh in meshes.items():
        cfg, params = sharded("qwen2-7b", "bfloat16", mesh, seq_rules)
        with use_sharding(mesh, seq_rules):
            cache = init_decode_cache(cfg, DECODE_B, DECODE_L, device="cpu")
            steps = []
            for t in range(DECODE_L):
                lg, cache = decode_step(cfg, params, cache, t,
                                        tokens=dtoks[:, t:t + 1])
                steps.append(_block(lg))
        out["decode"][shape] = {
            "steps": steps, "cache": tuple(cache["b0"]["attn"]["k"].shape)}

    opt = AdamWConfig(learning_rate=TRAIN_LR)
    out["train"] = {}
    for shape, mesh in meshes.items():
        cfg, params = sharded("qwen2-7b", "float32", mesh)
        specs = model_specs(cfg)
        fn = tstep.make_train_step(
            cfg, opt, linear_warmup_cosine(TRAIN_LR, 1, TRAIN_STEPS),
            param_shardings=param_shardings(specs, mesh, rules),
            gathered_shardings=param_shardings(
                specs, mesh, dataclasses.replace(rules, embed_w=None)))
        state = tstep.init_train_state(cfg, params, opt)
        steps = []
        with use_sharding(mesh, rules):
            for i in range(TRAIN_STEPS):
                M.COLLECTIVES.reset()
                state, m = fn(state, lm_train_batch(cfg, i))
                steps.append({"metrics": {k: float(v) for k, v in m.items()},
                              "params": _params_blocks(state.params),
                              "collectives": dict(M.COLLECTIVES.counts)})
        out["train"][shape] = steps
        if shape == (2, 2):
            saved = state
            out["ckpt_whole_leaves"] = _most_whole_leaves(
                lambda: CheckpointManager(run_dir).save(TRAIN_STEPS, state))

    # The checkpoint saved on (2, 2), restored on (1, 4): into blocks of a
    # fresh state and into abstract (meta) parameters.
    cfg = lm_cfg("qwen2-7b", "float32")
    specs = model_specs(cfg)
    m14 = meshes[(1, 4)]
    fresh = shard_params(init_params(specs, torch.Generator().manual_seed(5),
                                     "cpu"), param_shardings(specs, m14))
    like = tstep.init_train_state(cfg, fresh, opt)
    restored, step = CheckpointManager(run_dir).restore(like)
    meta, _ = CheckpointManager(run_dir).restore(
        {"params": abstract_params(specs, m14)}, step)
    want = gather_params(saved.params)
    out["checkpoint"] = {
        "step": step,
        "params": all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_paths(gather_params(restored.params)), tree_paths(want))),
        "moments": all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_paths(gather_params(restored.opt_state.v)),
            tree_paths(gather_params(saved.opt_state.v)))),
        "meta": all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_paths(gather_params(meta["params"])), tree_paths(want))),
        "blocks": all(tuple(t.shape) == sharding.sharding_of(t).shard_shape(
            s.shape) for (_, t), (_, s) in zip(tree_paths(restored.params),
                                               tree_paths(specs)))}

    # The global norm of sharded blocks against the whole tree's.
    g = torch.Generator().manual_seed(7)
    whole = {"/".join(p): torch.randn(s.shape, generator=g)
             for p, s in tree_paths(specs)}
    whole = _nest(whole)
    out["norm"] = {}
    for shape, mesh in meshes.items():
        blocks = shard_params(whole, param_shardings(specs, mesh))
        M.COLLECTIVES.reset()
        out["norm"][shape] = (float(global_norm(blocks)),
                              float(global_norm(whole)),
                              M.COLLECTIVES.total)
    int8 = AdamWConfig(state_dtype="int8")
    out["errors"]["int8"] = _error(lambda: adamw_init(
        sharded("qwen2-7b", "float32", meshes[(2, 2)])[1], int8))

    # The recurrent families: data-parallel on (4, 1), refused where the
    # mesh splits their own dims.
    m41 = make_host_mesh(model_parallel=1, device_type="cpu")
    rtoks = torch.from_numpy(lm_tokens(512, (LM_B, RECURRENT_S))).long()
    out["recurrent"] = {}
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        cfg = lm_cfg(arch, "float32")
        full = interop.lm_params_from_numpy(jparams[arch], "cpu")
        with torch.no_grad():
            plain = forward(cfg, full, tokens=rtoks).logits
            params = shard_params(full, param_shardings(model_specs(cfg),
                                                        m41))
            with use_sharding(m41):
                got = forward(cfg, params, tokens=rtoks).logits
        blk, sl = _block(got)
        out["recurrent"][arch] = {"block": (blk, sl),
                                  "plain": float((plain[sl] - blk).abs().max())}
        split = shard_params(full, param_shardings(model_specs(cfg),
                                                   meshes[(2, 2)]))
        with use_sharding(meshes[(2, 2)]):
            out["errors"][arch] = _error_nie(lambda: forward(
                cfg, split, tokens=rtoks))
    out["errors"]["res_seq"] = _error_nie(lambda: _under(
        meshes[(2, 2)], ShardingRules(res_seq="model"),
        lambda: forward(*sharded("qwen2-7b", "float32", meshes[(2, 2)]),
                        tokens=toks)))
    qcfg, qparams = sharded("qwen2-7b", "float32", meshes[(2, 2)])
    meta_params = {k: v for k, v in abstract_params(
        model_specs(qcfg), meshes[(2, 2)]).items()}
    out["errors"]["device"] = _error(lambda: _under(
        meshes[(2, 2)], rules, lambda: forward(qcfg, meta_params,
                                               tokens=toks)))
    out["errors"]["no_context"] = _error(lambda: tstep.make_train_step(
        qcfg, opt, param_shardings=param_shardings(
            model_specs(qcfg), meshes[(2, 2)]))(
                tstep.init_train_state(qcfg, qparams, opt),
                lm_train_batch(qcfg, 0)))
    return out


def _most_whole_leaves(fn) -> int:
    """Run ``fn`` and return the most whole leaves that the checkpoint's
    gathers (``sharding.reshard`` to None) held alive at once."""
    import weakref

    from repro_torch.models import sharding

    alive: weakref.WeakSet = weakref.WeakSet()
    most = 0
    orig = sharding.reshard

    def spy(t, dst):
        nonlocal most
        out = orig(t, dst)
        if dst is None:
            alive.add(out)
            most = max(most, len(alive))
        return out

    sharding.reshard = spy
    try:
        fn()
    finally:
        sharding.reshard = orig
    return most


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _under(mesh, rules, fn):
    from repro_torch.models import use_sharding

    with use_sharding(mesh, rules), torch.no_grad():
        return fn()


def _error_nie(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return "no error"
