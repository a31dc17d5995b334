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
    from repro_torch.optim.adamw import adamw_update, global_norm
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
    # int8 moments made for the whole parameters, used on (2, 2) blocks.
    int8 = AdamWConfig(state_dtype="int8")
    unsplit = interop.lm_params_from_numpy(jparams["qwen2-7b"], "cpu")
    blocks = sharded("qwen2-7b", "float32", meshes[(2, 2)])[1]
    out["errors"]["int8"] = _error(lambda: adamw_update(
        blocks, blocks, adamw_init(unsplit, int8), int8))

    # The recurrent families: data-parallel on (4, 1), and split over
    # model on (2, 2).
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
        with use_sharding(meshes[(2, 2)]), torch.no_grad():
            out["recurrent"][arch]["split"] = _block(forward(
                cfg, split, tokens=rtoks).logits)
    out["errors"]["res_seq"] = _error_nie(lambda: _under(
        meshes[(2, 2)], ShardingRules(res_seq="data"),
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


# ---------------------------------------------------------------------------
# The Mamba and RWKV blocks split over model, sequence parallelism
# (tests/test_torch_lm_sp.py)
# ---------------------------------------------------------------------------

SP_ARCHS = ("qwen2-7b", "granite-moe-1b-a400m", "jamba-1.5-large-398b")
SP_RULES = {"res_seq": {"res_seq": "model"},
            "embed_act": {"embed_act": "model"}}
SPLIT_ARCHS = ("rwkv6-1.6b", "jamba-1.5-large-398b")
SPLIT_S = 16
SPLIT_DECODE = 16
STORAGE_DECODE = 4
#: The storage-only layouts: small weight dims split for storage, gathered
#: whole for compute (the layer groups; the other small dims, with the
#: tensor-parallel names off model so that the spec gives it to them).
STORAGE_RULES = {
    "layers": {"layers": "model"},
    "small": {"heads": None, "kv_heads": None, "ssm_inner": None,
              "rwkv_heads": None, "lora": "model", "ssm_state": "model",
              "conv": "model", "dt_rank": "model", "head_dim": "model"}}
#: The Mamba channel planted in rank 1's block (of 2) with a span that
#: forces a shorter scan piece there only.
PLANT_CHANNEL = -1


def planted_jamba(jparams: dict) -> dict:
    """jamba's parameters with one Mamba channel whose decay spans more
    than ``ssm.SCAN_LOG_SPAN`` over a chunk: the last channel of the first
    Mamba block of every group (A = -1e4 on every state)."""
    out = {k: v for k, v in jparams.items()}
    groups = dict(out["groups"])
    b0 = dict(groups["b0"])
    mixer = dict(b0["mixer"])
    a_log = np.array(mixer["a_log"], dtype=np.float32, copy=True)
    a_log[:, PLANT_CHANNEL, :] = np.log(1e4)
    mixer["a_log"] = a_log.astype(np.asarray(mixer["a_log"]).dtype)
    b0["mixer"] = mixer
    groups["b0"] = b0
    out["groups"] = groups
    return out


def _pieces(fn):
    """Run ``fn`` recording every piece length the Mamba scan picks."""
    from repro_torch.models import ssm

    seen = []
    orig = ssm._piece_len

    def spy(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    ssm._piece_len = spy
    try:
        out = fn()
    finally:
        ssm._piece_len = orig
    return out, seen


def shard_train_state(whole, shardings, opt):
    """A whole ``TrainState`` as this rank's blocks: the parameters by
    ``shardings``, each moment (a tensor or int8 ``QTensor``) cut to the
    blocks that ``adamw_init`` makes for them."""
    from repro_torch.models import sharding, shard_params
    from repro_torch.optim import QTensor, adamw_init
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    params = shard_params(whole.params, shardings)
    like = adamw_init(params, opt)

    def cut(w, blk):
        if isinstance(w, QTensor):
            s = sharding.sharding_of(blk.codes)
            return QTensor(
                codes=sharding.with_sharding(
                    w.codes[s.block(w.codes.shape)].clone(), s),
                scales=sharding.with_sharding(
                    w.scales[s.block(w.scales.shape)].clone(), s),
                orig_last=blk.orig_last)
        s = sharding.sharding_of(blk)
        return sharding.with_sharding(w[s.block(w.shape)].clone(), s)

    def walk(w, b):
        if isinstance(b, dict):
            return {k: walk(w[k], b[k]) for k in b}
        return cut(w, b)

    opt_state = AdamWState(step=whole.opt_state.step,
                           m=walk(whole.opt_state.m, like.m),
                           v=walk(whole.opt_state.v, like.v))
    return TrainState(params=params, opt_state=opt_state, step=whole.step)


def lm_sp_world(jparams: dict, jstates: list) -> dict:
    """Every case of ``tests/test_torch_lm_sp.py`` on a world of 4, from
    JAX's parameters (``jparams``: arch -> numpy tree): rwkv6 and jamba
    split over model on (2, 2) and (1, 4), forward and 16 decode steps
    with split caches; the planted scan piece; qwen2, granite and jamba
    under res_seq / embed_act against the same mesh without the rule; the
    storage layouts; jamba's dry-run train hint (embed_act, int8 moments)
    for three steps; the refusals."""
    from repro_torch import interop
    from repro_torch.distributed import mesh as M
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import (ShardingRules, decode_step, forward,
                                    init_decode_cache, model_specs,
                                    param_shardings, shard_params, sharding,
                                    use_sharding)
    from repro_torch.models.params import tree_paths
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train import step as tstep

    meshes = {shape: make_host_mesh(model_parallel=shape[1],
                                    device_type="cpu")
              for shape in LM_MESHES}

    def sharded(arch, mesh, rules, params=None):
        cfg = lm_cfg(arch, "float32")
        full = interop.lm_params_from_numpy(
            jparams[arch] if params is None else params, "cpu")
        return cfg, shard_params(full, param_shardings(model_specs(cfg),
                                                       mesh, rules))

    out = {"split": {}, "decode": {}, "sp": {}, "storage": {}}
    rtoks = torch.from_numpy(lm_tokens(512, (LM_B, SPLIT_S))).long()
    dtoks = torch.from_numpy(lm_tokens(512, (DECODE_B, SPLIT_DECODE))).long()
    rules = ShardingRules()
    for shape, mesh in meshes.items():
        for arch in SPLIT_ARCHS:
            cfg, params = sharded(arch, mesh, rules)
            M.COLLECTIVES.reset()
            with use_sharding(mesh, rules), torch.no_grad():
                (lg, pieces) = _pieces(lambda: forward(cfg, params,
                                                       tokens=rtoks).logits)
            out["split"][(shape, arch)] = {
                "logits": _block(lg), "pieces": pieces,
                "collectives": dict(M.COLLECTIVES.counts)}
            with use_sharding(mesh, rules):
                cache = init_decode_cache(cfg, DECODE_B, SPLIT_DECODE,
                                          device="cpu")
                steps = []
                for t in range(SPLIT_DECODE):
                    lg, cache = decode_step(cfg, params, cache, t,
                                            tokens=dtoks[:, t:t + 1])
                    steps.append(_block(lg))
            out["decode"][(shape, arch)] = {
                "steps": steps,
                "cache": {"/".join(p): tuple(t.shape)
                          for p, t in tree_paths(cache)}}

    # The planted channel: the scan's pieces on (1, 4), every rank's, and
    # the unsharded run's.
    planted = planted_jamba(jparams["jamba-1.5-large-398b"])
    cfg, full = lm_cfg("jamba-1.5-large-398b", "float32"), None
    full = interop.lm_params_from_numpy(planted, "cpu")
    with torch.no_grad():
        plain, plain_pieces = _pieces(lambda: forward(cfg, full,
                                                      tokens=rtoks).logits)
    cfg, params = sharded("jamba-1.5-large-398b", meshes[(1, 4)], rules,
                          planted)
    with use_sharding(meshes[(1, 4)], rules), torch.no_grad():
        lg, pieces = _pieces(lambda: forward(cfg, params,
                                             tokens=rtoks).logits)
    blk, sl = _block(lg)
    out["planted"] = {"pieces": pieces, "plain_pieces": plain_pieces,
                      "err": float((blk - plain[sl]).abs().max()),
                      "scale": float(plain.abs().max()),
                      "finite": bool(torch.isfinite(blk).all())}

    # res_seq and embed_act: bitwise the same mesh without the rule.
    toks = torch.from_numpy(lm_tokens(512, (LM_B, LM_S))).long()
    for shape, mesh in meshes.items():
        for arch in SP_ARCHS:
            cfg, params = sharded(arch, mesh, rules)
            with use_sharding(mesh, rules), torch.no_grad():
                base = forward(cfg, params, tokens=toks)
            entry = {"base": _block(base.logits)}
            for name, kw in SP_RULES.items():
                sp = ShardingRules(**kw)
                M.COLLECTIVES.reset()
                with use_sharding(mesh, sp), torch.no_grad():
                    got = forward(cfg, params, tokens=toks)
                entry[name] = {
                    "same": torch.equal(got.logits, base.logits)
                    and torch.equal(got.aux_loss, base.aux_loss),
                    "collectives": dict(M.COLLECTIVES.counts)}
            out["sp"][(shape, arch)] = entry

    # seq over model: compute keeps the sequence whole, the logits come
    # back as the rank's block of it (the rules' ("batch", "seq", "vocab")).
    out["seq"] = {}
    for shape, mesh in meshes.items():
        cfg, params = sharded("qwen2-7b", mesh, rules)
        with use_sharding(mesh, ShardingRules(seq="model")), torch.no_grad():
            out["seq"][shape] = _block(forward(cfg, params,
                                               tokens=toks).logits)

    # The storage layouts: the small weight dims split for storage only.
    for name, kw in STORAGE_RULES.items():
        st = ShardingRules(**kw)
        for arch in ("qwen2-7b",) + SPLIT_ARCHS:
            cfg, params = sharded(arch, meshes[(2, 2)], st)
            with use_sharding(meshes[(2, 2)], st), torch.no_grad():
                lg = forward(cfg, params, tokens=rtoks).logits
            steps = []
            if arch in SPLIT_ARCHS:   # decode: the cache stored alike
                with use_sharding(meshes[(2, 2)], st):
                    cache = init_decode_cache(cfg, DECODE_B, SPLIT_DECODE,
                                              device="cpu")
                    for t in range(STORAGE_DECODE):
                        lg_t, cache = decode_step(cfg, params, cache, t,
                                                  tokens=dtoks[:, t:t + 1])
                        steps.append(_block(lg_t))
            out["storage"][(name, arch)] = {
                "logits": _block(lg), "decode": steps,
                "model_split": sorted(
                    "/".join(p) for p, t in tree_paths(params)
                    if any("model" in a for a in sharding.layout(t)))}

    # jamba's dry-run train hint: embed_act over model, int8 moments; each
    # step from JAX's state before it (``jstates``), as int8 steps are
    # compared (ROADMAP, reference caveats).
    opt = AdamWConfig(learning_rate=TRAIN_LR, state_dtype="int8")
    hint = ShardingRules(embed_act="model")
    out["train"] = {}
    for shape, mesh in meshes.items():
        cfg = lm_cfg("jamba-1.5-large-398b", "float32")
        shardings = param_shardings(model_specs(cfg), mesh, hint)
        fn = tstep.make_train_step(
            cfg, opt, linear_warmup_cosine(TRAIN_LR, 1, TRAIN_STEPS),
            param_shardings=shardings)
        steps = []
        with use_sharding(mesh, hint):
            for i, jstate in enumerate(jstates):
                state = shard_train_state(
                    interop.train_state_from_numpy(jstate, "cpu"), shardings,
                    opt)
                state, m = fn(state, lm_train_batch(cfg, i))
                steps.append({"metrics": {k: float(v) for k, v in m.items()},
                              "params": _params_blocks(state.params)})
        out["train"][shape] = steps

    m22 = meshes[(2, 2)]
    cfg, params = sharded("qwen2-7b", m22, rules)
    out["errors"] = {
        "batch_dim": _error_nie(lambda: _under(
            m22, ShardingRules(res_seq="data"),
            lambda: forward(cfg, params, tokens=toks))),
        "embed_w": _error_nie(lambda: _under(
            m22, ShardingRules(embed_w="model"),
            lambda: forward(cfg, params, tokens=toks)))}
    return out



# ---------------------------------------------------------------------------
# The int8 gradient exchange and the pipeline
# (tests/test_torch_compress_pipeline.py)
# ---------------------------------------------------------------------------

COMPRESS_STEPS = 20
COMPRESS_SHAPES = {"w": (16, 8), "b": (8,), "zero": (3,)}
PIPE_STAGES, PIPE_M, PIPE_MB, PIPE_D = 4, 8, 2, 16


def compress_grads(world: int, seed: int = 3) -> dict:
    """Every rank's gradients of every step: ``{leaf: (steps, world,
    *shape)}`` f32, the "zero" leaf zero at even steps (its scale is 0)."""
    g = np.random.default_rng(seed)
    out = {}
    for name, shape in COMPRESS_SHAPES.items():
        x = g.standard_normal((COMPRESS_STEPS, world) + shape)
        x *= np.exp(g.uniform(-3, 3, (COMPRESS_STEPS, world, 1)
                              + (1,) * (len(shape) - 1)))
        if name == "zero":
            x[::2] = 0.0
        out[name] = x.astype(np.float32)
    return out


def pipeline_inputs(seed: int = 4):
    g = np.random.default_rng(seed)
    w = (g.standard_normal((PIPE_STAGES, PIPE_D, PIPE_D)) * 0.3)
    x = g.standard_normal((PIPE_M, PIPE_MB, PIPE_D))
    return w.astype(np.float32), x.astype(np.float32)


def pipeline_stage(w, h):
    return torch.tanh(h @ w)


def compress_pipeline_world(dims: tuple = ("data",),
                            device_type: str = "cpu") -> dict:
    """One rank: ``compressed_psum_grads`` over 20 error-feedback steps on
    its gradients (``compress_grads``), and ``pipeline_apply`` with its
    stage (``pipeline_inputs``), on a 1-D mesh of the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.compress import (compressed_psum_grads,
                                                  init_compression)
    from repro_torch.distributed.pipeline import pipeline_apply

    world = dist.get_world_size()
    rank = dist.get_rank()
    dev = torch.device(device_type)
    mesh = init_device_mesh(device_type, (world,), mesh_dim_names=dims)
    grads = compress_grads(world)
    state = init_compression({k: torch.zeros(s, device=dev)
                              for k, s in COMPRESS_SHAPES.items()})
    steps = []
    for t in range(COMPRESS_STEPS):
        mine = {k: torch.from_numpy(v[t, rank]).to(dev)
                for k, v in grads.items()}
        reduced, state = compressed_psum_grads(mine, state, mesh, dims[0])
        steps.append({"reduced": {k: v.cpu() for k, v in reduced.items()},
                      "ef": {k: v.cpu() for k, v in
                             state.error_feedback.items()}})
    w, x = pipeline_inputs()
    out = pipeline_apply(pipeline_stage, torch.from_numpy(w[rank]).to(dev),
                         torch.from_numpy(x).to(dev), mesh, dims[0]) \
        if world == PIPE_STAGES else None
    return {"rank": rank, "steps": steps,
            "pipeline": None if out is None else out.cpu()}
