"""The port's row-sharded plane tiers (``bitplane_sharded`` /
``bitplane_sharded_2d``) on a gloo world of 4 CPU processes.

One world runs every case (``torch_worlds.sharded_world``) while one
forced-4-device JAX subprocess runs the reference's; the tests compare:

* the six-way parity: dense == bitplane == bitplane_hbm (the port's fused
  solve) == ``bitplane_sharded`` (1-D, D=4) == sharded from edges ==
  ``bitplane_sharded_2d`` (2×2), bitwise, for RWA, uniformized RWA and
  RSA, on every rank, and bitwise JAX's ``solve_sharded`` on both meshes;
* ``run_resilient(backend="sharded_2d")`` chunked, and through a crash and
  a resume, bitwise the monolithic solve;
* the step's collectives, counted and bounded, and scoped to the rows dim
  on the 2-D mesh; no rank making an (N, N) tensor or more than its plane
  slab;
* ``rows_fetched`` coalesced against uncoalesced, integer-equal to JAX's;
* the divisibility and validation errors, word for word JAX's;
* a world of 1 (in this process) against the fused solve.
"""
import concurrent.futures
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_worlds as tw
from conftest import run_with_forced_devices
from repro_torch.core import coupling as tcoupling
from repro_torch.core import ising
from repro_torch.core.solver import solve
from repro_torch.distributed import mesh as M
from repro_torch.distributed import solver_sharded as ss
from repro_torch.distributed.world import run_world
from repro_torch.kernels import ops

TIERS = ("dense", "bitplane", "bitplane_hbm")
SHARDED = ("bitplane_sharded", "bitplane_sharded_edges",
           "bitplane_sharded_2d")
MODE_IDS = [f"{m}{'-uniformized' if u else ''}" for m, u in tw.MODES]

JAX_CODE = """
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core import ising
from repro.core.ising import EdgeList
from repro.core.bitplane import BitPlanes, encode_couplings
from repro.core.schedules import geometric, linear
from repro.core.solver import SolverConfig
from repro.distributed.solver_sharded import (
    nearest_row_shard_counts, shard_planes_from_edges, sharded_sweep_fn,
    solve_sharded)

mesh_2d = mesh
mesh_1d = Mesh(np.array(jax.devices()), ("spins",))
N, STEPS, R, T = {N}, {STEPS}, {R}, {T}

def int_j(n, seed, amax=3):
    g = np.random.default_rng(seed)
    J = np.clip(np.rint(g.normal(size=(n, n)) * 1.5), -amax, amax)
    J = np.triu(J, 1)
    return J + J.T

out = {{}}
prob = ising.IsingProblem.create(J=int_j(N, 11))
for mode, uni in {MODES}:
    cfg = SolverConfig(num_steps=STEPS, schedule=linear(4.0, 0.05, STEPS),
                       mode=mode, uniformized=uni, num_replicas=R,
                       trace_every=24)
    for name, m in (("1d", mesh_1d), ("2d", mesh_2d)):
        res = solve_sharded(prob, 5, cfg, m)
        for f in res._fields:
            out[f"sharded/{{mode}}/{{uni}}/{{name}}/{{f}}"] = np.asarray(
                getattr(res, f))

J3 = int_j(N, 3)
planes = encode_couplings(J3, 2, align_words=128)
sh = NamedSharding(mesh_1d, P(None, "spins", None))
planes = BitPlanes(pos=jax.device_put(planes.pos, sh),
                   neg=jax.device_put(planes.neg, sh), num_spins=N)
groups_list = {GROUPS}
temps = jnp.full((T, 8), 1.0, jnp.float32)
for mode, uni in (("rsa", False), ("rwa", False), ("rwa", True)):
    cfg = SolverConfig(num_steps=T, schedule=linear(3.0, 0.1, T), mode=mode,
                       uniformized=uni, num_replicas=8,
                       coupling_format="bitplane_sharded")
    fns = {{True: sharded_sweep_fn(cfg, mesh_1d, N, coalesce=True),
           False: sharded_sweep_fn(cfg, mesh_1d, N, coalesce=False)}}
    for gi, groups in enumerate(groups_list):
        g = np.random.default_rng(0)
        s_g = np.where(g.random((max(groups) + 1, N)) < .5, 1., -1.)
        s0 = s_g[np.asarray(groups)].astype(np.float32)
        u0 = (J3 @ s0.T).T.astype(np.float32)
        e0 = (-0.5 * np.einsum("rn,rn->r", u0, s0)).astype(np.float32)
        g = np.random.default_rng(1)
        u_g = g.random((T, max(groups) + 1, 4)).astype(np.float32)
        unif = jnp.asarray(u_g[:, np.asarray(groups), :])
        for coalesce, fn in fns.items():
            got = fn(planes, jnp.asarray(u0), jnp.asarray(s0),
                     jnp.asarray(e0), unif, temps)
            for k, x in enumerate(got):
                out[f"coalesce/{{mode}}/{{uni}}/{{gi}}/{{coalesce}}/{{k}}"] = \\
                    np.asarray(x)

def error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"

def prob_of(n):
    g = np.random.default_rng(0)
    J = np.clip(np.rint(g.normal(size=(n, n))), -3, 3)
    J = np.triu(J, 1)
    return ising.IsingProblem.create(J=J + J.T)

cfg4 = SolverConfig(num_steps=8, schedule=geometric(1.0, 0.1, 8),
                    num_replicas=4)
cfg3 = SolverConfig(num_steps=8, schedule=geometric(1.0, 0.1, 8),
                    num_replicas=3)
p513 = prob_of(513)
errors = {{
    "1d_513": error(lambda: solve_sharded(p513, 0, cfg4, mesh_1d)),
    "2d_513": error(lambda: solve_sharded(p513, 0, cfg4, mesh_2d)),
    "lane_192": error(lambda: solve_sharded(prob_of(192), 0, cfg4, mesh_1d)),
    "edges_513": error(lambda: shard_planes_from_edges(
        EdgeList.from_dense(np.asarray(p513.couplings)), mesh_1d)),
    "replicas_3": error(lambda: solve_sharded(prob_of(512), 0, cfg3,
                                              mesh_2d)),
    "sharded_2d_on_1d": error(lambda: solve_sharded(
        prob, 0, SolverConfig(num_steps=8, schedule=geometric(1.0, 0.1, 8),
                              num_replicas=4,
                              coupling_format="bitplane_sharded_2d"),
        mesh_1d)),
}}
out["nearest"] = np.asarray(nearest_row_shard_counts(513, 4))
np.savez("{OUT}", **out)
with open("{OUT}.json", "w") as f:
    json.dump(errors, f)
print("JAX SHARDED OK")
"""


def _jax_reference(out) -> dict:
    code = JAX_CODE.format(
        N=tw.N, STEPS=tw.STEPS, R=tw.R, T=tw.COALESCE_T, MODES=tw.MODES,
        GROUPS=[g for g, _ in tw.COALESCE_GROUPS], OUT=out)
    assert "JAX SHARDED OK" in run_with_forced_devices(code, mesh_shape=(2, 2))
    with open(f"{out}.json") as f:
        errors = json.load(f)
    return {"arrays": dict(np.load(out)), "errors": errors}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 and the JAX reference, run at the same time."""
    jax_out = str(tmp_path_factory.mktemp("jax") / "sharded.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_ref = pool.submit(_jax_reference, jax_out)
        ranks = run_world("torch_worlds:sharded_world", 4,
                          args=(str(tmp_path_factory.mktemp("runs")),),
                          timeout=900)
        return ranks, jax_ref.result()


@pytest.fixture(scope="module")
def fused():
    """The port's single-device tiers on the same instance, per mode."""
    prob = ising.IsingProblem.create(J=tw.int_j(), device="cpu")
    return {(mode, uni, fmt): tw.result_dict(solve(
        prob, 5, dataclasses.replace(tw.parity_config(mode, uni),
                                     coupling_format=fmt), device="cpu"))
        for mode, uni in tw.MODES for fmt in TIERS}


def _equal(a: dict, b: dict, fields=tw.RESULT_FIELDS, msg=""):
    for f in fields:
        assert torch.equal(a[f], b[f]), f"{msg}{f}"


def _equal_jax(port: dict, jax: dict, key: str, fields):
    for f in fields:
        np.testing.assert_array_equal(
            port[f].numpy(), jax[f"{key}/{f}"], err_msg=f"{key}/{f}")


@pytest.mark.parametrize("mode,uni", tw.MODES, ids=MODE_IDS)
def test_six_way_parity_on_a_2x2_world(runs, fused, mode, uni):
    ranks, _ = runs
    base = fused[(mode, uni, "dense")]
    for fmt in TIERS[1:]:
        _equal(base, fused[(mode, uni, fmt)], msg=f"{fmt}: ")
    for rank, out in enumerate(ranks):
        for name in SHARDED:
            _equal(base, out["parity"][(mode, uni, name)],
                   msg=f"rank {rank} {name}: ")
    # 1-D coalesces over all R=4 replicas, as the streamed tier's group
    # of fit_block(4, 8) = 4 does: the same rows.
    hbm = fused[(mode, uni, "bitplane_hbm")]
    for name in SHARDED[:2]:
        assert torch.equal(hbm["rows_fetched"],
                           ranks[0]["parity"][(mode, uni, name)]
                           ["rows_fetched"])


@pytest.mark.parametrize("mode,uni", tw.MODES, ids=MODE_IDS)
def test_sharded_equals_jax_solve_sharded(runs, mode, uni):
    """Bitwise JAX's ``solve_sharded`` on both meshes, ``rows_fetched``
    included. RSA + PWL + integer J is the anchor; RWA could split at a
    near tie of the roulette's sums (``kernels.parity``), which these
    runs do not meet."""
    ranks, ref = runs
    fields = tw.RESULT_FIELDS + ("rows_fetched",)
    for name, key in (("bitplane_sharded", "1d"),
                      ("bitplane_sharded_2d", "2d")):
        _equal_jax(ranks[0]["parity"][(mode, uni, name)], ref["arrays"],
                   f"sharded/{mode}/{uni}/{key}", fields)


def test_resilient_sharded_2d_chunked_and_resumed(runs):
    ranks, _ = runs
    for out in ranks:
        mono = out["parity"][("rwa", False, "bitplane_sharded_2d")]
        _equal(mono, out["resilient"], msg="chunked: ")
        _equal(mono, out["resumed"], msg="resumed: ")
        assert out["resumed_from"] == 2
    # One snapshot per run directory, written by the mesh's rank 0.
    assert [out["writes_snapshots"] for out in ranks] == \
        [True, False, False, False]


@pytest.mark.parametrize("mode,uni", tw.MODES, ids=MODE_IDS)
@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_step_collectives_are_counted_bounded_and_row_scoped(
        runs, mode, uni, mesh):
    """A bare sweep's collectives: RSA one zero-padded sum a step (u and
    s at the site), RWA three (block sums, the chosen block's lanes, the
    picks' values), and one broadcast per unique row; on the 2×2 mesh
    every one is on the rows dim."""
    ranks, _ = runs
    steps = 6
    for out in ranks:
        counts, rows, r_loc = out["step_collectives"][(mode, uni, mesh)]
        dim = "rows" if mesh == "2d" else "spins"
        assert {d for _, d in counts} == {dim}
        per_step = 1 if mode == "rsa" else 3
        assert counts[("all_reduce_sum", dim)] == per_step * steps
        assert counts[("broadcast", dim)] == rows <= r_loc * steps
    # The full 2-D solve crosses groups only to put the trace rows and the
    # result together: 4 trace rows and 7 result fields.
    for m, u in tw.MODES:
        counts = ranks[0]["collectives"][(m, u, "bitplane_sharded_2d")]
        assert counts[("all_reduce_sum", "groups")] == 4 + 7


def test_no_rank_holds_an_nxn_tensor_or_the_full_planes(runs):
    """An edge-ingested solve under a dispatch mode that records every
    op's output: no (N, N) tensor, nothing larger than the rank's (B,
    N/4, W) plane slab."""
    ranks, _ = runs
    n = tw.N
    for out in ranks:
        largest, has_nxn, slab = out["largest"]
        assert slab == (2, n // 4, 128)
        assert not has_nxn
        assert largest <= int(np.prod(slab))
        # The full planes' words of one sign: four slabs.
        assert largest <= ranks[0]["fused_store_bytes"] // 4 // 2 // 4


@pytest.mark.parametrize("mode,uni", [("rsa", False), ("rwa", False),
                                      ("rwa", True)],
                         ids=["rsa", "rwa", "rwa-uniformized"])
def test_rows_fetched_coalesced_against_uncoalesced_and_jax(runs, mode, uni):
    ranks, ref = runs
    t, r = tw.COALESCE_T, 8
    for gi, (groups, max_unique) in enumerate(tw.COALESCE_GROUPS):
        got = ranks[0]["coalesce"][(mode, uni, gi, True)]
        want = ranks[0]["coalesce"][(mode, uni, gi, False)]
        for k in range(6):
            assert torch.equal(got[k], want[k]), (gi, k)
        rf_c, rf_u = got[6], want[6]
        assert int(rf_u.sum()) == r * t
        assert int(rf_c.sum()) <= max_unique * t
        leaders = sorted({groups.index(x) for x in set(groups)})
        others = [i for i in range(r) if i not in leaders]
        if others:
            assert bool((rf_c[others] == 0).all())
        for coalesce, res in ((True, got), (False, want)):
            key = f"coalesce/{mode}/{uni}/{gi}/{coalesce}"
            np.testing.assert_array_equal(res[6].numpy(),
                                          ref["arrays"][f"{key}/6"])
            for k in range(6):
                np.testing.assert_array_equal(
                    res[k].numpy(), ref["arrays"][f"{key}/{k}"],
                    err_msg=f"{key}/{k}")
        for out in ranks[1:]:
            for k in range(7):
                assert torch.equal(
                    out["coalesce"][(mode, uni, gi, True)][k], got[k])


@pytest.mark.parametrize("case", ["1d_513", "2d_513", "lane_192",
                                  "edges_513", "replicas_3",
                                  "sharded_2d_on_1d"])
def test_divisibility_and_validation_errors_are_jax_words(runs, case):
    ranks, ref = runs
    want = ref["errors"][case]
    assert want != "no error"
    for out in ranks:
        assert out["errors"][case] == want
    assert tuple(ranks[0]["nearest"]) == tuple(ref["arrays"]["nearest"]) \
        == (3, 1, 9)


# ------------------------------------------------ a world of 1, in-process

@pytest.fixture(scope="module")
def mesh1():
    M.init_world("gloo", rank=0, world_size=1, device_type="cpu")
    try:
        yield M.build_mesh("1", "cpu")
    finally:
        dist.destroy_process_group()


def _int_problem(seed, n, amax=3):
    return ising.IsingProblem.create(J=tw.int_j(n, seed, amax),
                                     device="cpu")


def test_world_of_one_equals_the_fused_solve(mesh1):
    prob = _int_problem(11, 128)
    cfg = tw.parity_config("rwa", False)
    sharded = ss.solve_sharded(prob, 5, cfg, mesh1, device="cpu")
    fused = solve(prob, 5, dataclasses.replace(cfg,
                                               coupling_format="bitplane"),
                  device="cpu")
    _equal(tw.result_dict(fused), tw.result_dict(sharded))
    assert torch.equal(sharded.best_energy,
                       ising.energy(prob, sharded.best_spins))


def test_prepacked_planes_match_the_rebuild_and_bytes_per_shard(mesh1):
    prob = _int_problem(7, 128)
    cfg = dataclasses.replace(tw.parity_config("rsa", False),
                              coupling_format="bitplane_sharded")
    planes = tcoupling.encode_planes(prob.couplings, fmt="bitplane_sharded")
    assert planes.num_words % 128 == 0
    via_planes = ss.solve_sharded(prob, 2, cfg, mesh1, coupling=planes,
                                  device="cpu")
    rebuilt = ss.solve_sharded(prob, 2, cfg, mesh1, device="cpu")
    _equal(tw.result_dict(rebuilt), tw.result_dict(via_planes))
    store = tcoupling.CouplingStore.from_planes(planes, "bitplane_sharded")
    assert store.plane_bytes_per_shard(2) * 2 == planes.nbytes
    assert store.plane_bytes_per_device((2, 4)) * 4 == planes.nbytes


def test_the_driver_validates_its_inputs(mesh1):
    prob = _int_problem(3, 128)
    cfg = dataclasses.replace(tw.parity_config("rsa", False),
                              num_steps=8, trace_every=0)
    with pytest.raises(ValueError, match="bitplane_sharded"):
        ss.solve_sharded(prob, 0, dataclasses.replace(
            cfg, coupling_format="dense"), mesh1, device="cpu")
    # The sharded formats on the single-device drivers point to
    # solve_sharded, prepacked planes too (no quiet downgrade).
    sharded_cfg = dataclasses.replace(cfg, coupling_format="bitplane_sharded")
    with pytest.raises(ValueError, match="solve_sharded"):
        solve(prob, 0, sharded_cfg, backend="fused", device="cpu")
    planes = tcoupling.encode_planes(prob.couplings, fmt="bitplane_sharded")
    with pytest.raises(ValueError, match="solve_sharded"):
        ops.fused_anneal(prob, 0, sharded_cfg, coupling=planes, device="cpu")
    g = np.random.default_rng(0)
    J = np.triu(g.normal(size=(64, 64)), 1) + 0.5
    J = np.triu(J, 1)
    frac = ising.IsingProblem.create(J=J + J.T, device="cpu")
    with pytest.raises(ValueError, match="integer"):
        ss.solve_sharded(frac, 0, cfg, mesh1, device="cpu")
    with pytest.raises(ValueError, match="bitplane_sharded_2d"):
        ss.solve_sharded(prob, 0, dataclasses.replace(
            cfg, coupling_format="bitplane_sharded_2d"), mesh1,
            device="cpu")
    with pytest.raises(ValueError, match="flip_mode"):
        ss.solve_sharded(prob, 0, dataclasses.replace(
            cfg, flip_mode="colored"), mesh1, device="cpu")


def test_a_mesh_of_another_device_type_raises():
    """No fallback: a CUDA mesh never runs a CPU solve."""
    cuda_mesh = types.SimpleNamespace(device_type="cuda")
    prob = _int_problem(3, 128)
    with pytest.raises(ValueError, match="device type"):
        ss.solve_sharded(prob, 0, tw.parity_config("rsa", False), cuda_mesh,
                         device="cpu")
    with pytest.raises(ValueError, match="device type"):
        M.check_mesh_device(types.SimpleNamespace(device_type="cpu"),
                            torch.device("cuda"))
