"""The port's replica-parallel ``solve_distributed`` and the multi-GPU
plumbing, on the CPU.

* Kernel A's key with a device fold: ``stream(base, SWEEP, d, chunk)``,
  bitwise ``rng.stream`` and JAX's, in the plain version of the kernel's
  draw and in the keyed sweep's CPU branch; without the fold every key is
  the one it was.
* ``solve_distributed`` on a gloo world of 4 (a 2×2 mesh), fused and
  reference, RSA and RWA: deterministic across two runs, energies exact,
  every rank holding the same result, bitwise JAX's on a forced-4-device
  2×2 mesh; on a plane store, bitwise JAX's plane run; under
  ``run_resilient`` (named and "auto").
* The mesh helpers, a world of 1 in this process, and the sharded CLI.
"""
import concurrent.futures
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_worlds as tw
from conftest import run_with_forced_devices
from repro.core import rng as jrng
from repro_torch.core import ising, rng as trng
from repro_torch.distributed import mesh as M
from repro_torch.distributed.world import run_world
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sweep

SRC = Path(__file__).resolve().parents[1] / "src"
KEYS = [("fused", "rsa"), ("fused", "rwa"), ("reference", "rsa"),
        ("reference", "rwa")]


# ----------------------------------------------------------- the device fold

@pytest.mark.parametrize("seed", [0, 2**31 + 5])
@pytest.mark.parametrize("fold", [0, 1, 3, 1000])
@pytest.mark.parametrize("chunk", [0, 7])
def test_device_fold_key_is_the_stream(seed, fold, chunk):
    """``ref.sweep_chunk_key`` and the draw's plain version (the kernel's
    per-thread counters) with a fold equal ``uniform01(stream(base, SWEEP,
    fold, chunk))`` in both packages."""
    jbase = jax.random.fold_in(jax.random.key(0), jnp.asarray(seed,
                                                              jnp.uint32))
    tbase = trng.fold_in(trng.key(0), seed)
    words = trng.words(tbase)
    key = tref.sweep_chunk_key(words, chunk, fold)
    assert torch.equal(key, trng.stream(tbase, trng.Salt.SWEEP, fold, chunk))
    shape = (70, 3, 4)
    want = np.asarray(jrng.uniform01(jrng.stream(jbase, jrng.Salt.SWEEP,
                                                 fold, chunk), shape))
    np.testing.assert_array_equal(trng.uniform01(key, shape).numpy(), want)
    np.testing.assert_array_equal(
        tref.sweep_uniforms(words, chunk, 70, 3, fold=fold).numpy(), want)
    np.testing.assert_array_equal(
        sweep.sweep_uniforms(words, chunk, 70, 3, fold=fold).numpy(), want)


def test_without_a_fold_every_key_is_unchanged():
    base = trng.fold_in(trng.key(0), 5)
    words = trng.words(base)
    assert torch.equal(tref.sweep_chunk_key(words, 3),
                       trng.stream(base, trng.Salt.SWEEP, 3))
    assert torch.equal(tref.sweep_uniforms(words, 3, 65, 2),
                       trng.uniform01(trng.stream(base, trng.Salt.SWEEP, 3),
                                      (65, 2, 4)))
    assert not torch.equal(tref.sweep_uniforms(words, 3, 65, 2),
                           tref.sweep_uniforms(words, 3, 65, 2, fold=0))


def test_keyed_sweep_with_a_fold_reads_the_folded_stream():
    """The keyed sweep's CPU branch with ``fold=d`` is the plain sweep on
    ``uniform01(stream(base, SWEEP, d, chunk))``; a negative fold
    raises."""
    prob = ising.IsingProblem.create(J=tw.int_j(64, 2), device="cpu")
    spins = torch.where(torch.rand(3, 64, generator=torch.Generator()
                                   .manual_seed(0)) < .5, 1.0, -1.0)
    u = ising.local_fields(prob, spins)
    e = ising.energy(prob, spins)
    temps = torch.full((20, 3), 2.0)
    base = trng.fold_in(trng.key(0), 9)
    words = trng.words(base)
    got = sweep.mcmc_sweep_keyed(prob.couplings, u, spins, e, words, 4,
                                 temps, mode="rsa", fold=2)
    unif = trng.uniform01(trng.stream(base, trng.Salt.SWEEP, 2, 4),
                          (20, 3, 4))
    want = tref.mcmc_sweep(prob.couplings, u, spins, e, unif, temps,
                           mode="rsa")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fold"):
        sweep.mcmc_sweep_keyed(prob.couplings, u, spins, e, words, 4, temps,
                               mode="rsa", fold=-1)


# ------------------------------------------------- solve_distributed, world 4

JAX_CODE = """
import numpy as np
from repro.core.schedules import linear
from repro.core.solver import SolverConfig
from repro.distributed.solver_dist import DistSolverConfig, solve_distributed
from repro.graphs import complete_bipolar, maxcut_to_ising

prob = maxcut_to_ising(complete_bipolar(48, seed=3))
out = {{}}
for backend, mode, fmt in {KEYS}:
    base = SolverConfig(num_steps=512, schedule=linear(8.0, 0.05, 512),
                        mode=mode, num_replicas=1, trace_every=64,
                        coupling_format=fmt)
    cfg = DistSolverConfig(base=base, replicas_per_device=2,
                           exchange_every=2, backend=backend)
    res = solve_distributed(prob, 7, cfg, mesh)
    for f in res._fields:
        x = getattr(res, f)
        if x is not None:
            out[f"{{backend}}/{{mode}}/{{fmt}}/{{f}}"] = np.asarray(x)
np.savez("{OUT}", **out)
print("JAX DIST OK")
"""


def _jax_reference(out) -> dict:
    keys = [k + ("auto",) for k in KEYS] + [("fused", "rsa", "bitplane")]
    code = JAX_CODE.format(KEYS=keys, OUT=out)
    assert "JAX DIST OK" in run_with_forced_devices(code, mesh_shape=(2, 2))
    return dict(np.load(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 and the JAX reference, run at the same time."""
    jax_out = str(tmp_path_factory.mktemp("jax") / "dist.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_ref = pool.submit(_jax_reference, jax_out)
        ranks = run_world("torch_worlds:dist_world", 4, timeout=600)
        return ranks, jax_ref.result()


FIELDS = ("best_energy", "best_spins", "final_energy", "num_flips",
          "trace_energy")


@pytest.mark.parametrize("backend,mode", KEYS)
def test_solve_distributed_deterministic_exact_and_jax(runs, backend, mode):
    ranks, ref = runs
    prob = tw_problem()
    first, second = ranks[0][(backend, mode)]
    assert first["best_energy"].shape == (8,)    # 4 ranks × 2 replicas
    for f in FIELDS:
        assert torch.equal(first[f], second[f]), f
        for out in ranks[1:]:
            assert torch.equal(out[(backend, mode)][0][f], first[f]), f
        np.testing.assert_array_equal(first[f].numpy(),
                                      ref[f"{backend}/{mode}/auto/{f}"],
                                      err_msg=f)
    assert torch.equal(first["best_energy"],
                       ising.energy(prob, first["best_spins"]))
    assert float(first["best_energy"].min()) < 0
    assert first["trace_energy"].shape == (8, 8)


def test_distributed_on_planes_and_under_the_supervisor(runs):
    """The plane store's solve is JAX's plane solve bitwise (an exchange
    whose vote ties leaves 0 entries in the broadcast spins, which the
    plane init reads as -1 and the dense one as 0, in both packages: so
    it is held to JAX's run on the same store, not to the dense one).
    The supervisor's chunked runs are the monolithic solve."""
    ranks, ref = runs
    for out in ranks:
        for f in FIELDS:
            np.testing.assert_array_equal(
                out["planes"][f].numpy(), ref[f"fused/rsa/bitplane/{f}"],
                err_msg=f)
        mono = out[("fused", "rsa")][0]
        for key in ("resilient", "auto"):
            for f in FIELDS:
                assert torch.equal(out[key][f], mono[f]), (key, f)


def tw_problem():
    from repro_torch.graphs import complete_bipolar, maxcut_to_ising
    return maxcut_to_ising(complete_bipolar(48, seed=3), device="cpu")


# ---------------------------------------------------------- mesh and launch

def test_mesh_shapes_and_names():
    assert M.parse_mesh_shape(None, 4) == (4,)
    assert M.parse_mesh_shape("2x2", 4) == (2, 2)
    assert M.parse_mesh_shape("8", 1) == (8,)
    for bad in ("2xa", "0", ""):
        with pytest.raises(ValueError, match="mesh shape"):
            M.parse_mesh_shape(bad, 4)
    assert M.mesh_dim_names((4,)) == ("spins",)
    assert M.mesh_dim_names((2, 2)) == ("groups", "rows")
    assert M.mesh_dim_names((2, 2, 2)) == ("groups0", "groups1", "rows")


def test_world_of_one_in_process():
    with pytest.raises(RuntimeError, match="process group"):
        M.build_mesh("1", "cpu")
    M.init_world("gloo", rank=0, world_size=1, device_type="cpu")
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            M.build_mesh("4", "cpu")
        mesh = M.build_mesh(None, "cpu")
        assert M.mesh_desc(mesh) == "(spins=1)"
        assert M.flat_shard_index(mesh, mesh.mesh_dim_names) == 0
        assert M.agree(3, mesh, torch.device("cpu")) == 3
        M.COLLECTIVES.reset()
        x = M.assemble(torch.tensor([-0.0, 2.5]), (4,), (slice(1, 3),),
                       mesh, mesh.mesh_dim_names)
        assert torch.equal(torch.signbit(x),
                           torch.tensor([False, True, False, False]))
        assert M.COLLECTIVES.counts[("all_reduce_sum", "spins")] == 1
    finally:
        dist.destroy_process_group()


def test_sharded_cli_on_a_world_of_one():
    """``--engine sharded`` without ``torch.distributed.run`` starts a world
    of 1 on the CPU and prints the mesh, the collectives per step and the
    rank's plane bytes."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--engine",
         "sharded", "--instance", "sparse256", "--steps", "64",
         "--replicas", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "engine=sharded backend=sharded mesh=(spins=1)" in out.stdout
    assert "collectives/step=" in out.stdout
    assert "plane_bytes_per_rank=" in out.stdout and "best cut =" in out.stdout
