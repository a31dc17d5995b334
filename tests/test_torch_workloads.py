"""The port's time-to-solution workflow against the JAX package's, on the
CPU: the generators and Gset parsers (bit-equal), ``core.tts`` (equal
values, edge cases included), ``core.refine.greedy_descent`` (bitwise on
integer J), the QUBO and partitioning encodings (equal arrays and costs),
``core.placement`` (its invariants, and a cut within 10 % of JAX's: the
port's bisections run its fused solve, JAX's its reference one), and the
CLI's ``--gset``, ``sw<N>``, ``torus<side>`` and ``--tts-threshold``.
"""
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ising as jising
from repro.core import placement as jplacement
from repro.core import tts as jtts
from repro.core.refine import greedy_descent as jgreedy
from repro.graphs import generators as jgen
from repro.graphs import gset as jgset
from repro.graphs import maxcut as jmaxcut
from repro.graphs import partitioning as jpart
from repro.graphs import qubo as jqubo
from repro_torch import interop
from repro_torch.core import ising, placement, rng, tts
from repro_torch.core.refine import greedy_descent
from repro_torch.graphs import (GSET_SAMPLE, cut_value,
                                ground_state_planted_grid, parse_gset,
                                parse_gset_edges, partitioning, qubo,
                                small_world, torus_grid)
from repro_torch.graphs.maxcut import maxcut_edges_to_ising, maxcut_to_ising

SRC = Path(__file__).resolve().parents[1] / "src"


# --------------------------------------------------------------- generators


@pytest.mark.parametrize("n,k,p,seed,signed", [
    (40, 4, 0.1, 0, True), (48, 6, 0.3, 7, True), (30, 12, 0.1, 3, False)])
def test_small_world_bit_equal(n, k, p, seed, signed):
    want = jgen.small_world(n, k, p, seed=seed, signed=signed)
    got = small_world(n, k, p, seed=seed, signed=signed)
    assert got.weights.dtype == want.weights.dtype
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.name == want.name


@pytest.mark.parametrize("rows,cols,seed,signed", [
    (4, 4, 0, True), (5, 7, 3, True), (6, 6, 1, False), (2, 5, 2, True)])
def test_torus_grid_bit_equal(rows, cols, seed, signed):
    want = jgen.torus_grid(rows, cols, seed=seed, signed=signed)
    got = torus_grid(rows, cols, seed=seed, signed=signed)
    np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("rows,cols,seed", [(4, 4, 1), (3, 6, 5)])
def test_planted_grid_bit_equal_and_optimal(rows, cols, seed):
    jinst, jplant = jgen.ground_state_planted_grid(rows, cols, seed=seed)
    inst, plant = ground_state_planted_grid(rows, cols, seed=seed)
    np.testing.assert_array_equal(inst.weights, jinst.weights)
    np.testing.assert_array_equal(plant, jplant)
    assert inst.best_known == jinst.best_known
    assert cut_value(inst, plant) == inst.best_known
    for i in range(rows * cols):
        s2 = plant.copy()
        s2[i] = -s2[i]
        assert cut_value(inst, s2) <= inst.best_known


def test_cut_value_equals_jax():
    inst = small_world(40, 6, seed=2)
    g = np.random.default_rng(0)
    spins = g.choice(np.array([-1, 1], np.int8), size=(5, 40))
    want = jmaxcut.cut_value(jgen.small_world(40, 6, seed=2), spins)
    np.testing.assert_array_equal(cut_value(inst, spins), want)
    assert cut_value(inst, spins[0]) == want[0]


# --------------------------------------------------------------------- Gset


def test_gset_parsers_bit_equal():
    want = jgset.parse_gset(GSET_SAMPLE, name="sample")
    got = parse_gset(GSET_SAMPLE, name="sample")
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.num_edges == want.num_edges == 14
    jedges = jgset.parse_gset_edges(GSET_SAMPLE)
    edges = parse_gset_edges(GSET_SAMPLE)
    for f in ("rows", "cols", "weights"):
        np.testing.assert_array_equal(getattr(edges, f),
                                      np.asarray(getattr(jedges, f)))
    np.testing.assert_array_equal(edges.to_dense(), got.weights)
    sparse = maxcut_edges_to_ising(edges)
    dense = maxcut_to_ising(got)
    assert sparse.couplings is None
    np.testing.assert_array_equal(sparse.edges.to_dense(),
                                  dense.couplings.numpy())


def test_gset_parsers_refuse_what_jax_refuses(tmp_path):
    bad = GSET_SAMPLE.replace("10 14", "10 15", 1)
    dup = bad + "2 1 1\n"
    for parse in (parse_gset, parse_gset_edges):
        with pytest.raises(ValueError, match="declared"):
            parse(bad)
    with pytest.raises(ValueError, match="duplicate"):
        parse_gset_edges(dup)
    path = tmp_path / "G_sample"
    path.write_text(GSET_SAMPLE)
    np.testing.assert_array_equal(parse_gset(str(path)).weights,
                                  jgset.parse_gset(str(path)).weights)
    with open(path) as fh:
        assert parse_gset_edges(fh).nnz == 14


# ---------------------------------------------------------------------- TTS


@pytest.mark.parametrize("p,t_a,target", [
    (0.38, 4610.0, 0.99), (0.07, 0.13, 0.99), (0.99, 0.128, 0.99),
    (0.0, 1.0, 0.99), (1.0, 2.0, 0.99), (0.5, 3.0, 0.9), (1e-6, 1e3, 0.5)])
def test_tts_equals_jax(p, t_a, target):
    assert tts.tts(p, t_a, target) == jtts.tts(p, t_a, target)


def test_tts_refuses_a_target_outside_zero_one():
    for target in (0.0, 1.0):
        with pytest.raises(ValueError):
            tts.tts(0.5, 1.0, target=target)


@pytest.mark.parametrize("best,threshold", [
    ([-10.0, -8.0, -10.0, -9.0], -10.0), ([], -10.0),
    ([np.inf] * 4, -10.0), ([-12.0, -11.0, -10.0], -10.0)])
def test_estimate_equals_jax(best, threshold):
    best = np.asarray(best, np.float32)
    want = jtts.estimate(best, threshold=threshold, time_per_run=2.0)
    got = tts.estimate(best, threshold=threshold, time_per_run=2.0)
    for f in ("success_probability", "num_runs", "num_successes",
              "time_per_run", "target_probability"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.tts == want.tts or (math.isinf(got.tts)
                                   and math.isinf(want.tts))
    with np.errstate(invalid="raise"):
        assert (tts.success_probability(best, threshold)
                == jtts.success_probability(best, threshold))


# ------------------------------------------------------------------- refine


def _int_problem(seed, n):
    g = np.random.default_rng(seed)
    J = np.rint(g.normal(size=(n, n)) * 2.0)
    J = np.triu(J, 1)
    return (J + J.T).astype(np.float32)


@pytest.mark.parametrize("seed,n,shape,max_flips", [
    (11, 24, (5,), 512), (14, 12, (2, 3), 512), (3, 40, (6,), 7),
    (13, 16, (2,), 0)])
def test_greedy_descent_bitwise_on_integer_j(seed, n, shape, max_flips):
    J = _int_problem(seed, n)
    h = np.rint(np.random.default_rng(seed).normal(size=n)).astype(np.float32)
    jp = jising.IsingProblem.create(J, h, offset=1.5)
    tp = interop.problem_from_numpy(J, h, 1.5)
    key = rng.fold_in(rng.key(0), seed)
    spins = ising.random_spins(key, shape + (n,))
    js, je = jgreedy(jp, jnp.asarray(spins.numpy()), max_flips=max_flips)
    ts, te = greedy_descent(tp, spins, max_flips=max_flips)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert ts.dtype == spins.dtype and ts.shape == spins.shape
    assert (te <= ising.energy(tp, spins) + tp.offset).all()


def test_greedy_descent_reaches_a_one_opt_fixpoint():
    tp = interop.problem_from_numpy(_int_problem(12, 16), np.zeros(16))
    spins = ising.random_spins(rng.key(1), (3, 16))
    once, e_once = greedy_descent(tp, spins)
    assert (ising.delta_energies(tp, once) >= 0).all()
    twice, e_twice = greedy_descent(tp, once)
    assert torch.equal(once, twice) and torch.equal(e_once, e_twice)


# ----------------------------------------------------- QUBO and partitioning


@pytest.mark.parametrize("seed,n", [(0, 6), (3, 9)])
def test_qubo_round_trip_and_equal_to_jax(seed, n):
    g = np.random.default_rng(seed)
    Q = g.normal(size=(n, n))
    want = jqubo.qubo_to_ising(Q)
    got = qubo.qubo_to_ising(Q)
    np.testing.assert_array_equal(got.couplings.numpy(),
                                  np.asarray(want.couplings))
    np.testing.assert_array_equal(got.fields.numpy(), np.asarray(want.fields))
    assert got.offset == want.offset
    for _ in range(8):
        x = g.integers(0, 2, n)
        s = torch.from_numpy((2 * x - 1).astype(np.float32))
        e = float(ising.energy(got, s)) + got.offset
        assert e == pytest.approx(qubo.qubo_energy(Q, x), rel=1e-5,
                                  abs=1e-4)
    Q2, off2 = qubo.ising_to_qubo(got)
    jQ2, joff2 = jqubo.ising_to_qubo(want)
    np.testing.assert_array_equal(Q2, jQ2)
    assert off2 == joff2
    x = g.integers(0, 2, n)
    s = torch.from_numpy((2 * x - 1).astype(np.float32))
    assert qubo.qubo_energy(Q2, x) + off2 == pytest.approx(
        float(ising.energy(got, s)) + got.offset, rel=1e-5, abs=1e-4)


def test_partitioning_encodings_equal_jax():
    g = np.random.default_rng(5)
    w = np.triu(g.random((10, 10)), 1)
    w = w + w.T
    want = jpart.graph_partitioning_to_ising(w, 0.3)
    got = partitioning.graph_partitioning_to_ising(w, 0.3)
    np.testing.assert_array_equal(got.couplings.numpy(),
                                  np.asarray(want.couplings))
    assert got.offset == want.offset
    values = [4, 5, 6, 7, 8]
    jnum = jpart.number_partitioning_to_ising(values)
    num = partitioning.number_partitioning_to_ising(values)
    np.testing.assert_array_equal(num.couplings.numpy(),
                                  np.asarray(jnum.couplings))
    assert num.offset == jnum.offset
    e, s, _ = ising.brute_force_ground_state(num)
    assert e == 0.0 and partitioning.partition_residue(values, s) == 0.0
    for _ in range(6):
        spins = g.choice([-1, 1], size=10)
        assert (partitioning.partition_cost(w, spins, 0.3)
                == jpart.partition_cost(w, spins, 0.3))
        assert (partitioning.partition_residue(values, spins[:5])
                == jpart.partition_residue(values, spins[:5]))


# ---------------------------------------------------------------- placement


def _traffic(seed, e=12, clusters=2):
    g = np.random.default_rng(seed)
    C = g.random((e, e)) * 0.2
    step = e // clusters
    for c in range(clusters):
        C[c * step:(c + 1) * step, c * step:(c + 1) * step] += 3.0
    C = np.triu(C, 1)
    return C + C.T


@pytest.mark.parametrize("e,devices,seed", [(16, 4, 1), (12, 2, 3)])
def test_place_invariants_and_cut_near_jax(e, devices, seed):
    C = _traffic(seed, e=e, clusters=devices)
    loads = np.ones(e)
    res = placement.place(C, num_devices=devices, loads=loads, seed=seed,
                          steps=200, replicas=4, device="cpu")
    again = placement.place(C, num_devices=devices, loads=loads, seed=seed,
                            steps=200, replicas=4, device="cpu")
    np.testing.assert_array_equal(res.assignment, again.assignment)
    assert res.assignment.shape == (e,) and res.num_devices == devices
    assert res.assignment.min() >= 0 and res.assignment.max() < devices
    assert np.bincount(res.assignment, minlength=devices).min() >= 1
    assert res.cut_bytes == placement.cut_bytes(C, res.assignment)
    dev = np.array([loads[res.assignment == d].sum()
                    for d in range(devices)])
    assert res.imbalance == pytest.approx(dev.max() / dev.mean() - 1.0)
    want = jplacement.place(C, num_devices=devices, loads=loads, seed=seed,
                            steps=200, replicas=4)
    assert abs(res.cut_bytes - want.cut_bytes) <= 0.1 * want.cut_bytes


def test_placement_helpers_equal_jax():
    C = np.array([[0.0, 2.0, 3.0], [2.0, 0.0, 5.0], [3.0, 5.0, 0.0]])
    for a in ([0, 0, 1], [0, 0, 0], [0, 1, 2]):
        assert (placement.cut_bytes(C, np.array(a))
                == jplacement.cut_bytes(C, np.array(a)))
    probs = np.random.default_rng(2).random((40, 6))
    np.testing.assert_array_equal(placement.expert_traffic_matrix(probs),
                                  jplacement.expert_traffic_matrix(probs))
    with pytest.raises(ValueError, match="power of two"):
        placement.place(_traffic(0, e=9), num_devices=3, device="cpu")


# ---------------------------------------------------------------------- CLI


def _cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_cli_gset_file_and_tts_threshold(tmp_path):
    path = tmp_path / "G_sample"
    path.write_text(GSET_SAMPLE)
    out = _cli("--gset", str(path), "--mode", "rsa", "--steps", "200",
               "--tts-threshold", "9")
    assert f"instance={path} |V|=10 |E|=14" in out
    assert "best cut =" in out
    line = [x for x in out.splitlines() if x.startswith("TTS(0.99)")]
    assert len(line) == 1 and "cut≥9:" in line[0] and "P_a=" in line[0]


def test_cli_small_world_and_torus():
    out = _cli("--instance", "sw48", "--steps", "200")
    assert "instance=sw |V|=48" in out and "best cut =" in out
    out = _cli("--instance", "torus6", "--mode", "rsa", "--steps", "200",
               "--tts-threshold", "1000")
    assert "instance=torus |V|=36 |E|=72" in out
    assert "TTS(0.99) @ cut≥1000: inf ms (P_a=0.00)" in out


def test_quickstart_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
         "cpu"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [x.split()[0] for x in lines] == ["mode=rsa", "mode=rwa"]
    # RWA is rejection-free: one flip a step.
    assert "flips/replica=4000" in lines[1]
