"""``configs.snowball.GSET_TABLE1`` and ``graphs.maxcut.energy_from_cut``
against the JAX package's, on the CPU: the table field by field in the same
order; the energy of a cut equal to JAX's on a signed Erdős–Rényi, a small
world and a torus instance, with cuts of random spins from a numpy seed, and
the inverse of ``cut_from_energy``.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import snowball as jsnowball
from repro.graphs import generators as jgen
from repro.graphs import maxcut as jmaxcut
from repro_torch.configs import snowball
from repro_torch.graphs import cut_from_energy, cut_value, energy_from_cut
from repro_torch.graphs import generators as tgen

INSTANCES = {
    "erdos_renyi": lambda g: g.erdos_renyi(40, 200, seed=6, signed=True),
    "small_world": lambda g: g.small_world(48, 6, 0.2, seed=18, signed=True),
    "torus": lambda g: g.torus_grid(6, 8, seed=11, signed=True),
}


def _pair(family):
    return INSTANCES[family](tgen), INSTANCES[family](jgen)


def _spins(n, seed):
    return np.random.default_rng(seed).choice(
        np.array([-1.0, 1.0], np.float32), size=(16, n))


def test_gset_table1_equals_the_reference():
    got, want = snowball.GSET_TABLE1, jsnowball.GSET_TABLE1
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
    assert [b.name for b in got] == ["G6", "G61", "G18", "G64", "G11", "G62"]


@pytest.mark.parametrize("family", sorted(INSTANCES))
def test_energy_from_cut_equals_the_reference(family):
    inst, jinst = _pair(family)
    np.testing.assert_array_equal(inst.weights, jinst.weights)
    cuts = cut_value(inst, _spins(inst.num_vertices, 1))
    got = energy_from_cut(inst, cuts)
    want = jmaxcut.energy_from_cut(jinst, cuts)
    assert got.shape == want.shape == (16,)
    np.testing.assert_array_equal(got, want)
    assert energy_from_cut(inst, float(cuts[0])) == \
        jmaxcut.energy_from_cut(jinst, float(cuts[0]))


@pytest.mark.parametrize("family", sorted(INSTANCES))
def test_energy_from_cut_inverts_cut_from_energy(family):
    inst, _ = _pair(family)
    spins = _spins(inst.num_vertices, 2).astype(np.float64)
    w = inst.weights.astype(np.float64)
    # H(s) = Σ_{i<j} w_ij s_i s_j for the J = −w encoding (zero diagonal).
    energies = 0.5 * np.einsum("ri,ij,rj->r", spins, w, spins)
    np.testing.assert_array_equal(
        energy_from_cut(inst, cut_from_energy(inst, energies)), energies)
    np.testing.assert_array_equal(
        energy_from_cut(inst, cut_value(inst, spins)), energies)
