"""The reference's Hamiltonian, contractions and TDVP step agree with the
program's on seeded states (CPU, double precision): the check's numbers of
a sound program sit at rounding."""

import os
import sys

import numpy as np
import pytest

os.environ.setdefault("RENO_PLATFORM", "cpu")
os.environ.setdefault("RENO_DTYPE", "fp64")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import workloads  # noqa: E402
from reference import judge  # noqa: E402

MODEL = {"model": "holstein_chain", "n_mol": 3, "elocalex_ev": 2.67, "j_ev": -0.1,
         "modes": [{"omega_cm": 106.51, "displacement_au": 30.1370, "levels": 3},
                   {"omega_cm": 1555.55, "displacement_au": 8.7729, "levels": 3}],
         "m": 10, "qntot": 1}


@pytest.fixture(scope="module")
def port():
    import renormalizer_tpu_torch as rt
    from renormalizer_tpu_torch.backend import backend

    if backend.device.type != "cpu" or backend.real_dtype.itemsize != 8:
        pytest.skip("the CPU in double precision only")
    return rt


def test_chain_energy_of_a_random_state(port):
    model = workloads.holstein_model(MODEL)
    mpo = port.Mpo(model)
    mps = port.Mps.random(model, 1, 10, percent=1.0)
    e_program = float(mps.expectation(mpo)) / mps.mp_norm ** 2
    got = judge.ground_state(MODEL, workloads.chain_state(mps), e_program)
    assert got["e_gap"] < 1e-12
    assert got["sigma_rel"] > 1e-3  # a random state is no eigenstate
    assert got["bond_short"] == 0 and got["electrons_off"] < 1e-12
    # a state of another sector, or cut below M, is caught
    two = port.Mps.random(model, 2, 10, percent=1.0)
    assert judge.ground_state(MODEL, workloads.chain_state(two), e_program)["electrons_off"] > 0.99
    cut = port.Mps.random(model, 1, 6, percent=1.0)
    assert judge.ground_state(MODEL, workloads.chain_state(cut), e_program)["bond_short"] == 4


def test_tree_energy_of_a_random_state(port):
    from renormalizer_tpu_torch.tn import TTNO, BasisTree

    model = workloads.holstein_model(MODEL)
    tree = BasisTree.binary(model.basis)
    ttns = workloads.random_ttns(tree, 1, 6, np.random.default_rng(5))
    e_program = float(np.real(ttns.expectation(TTNO(tree, model.ham_terms)))) / ttns.ttns_norm ** 2
    got = judge.ground_state(dict(MODEL, m=6), workloads.tree_state(ttns), e_program)
    assert got["e_gap"] < 1e-12
    assert got["resid_rel"] > 1e-3
    assert got["bond_short"] == 0 and got["electrons_off"] < 1e-12


def test_tdvp_step_of_a_random_state(port):
    model = workloads.holstein_model(MODEL)
    mpo = port.Mpo(model)
    mps = port.Mps.random(model, 1, 10, percent=1.0)
    mps.evolve_config = port.EvolveConfig(port.EvolveMethod.tdvp_ps, adaptive=False)
    mps = mps.evolve(mpo, 0.2)  # complex from here on
    before = [t.clone() for t in mps]
    after = mps.evolve(mpo, 0.2)
    labels = [b.dof for b in model.basis]
    got = judge.tdvp_step(MODEL, labels, before, list(after), 0.2, False)
    assert got["step_dist"] < 1e-9
    assert got["bond_short"] == 0 and got["electrons_off"] < 1e-12
    # a step that went nowhere is far off
    assert judge.tdvp_step(MODEL, labels, before, before, 0.2, False)["step_dist"] > 1e-3
