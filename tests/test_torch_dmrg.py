"""The port's 2-site DMRG against the JAX package's, fp64 on the CPU.

Both start from the same MPS (the JAX ``Mps.random`` carried across with
``interop.mps_from_numpy``) on the 3-molecule Holstein fixture and run the
reference regression procedure; the JAX side runs its device-truncation
path with synchronous selection, the port's only path."""

import numpy as np
import pytest
import torch

from fixtures import GS_E, holstein_model
from renormalizer_tpu.mps import Mpo as JaxMpo
from renormalizer_tpu.mps import Mps as JaxMps
from renormalizer_tpu.mps.gs import optimize_mps as jax_optimize_mps
from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
from renormalizer_tpu_torch import interop
from renormalizer_tpu_torch.mps import Mpo, Mps, optimize_mps
from renormalizer_tpu_torch.utils import constant

torch.set_num_threads(2)

PROCEDURE = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]


def port_model() -> HolsteinModel:
    """``tests/fixtures.py``'s 3-molecule Holstein model in the port."""
    j_matrix = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3],
                         [-0.2, -0.3, 0.0]]) / constant.au2ev
    omegas = [Quantity(106.51, "cm^{-1}"), Quantity(1555.55, "cm^{-1}")]
    disps = [Quantity(30.1370, "a.u."), Quantity(8.7729, "a.u.")]
    ph_list = [Phonon([w, w], [Quantity(0), d], 4) for w, d in zip(omegas, disps)]
    return HolsteinModel([Mol(Quantity(2.67, "eV"), ph_list, 15.45)] * 3, j_matrix)


def _port_copy(jmps: JaxMps, model) -> Mps:
    return interop.mps_from_numpy(
        model, [np.asarray(mt) for mt in jmps], jmps.qn, jmps.qnidx,
        jmps.to_right, jmps.qntot)


def test_random_mps_is_identical():
    """One seed gives one start state in both packages."""
    jmps = JaxMps.random(holstein_model, 1, 10, percent=1.0)
    tmps = Mps.random(port_model(), 1, 10, percent=1.0)
    assert tmps.bond_dims == jmps.bond_dims
    assert tmps.qnidx == jmps.qnidx and tmps.to_right == jmps.to_right
    for mt, mj in zip(tmps, jmps):
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    for qt, qj in zip(tmps.qn, jmps.qn):
        np.testing.assert_array_equal(np.asarray(qt), np.asarray(qj))


def test_dmrg_matches_jax(monkeypatch):
    monkeypatch.setenv("RENO_DEVICE_TRUNC", "1")
    monkeypatch.setenv("RENO_ASYNC_TRUNC", "0")
    jmps = JaxMps.random(holstein_model, 1, 10, percent=1.0)
    model = port_model()
    tmps = _port_copy(jmps, model)
    jmps.optimize_config.procedure = PROCEDURE
    tmps.optimize_config.procedure = PROCEDURE
    jmps.optimize_config.method = tmps.optimize_config.method = "2site"

    e_jax, _ = jax_optimize_mps(jmps.copy(), JaxMpo(holstein_model))
    mpo = Mpo(model)
    e_port, opt = optimize_mps(tmps.copy(), mpo)

    assert min(e_jax) == pytest.approx(GS_E, rel=1e-5)
    assert min(e_port) == pytest.approx(GS_E, rel=1e-5)
    assert abs(min(e_port) - min(e_jax)) < 1e-8
    assert abs(opt.expectation(mpo) - min(e_port)) < 1e-8
    assert abs(opt.dot(opt) - 1) < 1e-12  # real state: <psi*|psi> = norm^2
    assert opt.check_left_canonical() or opt.check_right_canonical()


def test_dmrg_1site_regression():
    """The reference's ground-state regression E = 0.08401412 + zpe through
    the port's 1-site sweep (the edge sites take the dense local eigh)."""
    model = port_model()
    mps = Mps.random(model, 1, 10, percent=1.0)
    mps.optimize_config.procedure = PROCEDURE
    mps.optimize_config.method = "1site"
    mpo = Mpo(model)
    energies, opt = optimize_mps(mps, mpo)
    assert energies[-1] == pytest.approx(GS_E, rel=1e-5)
    assert opt.expectation(mpo) == pytest.approx(GS_E, rel=1e-5)
