"""The port's one-site TDVP-PS against a dense oracle and against the JAX
package, fp64 on the CPU.

Protocol of ``tests/test_evolve.py`` on the 3-molecule, 2-level Holstein
model: initial state a^dagger_0 |gs> expanded with the Hamiltonian as hint,
Hamiltonian MPO offset by the initial energy, time step 0.2 to t = 2.  The
initial state is built once in the JAX package and carried over, so both
packages evolve the same tensors."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import dense_hamiltonian, exact_model
import renormalizer_tpu as rj
from renormalizer_tpu.model import Model as JaxModel
from renormalizer_tpu_torch import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    HolsteinModel,
    Mol,
    Mpo,
    Phonon,
    Quantity,
    interop,
)
from renormalizer_tpu_torch.lib import solvers
from renormalizer_tpu_torch.mps import mps as port_mps

torch.set_num_threads(2)

DT, NSTEPS = 0.2, 10

jmodel = exact_model()
H_DENSE = dense_hamiltonian(jmodel)
OCC_DENSE = [
    dense_hamiltonian(JaxModel(jmodel.basis, [rj.Op(r"a^\dagger a", dof)]))
    for dof in jmodel.e_dofs
]


def port_exact_model() -> HolsteinModel:
    """``tests/fixtures.py``'s ``exact_model`` in the port."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


def _jax_init():
    tentative_mpo = rj.Mpo(jmodel)
    init = rj.Mpo.onsite(jmodel, r"a^\dagger", dof_set=[0]) @ rj.Mps.ground_state(jmodel, False)
    init = init.expand_bond_dimension(hint_mpo=tentative_mpo)
    e0 = init.expectation(tentative_mpo)
    init.evolve_config = rj.EvolveConfig(rj.EvolveMethod.tdvp_ps)
    return init, rj.Mpo(jmodel, offset=rj.Quantity(e0)), e0


JAX_INIT, JAX_MPO, E0 = _jax_init()
MODEL = port_exact_model()
MPO = Mpo(MODEL, offset=Quantity(E0))


def port_init():
    return interop.mps_from_object(MODEL, JAX_INIT)


def _oracle():
    psi0 = JAX_INIT.todense().astype(complex)
    h = H_DENSE - E0 * np.eye(H_DENSE.shape[0])
    res = []
    for i in range(1, NSTEPS + 1):
        psit = scipy.linalg.expm(-1j * h * DT * i) @ psi0
        res.append([np.real(psit.conj() @ o @ psit) for o in OCC_DENSE])
    return np.array(res)


def _overlap(a, b):
    """|<a|b>| / (|a| |b|) of two dense vectors."""
    return abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))


def _same_qn_multisets(qn_a, qn_b):
    # the order of a bond's states is gauge
    for q1, q2 in zip(qn_a, qn_b):
        assert np.array_equal(np.sort(np.asarray(q1), axis=0),
                              np.sort(np.asarray(q2), axis=0)), (q1, q2)


def test_carried_state_is_identical():
    mps = port_init()
    assert mps.bond_dims == JAX_INIT.bond_dims
    assert mps.evolve_config.method is EvolveMethod.tdvp_ps
    np.testing.assert_allclose(mps.todense(), JAX_INIT.todense(), atol=1e-15)
    np.testing.assert_allclose(MPO.todense(), JAX_MPO.todense(), atol=1e-12)
    assert mps.expectation(MPO) == pytest.approx(0.0, abs=1e-12)


def test_tdvp_ps_dense_oracle():
    """Mean cumulative deviation of the occupations from the dense expm
    below 1e-4, norm and energy conserved, and both branches taken."""
    oracle = _oracle()
    mps = port_init()
    before = dict(port_mps.TDVP_PS_VISITS)
    deviations = []
    for i in range(NSTEPS):
        mps = mps.evolve(MPO, DT)
        assert mps.is_complex
        deviations.append(np.abs(mps.e_occupations - oracle[i]).mean())
        assert mps.mp_norm == pytest.approx(1.0, abs=1e-12)
        assert abs(mps.expectation(MPO)) < 1e-10
    assert float(np.mean(deviations)) < 1e-4
    nsite = len(mps)
    assert port_mps.TDVP_PS_VISITS["fused"] - before["fused"] == NSTEPS * 2 * (nsite - 1)
    assert port_mps.TDVP_PS_VISITS["unfused"] - before["unfused"] == NSTEPS * 2


@pytest.mark.parametrize("jax_fused", [True, False], ids=["jax-fused", "jax-unfused"])
def test_tdvp_ps_matches_jax_stepwise(monkeypatch, jax_fused):
    """Same initial tensors, same steps: occupations to 1e-9, overlap within
    1e-9 of 1, bond quantum numbers equal as multisets.  The JAX package
    takes its fused visit with device linear algebra on and its host-QR
    visit without it."""
    monkeypatch.setenv("RENO_DEVICE_TRUNC", "1" if jax_fused else "0")
    jmps, tmps = JAX_INIT.copy(), port_init()
    for _ in range(NSTEPS):
        jmps = jmps.evolve(JAX_MPO, DT)
        tmps = tmps.evolve(MPO, DT)
        np.testing.assert_allclose(tmps.e_occupations, jmps.e_occupations,
                                   atol=1e-9, rtol=0)
        assert abs(_overlap(jmps.todense(), tmps.todense()) - 1) < 1e-9
        assert tmps.bond_dims == jmps.bond_dims
        assert tmps.qnidx == jmps.qnidx and tmps.to_right == jmps.to_right
        _same_qn_multisets(tmps.qn, jmps.qn)


def test_tdvp_ps_fused_against_unfused(monkeypatch):
    """Inside the port: the fused site visit against the unfused one
    (expm -> qn-blocked QR -> environment -> bond expm), reached when the
    fused visit declines."""
    fused = port_init()
    for _ in range(NSTEPS):
        fused = fused.evolve(MPO, DT)

    before = dict(port_mps.TDVP_PS_VISITS)
    monkeypatch.setattr(solvers, "tdvp_ps_site_fused", lambda *a, **k: None)
    unfused = port_init()
    for _ in range(NSTEPS):
        unfused = unfused.evolve(MPO, DT)
    assert port_mps.TDVP_PS_VISITS["fused"] == before["fused"]
    assert (port_mps.TDVP_PS_VISITS["unfused"] - before["unfused"]
            == NSTEPS * 2 * len(unfused))

    ovlp = abs(fused.conj().dot(unfused)) / (fused.mp_norm * unfused.mp_norm)
    assert abs(ovlp - 1) < 1e-9
    np.testing.assert_allclose(fused.e_occupations, unfused.e_occupations,
                               atol=1e-9, rtol=0)
    _same_qn_multisets(fused.qn, unfused.qn)


def test_tdvp_ps_adaptive():
    """Step doubling with the p-controller reaches the oracle too."""
    oracle = _oracle()
    mps = port_init()
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps, adaptive=True,
                                     guess_dt=0.1)
    mps = mps.evolve(MPO, 1.0)
    assert np.abs(mps.e_occupations - oracle[4]).mean() < 1e-4
    assert mps.evolve_config.guess_dt > 0


def test_imaginary_time_stays_real_and_cools():
    """``evolve_dt = -0.05j`` propagates exp(-0.05 H): a real state stays
    real and its energy falls."""
    mps = port_init()
    assert not mps.is_complex
    energies = [mps.expectation(MPO)]
    for _ in range(5):
        mps = mps.evolve(MPO, -0.05j)
        assert not mps.is_complex
        assert all(not mt.is_complex() for mt in mps)
        energies.append(mps.expectation(MPO))
    assert all(e1 < e0 for e0, e1 in zip(energies, energies[1:]))
    assert mps.mp_norm == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("method", [m for m in EvolveMethod
                                    if m is not EvolveMethod.tdvp_ps],
                         ids=lambda m: m.name)
def test_unported_methods_raise(method):
    """Every method but TDVP-PS (the name is kept from when the port raised
    on them): each evolves one step of the small model from its default
    config to a finite state of norm 1 within 1e-8 (``tests/test_torch_pc.py``
    and ``tests/test_torch_vmf.py`` hold them against dense oracles and the
    JAX package)."""
    mps = port_init()
    mps.evolve_config = EvolveConfig(method)
    if method.value.startswith("P&C"):
        mps.compress_config = CompressConfig(CompressCriteria.fixed)
    out = mps.evolve(MPO, DT)
    assert out.is_complex
    assert all(torch.isfinite(mt).all() for mt in out)
    assert out.mp_norm == pytest.approx(1.0, abs=1e-8)