"""The port's excited-state slice, fp64 on the CPU: state-averaged and
omega-targeted DMRG, the ``arpack``/``lobpcg``/``primme``/``direct``
eigensolvers, TDA, VSCF and vibronic dynamics.

Held against the dense oracles and bounds of ``tests/test_mps.py``
(``test_dmrg_nroots``, ``test_optimize_omega``, ``test_optimize_arpack``,
``test_dmrg_lobpcg``, ``test_dmrg_primme_string``) and
``tests/test_apps.py`` (``test_tda``, ``test_vscf``,
``test_vibronic_dynamics``), and TDA against the JAX package's TDA from
the JAX package's ground state, carried over (energies 1e-5 relative, the
host Davidson's stopping rule)."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import GS_E, dense_hamiltonian, exact_model
import renormalizer_tpu as rj
from renormalizer_tpu.mps import TDA as JaxTDA
from renormalizer_tpu.mps.gs import construct_mps_mpo as jax_construct
from renormalizer_tpu.mps.gs import optimize_mps as jax_optimize_mps
from renormalizer_tpu_torch import (HolsteinModel, Model, Mol, Op, OptimizeConfig,
                                    Phonon, Quantity, interop)
from renormalizer_tpu_torch.model import BasisHalfSpin, BasisSHO
from renormalizer_tpu_torch.mps import TDA, Mpo, Mps
from renormalizer_tpu_torch.mps.gs import construct_mps_mpo, optimize_mps
from renormalizer_tpu_torch.vibration import Vscf
from renormalizer_tpu_torch.vibronic import VibronicModelDynamics
from test_torch_dmrg import port_model

torch.set_num_threads(2)

JMODEL = exact_model()
H_DENSE = dense_hamiltonian(JMODEL)


def port_exact_model() -> HolsteinModel:
    """``tests/fixtures.py``'s ``exact_model`` in the port."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


def _sector_spectrum(n=1):
    dims = JMODEL.pbond_list
    qn = np.array([sum(JMODEL.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
                       for i in range(len(dims))) for s in range(H_DENSE.shape[0])])
    sector = np.nonzero(qn == n)[0]
    return np.linalg.eigvalsh(H_DENSE[np.ix_(sector, sector)])


W1 = _sector_spectrum(1)


@pytest.mark.parametrize("algo", ["davidson", "direct"])
def test_dmrg_nroots(algo):
    """State-averaged DMRG for the 2 lowest states (``test_dmrg_nroots``:
    1e-6 of the dense sector spectrum); every root's MPS holds its energy."""
    model = port_exact_model()
    mps, mpo = construct_mps_mpo(model, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0], [16, 0]]
    mps.optimize_config.nroots = 2
    mps.optimize_config.algo = algo
    energies, mps_list = optimize_mps(mps.copy(), mpo)
    assert np.allclose(sorted(energies[-1]), W1[:2], rtol=0, atol=1e-6)
    assert len(mps_list) == 2
    for res, e in zip(mps_list, W1[:2]):
        assert abs(res.expectation(mpo) - e) < 1e-5


def test_optimize_omega():
    """(H - omega)^2 targets the interior eigenstate nearest omega
    (``test_optimize_omega``: 1e-8)."""
    model = port_exact_model()
    mps = Mps.random(model, 1, 24)
    mps.optimize_config = OptimizeConfig(
        procedure=[[24, 0.4], [24, 0.2], [24, 0.1], [24, 0], [24, 0], [24, 0]])
    _, opt = optimize_mps(mps, Mpo(model), omega=W1[1] + 0.02)
    assert abs(opt.expectation(Mpo(model)) - W1[1]) < 1e-8


def test_optimize_arpack():
    """scipy's ARPACK over the device matvec (``test_optimize_arpack``:
    1e-7 of the regression value, which is the dense ground state)."""
    model = port_exact_model()
    mps = Mps.random(model, 1, 16)
    mps.optimize_config = OptimizeConfig(procedure=[[16, 0.4], [16, 0.2], [16, 0], [16, 0]])
    mps.optimize_config.algo = "arpack"
    energies, _ = optimize_mps(mps, Mpo(model))
    assert abs(min(energies) - 0.3361574408) < 1e-7


@pytest.mark.parametrize("algo", ["lobpcg", "primme"])
def test_dmrg_lobpcg(algo):
    """LOBPCG on sigma - H, also for ``algo="primme"`` as in the JAX package
    (``test_dmrg_lobpcg``/``test_dmrg_primme_string``: 1e-5 of GS_E)."""
    model = port_model()
    mps = Mps.random(model, 1, 10, percent=1.0)
    mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]
    mps.optimize_config.algo = algo
    energies, _ = optimize_mps(mps.copy(), Mpo(model))
    assert min(energies) == pytest.approx(GS_E, rel=1e-5)


@pytest.fixture(scope="module")
def jax_tda():
    """The JAX package's ground state and its TDA roots (``test_tda``)."""
    mps, mpo = jax_construct(JMODEL, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0]]
    _, mps_opt = jax_optimize_mps(mps.copy(), mpo)
    carried = interop.mps_from_object(port_exact_model(), mps_opt)
    return carried, JaxTDA(JMODEL, mpo, mps_opt, nroots=3).kernel()


def test_tda_matches_jax_and_dense(jax_tda):
    carried, e_jax = jax_tda
    model = carried.model
    tda = TDA(model, Mpo(model), carried, nroots=3)
    e = tda.kernel()
    # the host Davidson of both stops once the ritz values move by less than
    # np.allclose's default rtol 1e-5, and the two canonicalisations give
    # the tangent space different bases, so the iterates differ at that level
    np.testing.assert_allclose(e, e_jax, rtol=1e-5, atol=0)
    # test_tda's bound on the two lowest excitations
    assert np.allclose(e[:2], W1[1:3], rtol=0, atol=2e-3)
    tda.analysis_1ordm()
    # a restart from the converged coefficients stays there
    np.testing.assert_allclose(tda.kernel(restart=True), e, rtol=1e-5, atol=0)


def test_tda_from_the_port_ground_state():
    model = port_exact_model()
    mps, mpo = construct_mps_mpo(model, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0]]
    _, mps_opt = optimize_mps(mps.copy(), mpo)
    e = TDA(model, mpo, mps_opt, nroots=3).kernel()
    assert np.allclose(e[:2], W1[1:3], rtol=0, atol=2e-3)


def test_vscf():
    """Decoupled oscillators: exact modal gaps (``test_vscf``: 1e-6)."""
    basis = [BasisSHO("v0", 1.0, 8), BasisSHO("v1", 0.5, 8)]
    terms = (Op("p^2", "v0", 0.5) + Op("x^2", "v0", 0.5)
             + Op("p^2", "v1", 0.5) + Op("x^2", "v1", 0.5 * 0.25))
    scf = Vscf(Model(basis, terms))
    scf.kernel(nsweeps=5)
    assert np.allclose(np.diff(scf.e[0][:4]), 1.0, rtol=0, atol=1e-6)
    assert np.allclose(np.diff(scf.e[1][:4]), 0.5, rtol=0, atol=1e-6)
    assert scf.c[0].shape == (8, 8)


def test_vibronic_dynamics():
    """2-state 1-mode vibronic model, autocorrelation at 2t against the
    dense propagator (``test_vibronic_dynamics``: 1e-3)."""
    terms = (Op("sigma_z", "e", 0.5) + Op("p^2", "v", 0.5) + Op("x^2", "v", 0.5)
             + Op("sigma_x", "e") * Op("x", "v") * 0.2)
    model = Model([BasisHalfSpin("e"), BasisSHO("v", 1.0, 4)], terms)
    job = VibronicModelDynamics(model, init_condition={"e": 0, "v": 0})
    job.evolve(0.2, 4)
    jm = rj.Model([rj.BasisHalfSpin("e"), rj.BasisSHO("v", 1.0, 4)],
                  rj.Op("sigma_z", "e", 0.5) + rj.Op("p^2", "v", 0.5)
                  + rj.Op("x^2", "v", 0.5) + rj.Op("sigma_x", "e") * rj.Op("x", "v") * 0.2)
    h = dense_hamiltonian(jm)
    psi0 = np.zeros(h.shape[0])
    psi0[0] = 1
    assert len(job.autocorr_time) == 9
    for t, ac in zip(job.autocorr_time, job.autocorr_array):
        assert np.isclose(psi0 @ scipy.linalg.expm(-1j * h * t) @ psi0, ac, atol=1e-3)
    assert len(job.edof_rdm) == 5 and set(job.get_dump_dict()) >= {"energy", "edof_rdm"}
