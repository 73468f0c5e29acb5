"""The port's correction-vector (DDMRG) spectra, fp64 on the CPU.

``SpectraZtCV`` and ``SpectraFtCV`` (1-site and 2-site absorption,
emission) against the dense Lorentzian oracles and bounds of
``tests/test_apps.py`` (``test_cv_zerot``: 1e-3 relative,
``test_cv_finitet``/``test_cv_finitet_2site``: 1e-4); one site's CG solve
against the JAX package's on carried inputs (x and the functional 1e-8,
the same CG iterations); ``Mpo.finiteT_cv`` equal to the JAX package's
arrays; ``batch_run`` with two workers against the serial loop
(``tests/test_cv_batch.py``: 1e-4 relative, each worker starts its chunk
from the initial guess).  The emission case solves from the JAX package's
b = -eta mu rho(beta/2), carried over: the port's own 50 imaginary-time
P&C steps spend a minute in the CPU's plain Jacobi version, so that case is
``slow``."""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp
from fixtures import dense_hamiltonian
import renormalizer_tpu as rj
import renormalizer_tpu.cv.zerot as jzerot
import renormalizer_tpu.model as jm
from renormalizer_tpu.cv import SpectraFtCV as JaxSpectraFtCV
from renormalizer_tpu.cv import SpectraZtCV as JaxSpectraZtCV
from renormalizer_tpu.cv.finitet import CvMpDm as JaxCvMpDm
import renormalizer_tpu_torch as rt
import renormalizer_tpu_torch.cv.zerot as tzerot
import renormalizer_tpu_torch.model as tm
from renormalizer_tpu_torch import interop
from renormalizer_tpu_torch.cv import SpectraFtCV, SpectraZtCV
from renormalizer_tpu_torch.cv.finitet import CvMpDm
from renormalizer_tpu_torch.cv.spectra_cv import batch_run

torch.set_num_threads(2)

ETA = 0.05
PROCEDURE = [0.4, 0.2, 0.1, 0] + [0] * 10
TEMPERATURE = 0.5  # a.u.


def _dimer(pkg, m):
    ph = m.Phonon.simple_phonon(pkg.Quantity(1.0), pkg.Quantity(0.4), 2)
    return m.HolsteinModel([m.Mol(pkg.Quantity(1.0), [ph], 1.0)] * 2, pkg.Quantity(0.2))


JMODEL = _dimer(rj, jm)
H = dense_hamiltonian(JMODEL)


def _qn():
    dims = JMODEL.pbond_list
    return np.array([sum(JMODEL.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
                         for i in range(len(dims))) for s in range(H.shape[0])])


def _mu(op):
    return dense_hamiltonian(jm.Model(JMODEL.basis, [jm.Op(op, d, 1.0)
                                                     for d in JMODEL.e_dofs]))


def _zt_oracle(omega):
    qn = _qn()
    s0 = np.nonzero(qn == 0)[0]
    w0, v0 = np.linalg.eigh(H[np.ix_(s0, s0)])
    gs = np.zeros(H.shape[0])
    gs[s0] = v0[:, 0]
    ket = _mu(r"a^\dagger") @ gs
    a = H - (w0[0] + omega) * np.eye(H.shape[0]) + 1j * ETA * np.eye(H.shape[0])
    return -1 / np.pi * np.imag(ket @ np.linalg.solve(a, ket))


def _ft_oracle(omega, op, sector):
    beta = rt.Quantity(TEMPERATURE, "a.u.").to_beta()
    sidx = np.nonzero(_qn() == sector)[0]
    rho = np.zeros_like(H)
    rho[np.ix_(sidx, sidx)] = scipy.linalg.expm(-beta / 2 * H[np.ix_(sidx, sidx)])
    rho /= np.linalg.norm(rho)
    e, v = np.linalg.eigh(H)
    b = v.T @ (_mu(op) @ rho) @ v
    gaps = e[:, None] - e[None, :]
    return ETA / np.pi * np.sum(np.abs(b) ** 2 / ((omega - gaps) ** 2 + ETA ** 2))


def test_cv_zerot_against_dense():
    cv = SpectraZtCV(_dimer(rt, tm), "abs", m_max=16, eta=ETA, procedure_cv=PROCEDURE)
    for omega in (1.05, 1.5):
        res = cv.cv_solve(omega)
        assert abs(res - _zt_oracle(omega)) / abs(_zt_oracle(omega)) < 1e-3
        assert cv.solve_log[-1] == (omega, cv.solve_log[-1][1], True)


def test_cv_finitet_abs_1site_and_2site():
    kw = dict(m_max=16, eta=ETA, temperature=rt.Quantity(TEMPERATURE, "a.u."),
              procedure_cv=PROCEDURE)
    cv1 = SpectraFtCV(_dimer(rt, tm), "abs", method="1site", **kw)
    cv2 = SpectraFtCV(_dimer(rt, tm), "abs", method="2site", **kw)
    for omega in (1.05, 1.5):
        oracle = _ft_oracle(omega, r"a^\dagger", 0)
        res1, res2 = cv1.cv_solve(omega), cv2.cv_solve(omega)
        assert abs(res1 - oracle) / oracle < 1e-4
        assert abs(res2 - oracle) / oracle < 1e-4
        assert abs(res2 - res1) / res1 < 1e-4


def test_finiteT_cv_matches_jax():
    """One seed, one start: the same tensors and quantum numbers."""
    for spectratype in ("abs", "emi"):
        jx = JaxCvMpDm.finiteT_cv(JMODEL, 1, 16, spectratype, percent=1.0)
        tx = CvMpDm.finiteT_cv(_dimer(rt, tm), 1, 16, spectratype, percent=1.0)
        assert tx.bond_dims == jx.bond_dims and tx.qnidx == jx.qnidx
        np.testing.assert_array_equal(tx.qntot, jx.qntot)
        for a, b in zip(tx, jx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tx.qn, jx.qn):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def jax_zt():
    """The JAX package's zero-T job: its ground state, b and start."""
    return JaxSpectraZtCV(JMODEL, "abs", m_max=16, eta=ETA, procedure_cv=PROCEDURE)


def _carried_zt(jcv):
    model = _dimer(rt, tm)
    return SpectraZtCV(model, "abs", m_max=16, eta=ETA, procedure_cv=PROCEDURE,
                       b_mps=interop.mps_from_object(model, jcv.b_mps), e0=jcv.e0,
                       cv_mps=interop.mps_from_object(model, jcv.cv_mps))


def test_cv_site_solve_matches_jax(jax_zt, monkeypatch):
    """The first site of the first sweep: same x and functional, and the
    port's CG took exactly the iterations ``jax.scipy.sparse.linalg.cg``
    needs (one fewer leaves a different x)."""
    omega = 1.05
    tcv = _carried_zt(jax_zt)
    jcv = jax_zt.clone_for_batch()  # the fixture's start stays untouched
    seen = {}
    jorig = jzerot._cg_factory

    def jfactory(formula, cshape, eta, tol):
        solve = jorig(formula, cshape, eta, tol)

        def wrapped(*args):
            out = solve(*args)
            seen["jax"] = (formula, cshape, args, out)
            return out
        return wrapped

    orig = tzerot.cv_site_solve

    def tsolve(*args, **kwargs):
        seen["port"] = orig(*args, **kwargs)
        return seen["port"]

    monkeypatch.setattr(jzerot, "_cg_factory", jfactory)
    monkeypatch.setattr(tzerot, "cv_site_solve", tsolve)
    for cv in (jcv, tcv):
        cv.clear_res()
        cv.oper_prepare(omega)
    jl = jcv.optimize_cv(jcv.initialize_LR(), len(jcv.cv_mps), percent=0.4)
    tl = tcv.optimize_cv(tcv.initialize_LR(), len(tcv.cv_mps), percent=0.4)
    formula, cshape, (x0, b, a_diag, mask_idx, *operands), (jx, _) = seen["jax"]
    tx, tlv, niter = seen["port"]
    assert abs(float(tl) - float(jl)) < 1e-8
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-8)
    dim = int(np.prod(cshape))

    def matvec(x):
        full = jnp.zeros(dim, dtype=x.dtype).at[mask_idx].set(x)
        out = jnp.einsum(formula, *operands, full.reshape(cshape)).ravel()[mask_idx]
        return out + ETA ** 2 * x

    def jcg(maxiter):
        return np.asarray(jax.scipy.sparse.linalg.cg(
            matvec, b, x0=x0, tol=tzerot.CG_TOL, M=lambda v: v / a_diag,
            maxiter=maxiter)[0])

    assert 0 < niter < tzerot.CG_MAXITER
    np.testing.assert_allclose(jcg(niter), np.asarray(jx), rtol=0, atol=1e-12)
    assert np.abs(jcg(niter - 1) - np.asarray(jx)).max() > 1e-10


def test_cv_zerot_from_the_jax_state_matches_jax(jax_zt):
    """Whole frequency points from the JAX package's b, e0 and start."""
    tcv = _carried_zt(jax_zt)
    for omega in (1.05, 1.5):
        res, jres = tcv.cv_solve(omega), jax_zt.cv_solve(omega)
        assert abs(res - jres) / abs(jres) < 1e-6
        assert abs(res - _zt_oracle(omega)) / abs(_zt_oracle(omega)) < 1e-3


def test_batch_run_two_workers_match_serial():
    freqs = [1.0, 1.05, 1.45, 1.5]
    model = _dimer(rt, tm)
    serial_cv = SpectraZtCV(model, "abs", m_max=16, eta=ETA, procedure_cv=PROCEDURE)
    serial = [serial_cv.cv_solve(w) for w in freqs]
    batch_cv = SpectraZtCV(model, "abs", m_max=16, eta=ETA, procedure_cv=PROCEDURE)
    np.testing.assert_allclose(batch_run(freqs, 2, batch_cv), serial, rtol=1e-4)
    one_cv = SpectraZtCV(model, "abs", m_max=16, eta=ETA, procedure_cv=PROCEDURE)
    np.testing.assert_allclose(batch_run(freqs[:2], 1, one_cv), serial[:2], rtol=1e-12)


def test_cv_finitet_emission_from_the_jax_b():
    jcv = JaxSpectraFtCV(JMODEL, "emi", m_max=16, eta=ETA,
                         temperature=rj.Quantity(TEMPERATURE, "a.u."), insteps=50,
                         procedure_cv=PROCEDURE)
    model = _dimer(rt, tm)
    cv = SpectraFtCV(model, "emi", m_max=16, eta=ETA,
                     temperature=rt.Quantity(TEMPERATURE, "a.u."), insteps=50,
                     procedure_cv=PROCEDURE,
                     b_mps=interop.mpdm_from_object(model, jcv.b_mpo))
    for omega in (-1.05, -1.5):
        oracle = _ft_oracle(omega, "a", 1)
        assert abs(cv.cv_solve(omega) - oracle) / oracle < 1e-4


@pytest.mark.slow
def test_cv_finitet_emission_against_dense():
    """The port's own b: 50 P&C imaginary-time steps (``test_cv_finitet``)."""
    cv = SpectraFtCV(_dimer(rt, tm), "emi", m_max=16, eta=ETA,
                     temperature=rt.Quantity(TEMPERATURE, "a.u."), insteps=50,
                     procedure_cv=PROCEDURE)
    for omega in (-1.05, -1.5):
        oracle = _ft_oracle(omega, "a", 1)
        assert abs(cv.cv_solve(omega) - oracle) / oracle < 1e-4
