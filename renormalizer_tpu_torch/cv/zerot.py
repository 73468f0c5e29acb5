r"""Zero-temperature DDMRG absorption/emission spectra.

Port of ``renormalizer_tpu/cv/zerot.py`` (reference
``renormalizer/cv/zerot.py:25-417``).  Per frequency omega the correction
vector solves

    ((H - e0 - omega)^2 + eta^2) |x> = -eta mu |psi_0>

by a site-local conjugate gradient (:func:`lib.solvers.cg`) over the
two-layer effective operator (``ops.contract.hop_spec(twolayer=True)``),
with the diagonal of that operator as its preconditioner.  The JAX package
runs ``jax.scipy.sparse.linalg.cg`` inside one jitted call; the port's CG is
a torch loop with one host read per residual check and the same stopping
rule, so both take the same iterations.
"""

import logging

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.cv.spectra_cv import SpectraCv
from renormalizer_tpu_torch.lib.solvers import cg
from renormalizer_tpu_torch.mps import Mpo, Mps, gs
from renormalizer_tpu_torch.mps.lib import cvec2cmat
from renormalizer_tpu_torch.mps.svd_qn import get_qn_mask
from renormalizer_tpu_torch.ops.contract import einsum, hop_diag, hop_spec
from renormalizer_tpu_torch.utils import OptimizeConfig

logger = logging.getLogger(__name__)

# CG settings of the JAX package's ``_cg_factory`` (``cv/zerot.py:31``)
CG_TOL = 1e-5
CG_MAXITER = 100


def _masked_operator(formula, operands, cshape, mask_idx, eta):
    """x (masked) -> (A^2 + eta^2) x, through the full local space."""
    dim = int(np.prod(cshape))

    def matvec(x):
        full = torch.zeros(dim, dtype=x.dtype, device=x.device)
        full[mask_idx] = x
        out = einsum(formula, *operands, full.reshape(cshape)).reshape(-1)[mask_idx]
        return out + eta ** 2 * x

    return matvec


def wide(*tensors):
    """``tensors`` in double precision.  The CG solves ((H - e0 - w)^2 +
    eta^2) x = b, whose condition number is that of H - e0 - w squared over
    eta^2, so the sweep's environments and its CG run in double precision
    whatever the working one, as MU-VMF integrates; the site tensors stay
    in the working precision.  With everything in fp32 (CPU),
    ``tests/test_apps.py``'s dimer came 9.1e-5 (emission, of a 1e-4 bound),
    5.1e-5 (2-site absorption), 3.8e-5 (zero T) off the dense oracle, and
    with the CG alone in double precision 4.0e-5, 1.2e-5, 3.0e-5; on the
    bench chain at M=64 (NVIDIA H100) fp32 environments scattered the
    per-site responses of one sweep by ~1e-3, and the 2.70 eV point did not
    converge to rtol 1e-5 in 8 sweeps."""
    return [t.to(torch.complex128 if t.is_complex() else torch.float64)
            for t in tensors]


def cv_site_solve(formula, operands, cshape, mask_idx, eta, guess, b, a_diag,
                  tol=CG_TOL, maxiter=CG_MAXITER):
    """One site's CG solve, in double precision (:func:`wide`), and its
    functional ``x.A x - 2 b.x`` (a 0-d device tensor).  Returns ``(x,
    l_value, iterations)`` with ``x`` in the working precision."""
    matvec = _masked_operator(formula, wide(*operands), cshape, mask_idx, eta)
    guess_w, b_w, a_diag_w = wide(guess, b, a_diag)
    x, niter = cg(matvec, b_w, guess_w, tol=tol, precond=lambda v: v / a_diag_w,
                  maxiter=maxiter)
    l_value = torch.dot(x, matvec(x)) - 2 * torch.dot(b_w, x)
    return x.to(guess.dtype), l_value, niter


class SpectraZtCV(SpectraCv):
    r"""Zero-T DDMRG spectrum (see :class:`SpectraCv` for arguments;
    ``procedure_gs`` controls the ground-state DMRG)."""

    def __init__(self, model, spectratype, m_max, eta, h_mpo=None,
                 method="1site", procedure_cv=None, rtol=1e-5, b_mps=None,
                 e0=None, cv_mps=None, procedure_gs=None):
        self.procedure_gs = procedure_gs
        self.a_oper = None
        super().__init__(
            model, spectratype, m_max, eta, h_mpo=h_mpo, method=method,
            procedure_cv=procedure_cv, rtol=rtol, b_mps=b_mps, e0=e0,
            cv_mps=cv_mps)

    def init_b_mps(self):
        """b = -eta * mu * |psi_0> via ground-state DMRG
        (reference ``cv/zerot.py:80-112``)."""
        if self.spectratype == "abs":
            nexciton, dipoletype = 0, r"a^\dagger"
        else:
            nexciton, dipoletype = 1, "a"
        if self.procedure_gs is None:
            self.procedure_gs = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]
        mps = Mps.random(self.model, nexciton, self.procedure_gs[0][0], percent=1.0)
        mps.optimize_config = OptimizeConfig(procedure=self.procedure_gs)
        mps.optimize_config.method = "2site"
        energies, mps = gs.optimize_mps(mps, self.h_mpo)
        e0 = min(energies)
        dipole_mpo = Mpo.onsite(self.model, dipoletype, dipole=True)
        b_mps = dipole_mpo.apply(mps.scale(-self.eta))
        return b_mps, e0

    def init_cv_mps(self):
        assert self.b_mps is not None
        cv_mps = Mps.random(self.model, self.b_mps.qntot, self.m_max, percent=1.0)
        logger.info(f"cv_mps random guess qntot: {cv_mps.qntot}")
        return cv_mps

    def oper_prepare(self, omega):
        identity = Mpo.identity(self.model).scale(-self.e0 - omega)
        self.a_oper = self.h_mpo.add(identity)

    def optimize_cv(self, lr_group, isite, percent=0.0):
        first_LR, second_LR = lr_group
        if self.method == "1site":
            cidx = [isite - 1]
            first_L, first_R = first_LR[isite - 1], first_LR[isite]
            second_L, second_R = second_LR[isite - 1], second_LR[isite]
        else:
            cidx = [isite - 2, isite - 1]
            first_L, first_R = first_LR[isite - 2], first_LR[isite]
            second_L, second_R = second_LR[isite - 2], second_LR[isite]

        qnbigl, qnbigr, qnmat = self.cv_mps._get_big_qn(cidx)
        qn_mask = get_qn_mask(qnmat, self.cv_mps.qntot)
        xshape = qn_mask.shape
        mask_idx = torch.as_tensor(np.nonzero(qn_mask.ravel())[0],
                                   device=backend.device)

        cmo = [self.a_oper[i] for i in cidx]
        if self.method == "1site":
            guess = self.cv_mps[isite - 1].reshape(-1)[mask_idx]
            vec_b = einsum("ab,acd,de->bce", second_L, self.b_mps[isite - 1],
                           second_R).reshape(-1)[mask_idx]
        else:
            guess = torch.tensordot(self.cv_mps[isite - 2], self.cv_mps[isite - 1],
                                    dims=1).reshape(-1)[mask_idx]
            vec_b = einsum("ab,acd,def,fg->bceg", second_L, self.b_mps[isite - 2],
                           self.b_mps[isite - 1], second_R).reshape(-1)[mask_idx]

        # diagonal preconditioner of the squared operator
        a_diag = hop_diag(first_L, first_R, cmo, twolayer=True).reshape(-1)[mask_idx] \
            + self.eta ** 2
        formula, operands = hop_spec(first_L, first_R, cmo, xshape, twolayer=True)
        x, l_value, _ = cv_site_solve(formula, operands, tuple(xshape), mask_idx,
                                      float(self.eta), guess, vec_b, a_diag)
        xstruct = cvec2cmat(x, qn_mask)
        self.cv_mps._update_mps(xstruct, cidx, qnbigl, qnbigr, percent)
        return l_value

    # LR environments: first for the squared operator (4-leg), second for the
    # <b|x> overlap (2-leg).  Index i covers sites [0, i) from the left /
    # [i, N) from the right (reference ``cv/zerot.py:307-417``).
    def _first_up(self, env, isite, domain):
        ms = self.cv_mps[isite]
        a = self.a_oper[isite]
        if domain == "L":
            return einsum("abcd,aef,begh,cgij,dik->fhjk", env, ms, a, a, ms)
        return einsum("abcd,efa,gfhb,ihjc,kjd->egik", env, ms, a, a, ms)

    def _second_up(self, env, isite, domain):
        bms = self.b_mps[isite]
        ms = self.cv_mps[isite]
        if domain == "L":
            return einsum("ab,acd,bce->de", env, bms, ms)
        return einsum("ab,cda,edb->ce", env, bms, ms)

    @staticmethod
    def _ones(ndim):
        # the environments in double precision (see ``wide``): every update
        # promotes to the boundary's dtype
        return torch.ones((1,) * ndim, dtype=torch.float64, device=backend.device)

    def initialize_LR(self):
        n = len(self.cv_mps)
        first_LR = [None] * (n + 1)
        second_LR = [None] * (n + 1)
        first_LR[0] = first_LR[n] = self._ones(4)
        second_LR[0] = second_LR[n] = self._ones(2)
        if self.cv_mps.to_right:
            for isite in range(n, 1, -1):
                first_LR[isite - 1] = self._first_up(first_LR[isite], isite - 1, "R")
                second_LR[isite - 1] = self._second_up(second_LR[isite], isite - 1, "R")
        else:
            for isite in range(1, n):
                first_LR[isite] = self._first_up(first_LR[isite - 1], isite - 1, "L")
                second_LR[isite] = self._second_up(second_LR[isite - 1], isite - 1, "L")
        return [first_LR, second_LR]

    def update_LR(self, lr_group, isite):
        first_LR, second_LR = lr_group
        if not self.cv_mps.to_right:
            first_LR[isite - 1] = self._first_up(first_LR[isite], isite - 1, "R")
            second_LR[isite - 1] = self._second_up(second_LR[isite], isite - 1, "R")
        elif self.method == "1site":
            first_LR[isite] = self._first_up(first_LR[isite - 1], isite - 1, "L")
            second_LR[isite] = self._second_up(second_LR[isite - 1], isite - 1, "L")
        else:
            first_LR[isite - 1] = self._first_up(first_LR[isite - 2], isite - 2, "L")
            second_LR[isite - 1] = self._second_up(second_LR[isite - 2], isite - 2, "L")
        return [first_LR, second_LR]
