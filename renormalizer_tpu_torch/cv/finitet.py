r"""Finite-temperature DDMRG absorption/emission spectra.

Port of ``renormalizer_tpu/cv/finitet.py`` (reference
``renormalizer/cv/finitet.py:30-716``).  The correction vector is a
density-operator-like matrix product (4-leg site tensors) solving, in
Liouville space,

    [ (omega - L)^2 + eta^2 ] |X> = -eta mu rho(beta/2),    L X = H X - X H

With A = omega I - H on the up (ket) leg and H on the down leg (they
commute) the operator is A_up^2 + 2 A_up H_down + H_down^2 + eta^2, three
einsum terms with one environment each.  The per-site solve is the port's CG
(:func:`lib.solvers.cg`, the stopping rule of ``jax.scipy.sparse.linalg.cg``,
500 iterations at most) with the diagonal of the three terms as its
preconditioner.  Quantum numbers are (bra, ket) pairs, so the sector
X = |1><0| (abs) / |0><1| (emi) reuses the generic qn machinery.  The 2-site
method runs, as in the JAX package (the reference leaves it unrunnable).
"""

import itertools
import logging
import os

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.cv.spectra_cv import SpectraCv
from renormalizer_tpu_torch.cv.zerot import wide
from renormalizer_tpu_torch.lib.solvers import cg
from renormalizer_tpu_torch.mps import MpDm, Mpo, ThermalProp, load_thermal_state
from renormalizer_tpu_torch.mps.lib import cvec2cmat
from renormalizer_tpu_torch.mps.svd_qn import get_qn_mask
from renormalizer_tpu_torch.ops.contract import einsum
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria, EvolveConfig

logger = logging.getLogger(__name__)

# local operator, X in the middle
_F1 = "pijq,iumk,jmnl,qndt,sklt->puds"  # A_up^2 X
_F2 = "pijq,iumk,qmnt,jndl,sklt->puds"  # A_up X H_down
_F3 = "pijq,qumt,imnk,jndl,sklt->puds"  # X H_down^2
# 2-site: the active block X carries (left, up1, down1, up2, down2, right)
_F1_2 = "pijq,iabk,kceK,jbfl,legL,qfdght,sKLt->padchs"  # A_up^2 X
_F2_2 = "pijq,iabk,kceK,qbfegt,jfdl,lghL,sKLt->padchs"  # A_up X H_down
_F3_2 = "pijq,qabcet,ibfk,kegK,jfdl,lghL,sKLt->padchs"  # X H_down^2
# environment updates (conj(X), ops, X) from the left and the right
_E_L = ("pijq,pudw,iumx,jmny,qndz->wxyz",
        "pijq,pudw,iumx,qmnz,jndy->wxyz",
        "pijq,pudw,qumz,imnx,jndy->wxyz",
        "pq,pudw,qudz->wz")
_E_R = ("wxyz,pudw,iumx,jmny,qndz->pijq",
        "wxyz,pudw,iumx,qmnz,jndy->pijq",
        "wxyz,pudw,qumz,imnx,jndy->pijq",
        "wz,pudw,qudz->pq")

# CG settings of the JAX package's ``_ft_cg_factory`` (``cv/finitet.py:72``)
CG_TOL = 1e-5
CG_MAXITER = 500


class CvMpDm(MpDm):
    """Correction-vector matrix product operator with 2-component
    (bra, ket) quantum numbers per bond."""

    def _get_sigmaqn(self, idx):
        qn = np.asarray(self.model.basis[idx].sigmaqn).ravel()
        pairs = np.array(list(itertools.product(qn, repeat=2)), dtype=int)
        return pairs.reshape(len(qn), len(qn), 2)


def ft_matvec(cshape, mask_idx, eta, envs, site_ops):
    """x (masked) -> ((omega - L)^2 + eta^2) x; ``envs`` = (l1, r1, l2, r2,
    l3, r3), ``site_ops`` = (a, h) or (a1, a2, h1, h2)."""
    dim = int(np.prod(cshape))
    l1, r1, l2, r2, l3, r3 = envs

    def matvec(x):
        full = torch.zeros(dim, dtype=x.dtype, device=x.device)
        full[mask_idx] = x
        full = full.reshape(cshape)
        if len(site_ops) == 2:
            a, h = site_ops
            m1 = einsum(_F1, l1, a, a, full, r1)
            m2 = einsum(_F2, l2, a, full, h, r2)
            m3 = einsum(_F3, l3, full, h, h, r3)
        else:
            a1, a2, h1, h2 = site_ops
            m1 = einsum(_F1_2, l1, a1, a2, a1, a2, full, r1)
            m2 = einsum(_F2_2, l2, a1, a2, full, h1, h2, r2)
            m3 = einsum(_F3_2, l3, full, h1, h2, h1, h2, r3)
        out = (m1 + 2.0 * m2 + m3).reshape(-1)[mask_idx]
        return out + eta ** 2 * x

    return matvec


class SpectraFtCV(SpectraCv):
    r"""Finite-temperature DDMRG spectrum.

    Args beyond :class:`SpectraCv`: ``temperature`` (Quantity), ``insteps``
    (imaginary-time steps, required for emission), ``ievolve_config``/
    ``icompress_config`` for the thermal propagation, ``dump_dir``/
    ``job_name`` to checkpoint / reuse the thermal state
    (reference ``renormalizer/cv/finitet.py:30-153``).
    """

    def __init__(self, model, spectratype, m_max, eta, temperature, h_mpo=None,
                 method="1site", procedure_cv=None, rtol=1e-5, b_mps=None,
                 cv_mps=None, icompress_config=None, ievolve_config=None,
                 insteps=None, dump_dir: str = None, job_name=None):
        self.temperature = temperature
        self.evolve_config = ievolve_config or EvolveConfig()
        self.compress_config = icompress_config
        if self.compress_config is None:
            self.compress_config = CompressConfig(CompressCriteria.fixed,
                                                  max_bonddim=m_max)
            self.compress_config.set_bonddim(len(model.pbond_list))
        self.insteps = insteps
        self.job_name = job_name
        self.dump_dir = dump_dir
        super().__init__(
            model, spectratype, m_max, eta, h_mpo=h_mpo, method=method,
            procedure_cv=procedure_cv, rtol=rtol, b_mps=b_mps, cv_mps=cv_mps)
        self.cv_mpo = self.cv_mps
        self.b_mpo = self.b_mps
        self.a_oper = None

    # --- initial states -----------------------------------------------------
    def init_cv_mps(self):
        return CvMpDm.finiteT_cv(self.model, 1, self.m_max, self.spectratype,
                                 percent=1.0)

    def init_b_mps(self):
        """b = -eta * mu * rho(beta/2) (reference ``cv/finitet.py:113-148``)."""
        beta = self.temperature.to_beta()
        if self.spectratype == "abs":
            dipole_mpo = Mpo.onsite(self.model, r"a^\dagger", dipole=True)
            tp = ThermalProp(MpDm.max_entangled_gs(self.model), exact=True,
                             space="GS")
            tp.evolve(None, 1, beta / 2j)
            ket_mpo = tp.latest_mps
        else:
            dipole_mpo = Mpo.onsite(self.model, "a", dipole=True)
            ket_mpo = None
            if self._defined_output_path:
                ket_mpo = load_thermal_state(self.model, self._thermal_dump_path)
            if ket_mpo is None:
                impo = MpDm.max_entangled_ex(self.model)
                impo.compress_config = self.compress_config
                job_name = None if self.job_name is None else (
                    self.job_name + "_thermal_prop")
                tp = ThermalProp(impo, evolve_config=self.evolve_config,
                                 dump_dir=self.dump_dir, job_name=job_name)
                tp.evolve(None, self.insteps, beta / 2j)
                ket_mpo = tp.latest_mps
                if self._defined_output_path:
                    ket_mpo.dump(self._thermal_dump_path)
        return dipole_mpo.apply(ket_mpo.scale(-self.eta)), None

    @property
    def _thermal_dump_path(self):
        assert self._defined_output_path
        return os.path.join(self.dump_dir, self.job_name + "_impo.npz")

    @property
    def _defined_output_path(self):
        return self.dump_dir is not None and self.job_name is not None

    def oper_prepare(self, omega):
        identity = Mpo.identity(self.model).scale(omega)
        self.a_oper = identity.add(self.h_mpo.scale(-1, inplace=False))

    # --- site-local solve -----------------------------------------------------
    def optimize_cv(self, lr_group, isite, percent=0.0):
        first_LR, second_LR, third_LR, forth_LR = lr_group
        cidx = [isite - 1] if self.method == "1site" else [isite - 2, isite - 1]
        i = cidx[0]
        envs = (first_LR[i], first_LR[isite], second_LR[i], second_LR[isite],
                third_LR[i], third_LR[isite])
        lb, rb = forth_LR[i], forth_LR[isite]

        qnbigl, qnbigr, qnmat = self.cv_mpo._get_big_qn(cidx)
        qn_mask = get_qn_mask(qnmat, self.cv_mpo.qntot)
        cshape = qn_mask.shape
        mask_idx = torch.as_tensor(np.nonzero(qn_mask.ravel())[0],
                                   device=backend.device)

        if self.method == "1site":
            site_ops = (self.a_oper[i], self.h_mpo[i])
            guess = self.cv_mpo[i].reshape(-1)[mask_idx]
            vec_b = einsum("pq,pudt,ts->quds", lb, self.b_mpo[i], rb)
            prediag = self._prediag_1site(*envs, *site_ops)
        else:
            site_ops = (self.a_oper[i], self.a_oper[i + 1],
                        self.h_mpo[i], self.h_mpo[i + 1])
            guess = torch.tensordot(self.cv_mpo[i], self.cv_mpo[i + 1],
                                    dims=1).reshape(-1)[mask_idx]
            vec_b = einsum("pq,pudt,tvwx,xs->qudvws", lb, self.b_mpo[i],
                           self.b_mpo[i + 1], rb)
            prediag = self._prediag_2site(*envs, *site_ops)
        vec_b = vec_b.reshape(-1)[mask_idx]
        prediag = prediag.reshape(-1)[mask_idx] + self.eta ** 2

        # the solve in double precision, as at zero temperature (zerot.wide)
        matvec = ft_matvec(tuple(cshape), mask_idx, float(self.eta), wide(*envs),
                           wide(*site_ops))
        guess_w, b_w, prediag_w = wide(guess, vec_b, prediag)
        x, _ = cg(matvec, b_w, guess_w, tol=CG_TOL,
                  precond=lambda v: v / prediag_w, maxiter=CG_MAXITER)
        l_value = torch.dot(x, matvec(x)) - 2.0 * torch.dot(b_w, x)
        xstruct = cvec2cmat(x.to(guess.dtype), qn_mask)
        self.cv_mpo._update_mps(xstruct, cidx, qnbigl, qnbigr, percent)
        return l_value

    @staticmethod
    def _prediag_1site(l1, r1, l2, r2, l3, r3, a, h):
        """Jacobi preconditioner: diagonal of the three contributions."""
        d1 = einsum("pij,iumk,jmul,skl->pus", einsum("pijp->pij", l1), a, a,
                    einsum("skls->skl", r1))
        d2 = einsum("pij,iuuk,jddl,skl->puds", einsum("pijp->pij", l2), a, h,
                    einsum("skls->skl", r2))
        d3 = einsum("pij,idnk,jndl,skl->pds", einsum("pijp->pij", l3), h, h,
                    einsum("skls->skl", r3))
        return d1[:, :, None, :] + 2.0 * d2 + d3[:, None, :, :]

    @staticmethod
    def _prediag_2site(l1, r1, l2, r2, l3, r3, a1, a2, h1, h2):
        """2-site Jacobi preconditioner over (left, u1, d1, u2, d2, right)."""
        d1 = einsum("pij,iumk,jmul,kvnK,lnvL,sKL->puvs", einsum("pijp->pij", l1),
                    a1, a1, a2, a2, einsum("skls->skl", r1))
        d2 = einsum("pij,iuuk,kvvK,jddl,lccL,sKL->pudvcs", einsum("pijp->pij", l2),
                    a1, a2, h1, h2, einsum("skls->skl", r2))
        d3 = einsum("pij,idnk,jndl,kcmK,lmcL,sKL->pdcs", einsum("pijp->pij", l3),
                    h1, h1, h2, h2, einsum("skls->skl", r3))
        return (d1[:, :, None, :, None, :] + 2.0 * d2
                + d3[:, None, :, None, :, :])

    # --- environments ---------------------------------------------------------
    # first/second/third: 4-layer sandwiches (conj X | A,A / A,H / H,H | X),
    # forth: <b|X> overlap.  Index i covers sites [0, i) from the left and
    # [i, N) from the right (reference ``cv/finitet.py:585-716``).
    def _env_up(self, envs, i, domain):
        x = self.cv_mpo[i]
        xc = x.conj()
        a = self.a_oper[i]
        h = self.h_mpo[i]
        l1, l2, l3, lb = envs
        f = _E_L if domain == "L" else _E_R
        return (einsum(f[0], l1, xc, a, a, x), einsum(f[1], l2, xc, a, x, h),
                einsum(f[2], l3, xc, x, h, h), einsum(f[3], lb, self.b_mpo[i], x))

    def initialize_LR(self):
        n = len(self.cv_mpo)
        lrs = [[None] * (n + 1) for _ in range(4)]
        for k in range(4):
            ndim = 4 if k < 3 else 2
            # double precision, as at zero temperature (zerot.wide)
            lrs[k][0] = lrs[k][n] = torch.ones(
                (1,) * ndim, dtype=torch.float64, device=backend.device)
        if self.cv_mpo.to_right:
            for isite in range(n, 1, -1):
                new = self._env_up([lr[isite] for lr in lrs], isite - 1, "R")
                for lr, t in zip(lrs, new):
                    lr[isite - 1] = t
        else:
            for isite in range(1, n):
                new = self._env_up([lr[isite - 1] for lr in lrs], isite - 1, "L")
                for lr, t in zip(lrs, new):
                    lr[isite] = t
        return lrs

    def update_LR(self, lr_group, isite):
        if not self.cv_mpo.to_right:
            src, dst, site, domain = isite, isite - 1, isite - 1, "R"
        elif self.method == "1site":
            src, dst, site, domain = isite - 1, isite, isite - 1, "L"
        else:
            # 2-site: after the block (isite-2, isite-1) the sweep moves one
            # site, so one interior environment is refreshed
            src, dst, site, domain = isite - 2, isite - 1, isite - 2, "L"
        new = self._env_up([lr[src] for lr in lr_group], site, domain)
        for lr, t in zip(lr_group, new):
            lr[dst] = t
        return lr_group
