r"""Vibrational self-consistent field as a bond-dimension-1 DMRG-like sweep.

Port of ``renormalizer_tpu/vibration/vscf.py`` (reference
``renormalizer/vibration/vscf.py:15-126``): each site's dense effective
Hamiltonian (``hop_dense``) is diagonalized whole, its lowest modal kept at
bond dimension 1 by ``Mps._update_mps``.
"""

import logging

import numpy as np
import torch

from renormalizer_tpu_torch.mps import Mpo, Mps
from renormalizer_tpu_torch.mps.lib import Environ, cvec2cmat
from renormalizer_tpu_torch.mps.svd_qn import get_qn_mask
from renormalizer_tpu_torch.ops.contract import hop_dense
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

logger = logging.getLogger(__name__)


class Vscf:
    r"""Vibrational SCF: the mean-field sweep is a DMRG sweep at bond
    dimension 1; ``c``/``e`` hold each site's modal coefficients (host
    columns) and modal energies."""

    def __init__(self, model, mps=None):
        self.model = model
        self.c = [None] * model.nsite
        self.e = [None] * model.nsite
        if "h_mpo" in model.mpos:
            logger.info("load h_mpo from model.mpos")
            self.h_mpo = model.mpos["h_mpo"]
        else:
            self.h_mpo = Mpo(model, algo="Hopcroft-Karp")
        self.mps = mps if mps is not None else Mps.hartree_product_state(model, dict())

    def kernel(self, nsweeps=100):
        mps = self.mps
        mpo = self.h_mpo
        if mps.is_left_canonical:
            mps.ensure_right_canonical()
            env = "R"
        else:
            mps.ensure_left_canonical()
            env = "L"
        environ = Environ(mps, mpo, env)

        converged = [False] * len(mps)
        latest_c = latest_e = None
        for isweep in range(nsweeps):
            if isweep != 0:
                latest_c = [x.copy() for x in self.c]
                latest_e = [x.copy() for x in self.e]
            logger.info(f"isweep:{isweep}")
            for imps in mps.iter_idx_list(full=True):
                if mps.to_right:
                    lmethod, rmethod = "System", "Enviro"
                else:
                    lmethod, rmethod = "Enviro", "System"
                cidx = [imps]
                ltensor = environ.GetLR("L", imps - 1, mps, mpo, method=lmethod)
                rtensor = environ.GetLR("R", imps + 1, mps, mpo, method=rmethod)
                qnbigl, qnbigr, qnmat = mps._get_big_qn(cidx)
                qn_mask = get_qn_mask(qnmat, mps.qntot)
                ham = hop_dense(ltensor, rtensor, [mpo[imps]])
                idx = torch.as_tensor(np.nonzero(qn_mask.ravel())[0], device=ham.device)
                ham = ham.reshape(qn_mask.size, qn_mask.size)[idx][:, idx]
                w, v = torch.linalg.eigh(ham)
                self.e[imps] = w.cpu().numpy()

                cstruct = cvec2cmat(v, qn_mask, nroots=len(w))
                mps.compress_config = CompressConfig(CompressCriteria.fixed,
                                                     max_bonddim=1)
                mps._update_mps(cstruct[0], cidx, qnbigl, qnbigr, 0)
                for cs in cstruct:
                    assert cs.shape == mps[imps].shape
                self.c[imps] = np.stack(
                    [x.cpu().numpy().ravel() for x in cstruct], axis=-1)

                if isweep != 0:
                    converged[imps] = np.allclose(
                        self.c[imps], latest_c[imps]
                    ) and np.allclose(self.e[imps], latest_e[imps])
            if np.all(converged):
                logger.info("vscf is converged!")
                break
            mps._switch_direction()
