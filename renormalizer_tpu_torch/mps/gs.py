r"""DMRG ground-state optimization.

Port of ``optimize_mps`` / ``single_sweep`` of ``renormalizer_tpu/mps/gs.py``
(reference ``renormalizer/mps/gs.py:54-304``) for one root.  Each site
update solves the local problem in the qn-masked full local space with the
Davidson of ``lib/solvers.py`` (a dense ``torch.linalg.eigh`` for local
problems under 1000 elements, or with ``algo="direct"``) and truncates on
the device (``mps/trunc_device.py``).  The per-site energies stay on the
device until the sweep ends.
"""

import logging
from typing import List, Tuple

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib.solvers import davidson_fused
from renormalizer_tpu_torch.mps.lib import Environ, cvec2cmat
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.mps import Mps
from renormalizer_tpu_torch.mps.svd_qn import get_qn_mask
from renormalizer_tpu_torch.ops.contract import hop_dense, hop_spec, tensordot1
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

logger = logging.getLogger(__name__)


def optimize_mps(mps: Mps, mpo: Mpo) -> Tuple[List, Mps]:
    r"""DMRG sweeps following ``mps.optimize_config.procedure``
    (reference ``gs.py:54-171``).  Returns (macro-sweep energies, optimized
    MPS)."""
    assert mps.optimize_config.method in ("2site", "1site")
    if mps.optimize_config.nroots != 1:
        raise NotImplementedError("the port's DMRG solves one root")
    logger.info(f"optimization method: {mps.optimize_config.method}")
    logger.info(f"procedure: {mps.optimize_config.procedure}")

    if mps.is_left_canonical:
        mps.ensure_right_canonical()
        env = "R"
    else:
        mps.ensure_left_canonical()
        env = "L"

    compress_config_bk = mps.compress_config
    environ = Environ(mps, mpo, env)

    macro_iteration_result = []
    opt_e_idx = None
    res_mps: Mps = None
    for isweep, (compress_config, percent) in enumerate(mps.optimize_config.procedure):
        logger.debug(f"isweep: {isweep}")
        if isinstance(compress_config, CompressConfig):
            mps.compress_config = compress_config
        elif isinstance(compress_config, int):
            mps.compress_config = CompressConfig(
                criteria=CompressCriteria.fixed, max_bonddim=compress_config
            )
        else:
            raise AssertionError
        logger.debug(f"compress config: {compress_config}, percent: {percent}")

        micro_iteration_result, res_mps = single_sweep(
            mps, mpo, environ, percent, opt_e_idx
        )
        opt_e = min(micro_iteration_result)
        macro_iteration_result.append(opt_e[0])
        opt_e_idx = opt_e[1]
        logger.debug(
            f"{isweep + 1} sweeps done, lowest energy = {min(macro_iteration_result)}"
        )
        if isweep > 0 and percent == 0:
            v1, v2 = sorted(macro_iteration_result)[:2]
            if np.allclose(
                v1, v2,
                rtol=mps.optimize_config.e_rtol, atol=mps.optimize_config.e_atol,
            ):
                logger.info("DMRG has converged!")
                break
    else:
        logger.warning("DMRG did not converge! Please increase the procedure!")
        logger.info(f"Lowest two energies: {sorted(macro_iteration_result)[:2]}.")

    assert res_mps is not None
    res_mps = res_mps.normalize("mps_only").ensure_left_canonical().canonicalise()
    res_mps.compress_config = compress_config_bk
    return macro_iteration_result, res_mps


def single_sweep(mps: Mps, mpo: Mpo, environ: Environ, percent, last_opt_e_idx):
    """One DMRG micro sweep (reference ``gs.py:174-304``)."""
    method = mps.optimize_config.method
    res_mps = None
    micro_iteration_result = []
    for imps in mps.iter_idx_list(full=True):
        if method == "2site" and (
            (mps.to_right and imps == mps.site_num - 1)
            or ((not mps.to_right) and imps == 0)
        ):
            break
        if mps.to_right:
            lmethod, rmethod = "System", "Enviro"
        else:
            lmethod, rmethod = "Enviro", "System"
        if method == "1site":
            lidx, cidx, ridx = imps - 1, [imps], imps + 1
        elif mps.to_right:
            lidx, cidx, ridx = imps - 1, [imps, imps + 1], imps + 2
        else:
            lidx, cidx, ridx = imps - 2, [imps - 1, imps], imps + 1
        logger.debug(f"optimize site: {cidx}")

        ltensor = environ.GetLR("L", lidx, mps, mpo, method=lmethod)
        rtensor = environ.GetLR("R", ridx, mps, mpo, method=rmethod)

        qnbigl, qnbigr, qnmat = mps._get_big_qn(cidx)
        qn_mask = get_qn_mask(qnmat, mps.qntot)
        cshape = qn_mask.shape
        cmo = [mpo[idx] for idx in cidx]

        if np.prod(cshape) < 1000 or mps.optimize_config.algo == "direct":
            e, c = eigh_direct(mps, qn_mask, ltensor, rtensor, cmo)
            cstruct = cvec2cmat(c, qn_mask)
        else:
            if method == "1site":
                cguess = mps[cidx[0]]
            else:
                cguess = tensordot1(mps[cidx[0]], mps[cidx[1]])
            e, cstruct = eigh_iterative(mps, qn_mask, ltensor, rtensor, cmo, cguess)

        micro_iteration_result.append((e, cidx))
        if cidx == last_opt_e_idx:
            res_mps = mps.copy()
            res_mps._update_mps(cstruct, cidx, qnbigl, qnbigr, percent)
        mps._update_mps(cstruct, cidx, qnbigl, qnbigr, percent)

    mps._switch_direction()
    return _realize_energies(micro_iteration_result), res_mps


def _realize_energies(micro):
    """Fetch the per-site energies in ONE device sync at sweep end."""
    vals = torch.stack([torch.as_tensor(e, device=backend.device).reshape(())
                        for e, _ in micro]).cpu().numpy()
    return [(float(v), c) for v, (_, c) in zip(vals, micro)]


def sign_fix(c: torch.Tensor) -> torch.Tensor:
    """Fix the eigenvector gauge: largest element positive
    (reference ``gs.py:372-380``)."""
    return c / torch.sign(c.reshape(-1)[torch.argmax(torch.abs(c))])


def eigh_direct(mps, qn_mask, ltensor, rtensor, cmo):
    """Dense masked effective Hamiltonian, diagonalized whole
    (reference ``gs.py:307-369``)."""
    ham = hop_dense(ltensor, rtensor, cmo)
    idx = torch.as_tensor(np.nonzero(qn_mask.ravel())[0], device=ham.device)
    dim = qn_mask.size
    ham = ham.reshape(dim, dim)[idx][:, idx]
    w, v = torch.linalg.eigh(ham * mps.optimize_config.inverse)
    return w[0], sign_fix(v[:, 0])


def eigh_iterative(mps, qn_mask, ltensor, rtensor, cmo, cguess):
    """Davidson eigensolve in the qn-masked full local space
    (reference ``gs.py:486-576``); returns the energy and the local
    coefficient tensor."""
    if mps.optimize_config.algo != "davidson":
        raise NotImplementedError(
            f"eigensolver algo={mps.optimize_config.algo} is not ported; "
            "use 'davidson' or 'direct'")
    tol = 1e-5 if backend.is_32bits else 1e-10
    formula, operands = hop_spec(ltensor, rtensor, cmo, qn_mask.shape)
    mask = torch.as_tensor(qn_mask.ravel(), device=backend.device)
    e, c, niter = davidson_fused(
        formula, operands, qn_mask.shape, cguess, mask,
        inverse=mps.optimize_config.inverse, tol=tol, max_cycle=100,
    )
    logger.debug(f"use davidson, HC hops: {niter}")
    return e, c
