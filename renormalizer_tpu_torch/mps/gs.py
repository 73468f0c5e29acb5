r"""DMRG ground-state and state-averaged excited-state optimization.

Port of ``optimize_mps`` / ``single_sweep`` of ``renormalizer_tpu/mps/gs.py``
(reference ``renormalizer/mps/gs.py:34-576``).  Each site update solves the
local problem in the qn-masked full local space: a dense ``torch.linalg.eigh``
for local problems under 1000 elements or with ``algo="direct"``, else the
Davidson of ``lib/solvers.py`` (one root: ``davidson_fused``; several:
``davidson_multiroot``), scipy's ``eigsh`` over the device matvec
(``algo="arpack"``) or LOBPCG on ``sigma - H`` (``"lobpcg"``, and
``"primme"``, which the JAX package also routes there).  ``omega`` targets
the eigenstate nearest to it by optimizing (H - omega)^2 with two-layer
environments.  Several roots truncate the averaged density matrix
(``Mps._update_mps`` with a list).  The per-site energies stay on the device
until the sweep ends.
"""

import logging
from typing import List, Tuple

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib.solvers import (
    davidson_fused,
    davidson_multiroot,
    lobpcg_standard,
)
from renormalizer_tpu_torch.mps.lib import Environ, cvec2cmat
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.mps import Mps
from renormalizer_tpu_torch.mps.svd_qn import get_qn_mask
from renormalizer_tpu_torch.ops.contract import (
    hop_dense,
    hop_diag,
    hop_expr,
    hop_spec,
    tensordot1,
)
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria, Quantity

logger = logging.getLogger(__name__)


def construct_mps_mpo(model, mmax, nexciton, offset=Quantity(0)):
    """A random start state and the model's MPO (reference ``gs.py:34-51``)."""
    mpo = Mpo(model, offset=offset)
    mps = Mps.random(model, nexciton, mmax, percent=1)
    return mps, mpo


def optimize_mps(mps: Mps, mpo: Mpo, omega: float = None) -> Tuple[List, Mps]:
    r"""DMRG sweeps following ``mps.optimize_config.procedure``
    (reference ``gs.py:54-171``).  ``omega`` targets interior eigenpairs by
    optimizing (H - omega)^2.  Returns (macro-sweep energies, optimized
    MPS), or with ``nroots > 1`` (per-sweep lists of root energies, one
    MPS per root)."""
    assert mps.optimize_config.method in ("2site", "1site")
    logger.info(f"optimization method: {mps.optimize_config.method}")
    logger.info(f"procedure: {mps.optimize_config.procedure}")

    if mps.is_left_canonical:
        mps.ensure_right_canonical()
        env = "R"
    else:
        mps.ensure_left_canonical()
        env = "L"

    compress_config_bk = mps.compress_config
    if omega is not None:
        mpo = mpo.add(Mpo.identity(mpo.model).scale(-omega))
        environ = Environ(mps, [mpo, mpo], env)
    else:
        environ = Environ(mps, mpo, env)

    macro_iteration_result = []
    opt_e_idx = None
    res_mps = None
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
            mps, mpo, environ, omega, percent, opt_e_idx
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
    roots = res_mps if isinstance(res_mps, list) else [res_mps]
    roots = [mp.normalize("mps_only").ensure_left_canonical().canonicalise()
             for mp in roots]
    for mp in roots:
        mp.compress_config = compress_config_bk
    return macro_iteration_result, (roots if isinstance(res_mps, list) else roots[0])


def single_sweep(mps: Mps, mpo: Mpo, environ: Environ, omega, percent,
                 last_opt_e_idx):
    """One DMRG micro sweep (reference ``gs.py:174-304``)."""
    method = mps.optimize_config.method
    nroots = mps.optimize_config.nroots
    averaged_ms = []
    res_mps = None
    micro_iteration_result = []
    operator = mpo if omega is None else [mpo, mpo]
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

        ltensor = environ.GetLR("L", lidx, mps, operator, method=lmethod)
        rtensor = environ.GetLR("R", ridx, mps, operator, method=rmethod)

        qnbigl, qnbigr, qnmat = mps._get_big_qn(cidx)
        qn_mask = get_qn_mask(qnmat, mps.qntot)
        cshape = qn_mask.shape
        cmo = [mpo[idx] for idx in cidx]

        if np.prod(cshape) < 1000 or mps.optimize_config.algo == "direct":
            e, c = eigh_direct(mps, qn_mask, ltensor, rtensor, cmo, omega)
            cstruct = cvec2cmat(c, qn_mask, nroots=nroots)
        else:
            # guesses live in the FULL local space (zeros outside the sector)
            if nroots == 1:
                if method == "1site":
                    cguess = [mps[cidx[0]]]
                else:
                    cguess = [tensordot1(mps[cidx[0]], mps[cidx[1]])]
            else:
                cguess = []
                for ms in averaged_ms:
                    if method == "1site":
                        cguess.append(ms)
                    elif mps.to_right:
                        cguess.append(tensordot1(ms, mps[cidx[1]]))
                    else:
                        cguess.append(tensordot1(mps[cidx[0]], ms))
            rng = np.random.default_rng(2021)
            cguess.extend(
                [rng.random(qn_mask.size) - 0.5 for _ in range(len(cguess), nroots)])
            e, c = eigh_iterative(mps, qn_mask, ltensor, rtensor, cmo, omega, cguess)
            if nroots == 1:
                cstruct = c.reshape(cshape)
            else:
                cstruct = [ci.reshape(cshape) for ci in c]

        micro_iteration_result.append((e, cidx))
        if cidx == last_opt_e_idx:
            if nroots == 1:
                res_mps = mps.copy()
                res_mps._update_mps(cstruct, cidx, qnbigl, qnbigr, percent)
            else:
                res_mps = [mps.copy() for _ in range(len(cstruct))]
                for iroot in range(len(cstruct)):
                    res_mps[iroot]._update_mps(
                        cstruct[iroot], cidx, qnbigl, qnbigr, percent)
        averaged_ms = mps._update_mps(cstruct, cidx, qnbigl, qnbigr, percent)

    mps._switch_direction()
    return _realize_energies(micro_iteration_result, nroots), res_mps


def _realize_energies(micro, nroots=1):
    """Fetch the per-site energies in ONE device sync at sweep end; several
    roots give a list of floats per site."""
    if nroots == 1:
        vals = torch.stack([torch.as_tensor(e, device=backend.device).reshape(())
                            for e, _ in micro]).cpu().numpy()
        return [(float(v), c) for v, (_, c) in zip(vals, micro)]
    vals = [torch.as_tensor(e, device=backend.device).reshape(-1) for e, _ in micro]
    host = torch.cat(vals).cpu().numpy()
    out, pos = [], 0
    for v, (_, c) in zip(vals, micro):
        out.append(([float(x) for x in host[pos:pos + v.numel()]], c))
        pos += v.numel()
    return out


def sign_fix(c, nroots: int = 1):
    """Fix the eigenvector gauge: largest element positive
    (reference ``gs.py:372-380``); a list of vectors for several roots."""
    if nroots > 1:
        return [ci / torch.sign(ci[torch.argmax(torch.abs(ci))]) for ci in c]
    return c / torch.sign(c.reshape(-1)[torch.argmax(torch.abs(c))])


def _mask_index(qn_mask) -> torch.Tensor:
    return torch.as_tensor(np.nonzero(qn_mask.ravel())[0], device=backend.device)


def eigh_direct(mps, qn_mask, ltensor, rtensor, cmo, omega=None):
    """Dense masked effective Hamiltonian, diagonalized whole
    (reference ``gs.py:307-369``)."""
    ham = hop_dense(ltensor, rtensor, cmo, twolayer=omega is not None)
    idx = _mask_index(qn_mask)
    dim = qn_mask.size
    ham = ham.reshape(dim, dim)[idx][:, idx]
    w, v = torch.linalg.eigh(ham * mps.optimize_config.inverse)
    nroots = mps.optimize_config.nroots
    if nroots == 1:
        return w[0], sign_fix(v[:, 0])
    return w[:nroots], sign_fix([v[:, i] for i in range(min(nroots, v.shape[1]))],
                                nroots)


def eigh_iterative(mps, qn_mask, ltensor, rtensor, cmo, omega, cguess):
    """Iterative eigensolve in the qn-masked full local space
    (reference ``gs.py:486-576``); returns the energy (energies) and the
    flat full-space coefficient (a list of them for several roots)."""
    inverse = mps.optimize_config.inverse
    nroots = mps.optimize_config.nroots
    algo = mps.optimize_config.algo
    twolayer = omega is not None
    cshape = qn_mask.shape
    mask = torch.as_tensor(qn_mask.ravel(), device=backend.device)
    expr = hop_expr(ltensor, rtensor, cmo, cshape, twolayer)
    # the random guesses of extra roots come from numpy (float64)
    dtype = torch.promote_types(ltensor.dtype, rtensor.dtype)
    for g in cguess:
        if isinstance(g, torch.Tensor):
            dtype = torch.promote_types(dtype, g.dtype)
    guesses = [backend.tensor(g, dtype=dtype).reshape(-1) for g in cguess]

    def hop(x):
        # full-space matvec restricted to the qn sector
        x = torch.where(mask, x, 0)
        out = expr(x.reshape(cshape)).reshape(-1) * inverse
        return torch.where(mask, out, 0)

    if algo == "arpack":
        return _eigh_arpack(mps, qn_mask, ltensor, rtensor, cmo, omega, expr,
                            guesses[0])
    if algo == "primme":
        # PRIMME is not installed; the JAX package fills its role (a
        # preconditioned block iterative solver) with LOBPCG, and so does
        # the port
        logger.info("algo='primme' honored via LOBPCG")
        algo = "lobpcg"
    if algo == "lobpcg":
        return _eigh_lobpcg(hop, mask, guesses, nroots, qn_mask.size)
    if algo != "davidson":
        raise NotImplementedError(
            f"eigensolver algo={algo} is not available; use 'davidson', "
            "'arpack', 'lobpcg', 'primme' or 'direct'")
    tol = 1e-5 if backend.is_32bits else 1e-10
    if nroots == 1:
        formula, operands = hop_spec(ltensor, rtensor, cmo, cshape, twolayer)
        e, c, niter = davidson_fused(
            formula, operands, cshape, guesses[0].reshape(cshape), mask,
            inverse=inverse, tol=tol, max_cycle=100, twolayer=twolayer)
        logger.debug(f"use davidson, HC hops: {niter}")
        return e, c
    hdiag = hop_diag(ltensor, rtensor, cmo, twolayer).reshape(-1) * inverse
    hdiag = torch.where(mask, hdiag, 1e10)
    x0 = [torch.where(mask, g, 0) for g in guesses]
    thetas, x, niter = davidson_multiroot(
        lambda rows: torch.stack([hop(r) for r in rows]), x0, hdiag, nroots,
        tol=max(tol, 1e-9), max_cycle=100)
    logger.debug(f"use block davidson, iterations: {niter}")
    return thetas, sign_fix([x[i] for i in range(nroots)], nroots)


def _eigh_arpack(mps, qn_mask, ltensor, rtensor, cmo, omega, expr, guess):
    """scipy ``eigsh`` (ARPACK) on the host over the masked subspace, each
    matvec on the device; tiny subspaces (no more entries than roots) go
    dense (reference ``gs.py:356-391``)."""
    import scipy.sparse.linalg

    inverse = mps.optimize_config.inverse
    nroots = mps.optimize_config.nroots
    idx = np.nonzero(qn_mask.ravel())[0]
    if len(idx) <= nroots:
        return eigh_direct(mps, qn_mask, ltensor, rtensor, cmo, omega)
    dim = qn_mask.size
    idx_dev = torch.as_tensor(idx, device=backend.device)
    dtype = torch.promote_types(guess.dtype, ltensor.dtype)

    def matvec(x):
        full = torch.zeros(dim, dtype=dtype, device=backend.device)
        full[idx_dev] = torch.as_tensor(np.asarray(x).ravel(), device=backend.device,
                                        dtype=dtype)
        out = expr(full.reshape(qn_mask.shape)).reshape(-1)[idx_dev] * inverse
        return out.cpu().numpy()

    from renormalizer_tpu_torch.backend import np_dtype

    op = scipy.sparse.linalg.LinearOperator((len(idx), len(idx)), matvec=matvec,
                                            dtype=np_dtype(dtype))
    v0 = guess.cpu().numpy()[idx]
    w, v = scipy.sparse.linalg.eigsh(op, k=nroots, which="SA", v0=v0)
    cs = []
    for i in range(nroots):
        full = torch.zeros(dim, dtype=dtype, device=backend.device)
        full[idx_dev] = torch.as_tensor(v[:, i], device=backend.device, dtype=dtype)
        cs.append(full)
    if nroots == 1:
        return float(w[0]), sign_fix(cs[0])
    return w, sign_fix(cs, nroots)


def _eigh_lobpcg(hop, mask, guesses, nroots, size):
    """LOBPCG on ``sigma - H`` (it finds the largest eigenpairs), sigma from
    ten power steps, out-of-sector entries held at 0, far below the shifted
    spectrum (reference role: ``gs.py:404-453``)."""
    x = torch.where(mask, guesses[0], 0)
    x = x / torch.linalg.vector_norm(x)
    lam_max = None
    for _ in range(10):
        hx = hop(x)
        lam_max = torch.vdot(x, hx).real
        x = hx / torch.linalg.vector_norm(hx)
    sigma = torch.abs(lam_max) * 1.2 + 1.0

    def a_op(xmat):
        out = torch.stack([sigma * col - hop(col) for col in xmat.T], dim=1)
        return torch.where(mask[:, None], out, 0)

    rng = np.random.default_rng(2021)
    cols = [torch.where(mask, g, 0) for g in guesses]
    while len(cols) < nroots:
        cols.append(torch.where(mask, backend.tensor(rng.random(size) - 0.5), 0))
    dtype = cols[0].dtype
    x0 = torch.stack([c.to(dtype) for c in cols], dim=1)
    thetas, vecs, _ = lobpcg_standard(a_op, x0, m=100)
    e_vals = sigma - thetas
    if nroots == 1:
        return e_vals[0], sign_fix(vecs[:, 0])
    return e_vals, sign_fix([vecs[:, i] for i in range(nroots)], nroots)
