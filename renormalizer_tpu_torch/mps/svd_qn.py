r"""Quantum-number-blocked SVD / QR on the host (numpy LAPACK).

Numpy copy of ``renormalizer_tpu/mps/svd_qn.py`` (reference
``renormalizer/mps/svd_qn.py:99-302`` semantics).  The port's sweeps
factorize on the device (``mps/trunc_device.py``); this module supplies the
quantum-number helpers they share and the exact host factorization that the
tests hold the device path against.

Layout convention matches the reference: the input coefficient tensor is
reshaped to a matrix (super-L-block x super-R-block); each valid sector
``(nl, nr = qntot - nl)`` selects a submatrix which is decomposed
independently, and the factors are scattered back with sector-sorted columns
(nonzero-singular-value blocks first, then the zero-padding blocks when
``full_matrices=True``).
"""

import logging
from typing import List

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend

logger = logging.getLogger(__name__)


def add_outer(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Outer sum keeping the trailing quantum-number axis
    (reference ``svd_qn.py:305-313``)."""
    assert a.shape[-1] == b.shape[-1]
    return a.reshape(a.shape[:-1] + (1,) * (b.ndim - 1) + a.shape[-1:]) + b


def get_qn_mask(qnmat: np.ndarray, qntot) -> np.ndarray:
    """Boolean mask of entries matching the total quantum number
    (reference ``svd_qn.py:316-317``)."""
    return np.all(qnmat == np.array(qntot), axis=-1)


def _robust_svd(block):
    """SVD with gesdd -> gesvd fallback (reference ``svd_qn.py:26-38``):
    gesdd occasionally fails to converge on ill-conditioned blocks deep into
    long dynamics runs; gesvd is slower but far more robust."""
    try:
        return np.linalg.svd(block, full_matrices=False)
    except np.linalg.LinAlgError:
        logger.warning("np.linalg.svd (gesdd) failed to converge; "
                       "falling back to gesvd")
        import scipy.linalg

        return scipy.linalg.svd(block, full_matrices=False,
                                lapack_driver="gesvd")


def _rq_econ(block):
    """RQ decomposition via QR of the flipped matrix: if
    A[::-1, ::-1] = Q R then A = R[::-1, ::-1] Q[::-1, ::-1] with the first
    factor upper-left-triangular.  Returns (R_factor, Q_factor)."""
    q, r = np.linalg.qr(block[::-1, ::-1].T)
    return r[::-1, ::-1].T, q[::-1, ::-1].T


_rng = np.random.default_rng(backend.seed)


def _orthonormal_complement(u, n_extra):
    """Append ``n_extra`` random orthonormal columns orthogonal to ``u``
    (reference ``svd_qn.py:52-63``)."""
    m = u.shape[0]
    a = _rng.standard_normal((m, n_extra)).astype(u.dtype)
    a = a - u @ (u.conj().T @ a)
    q, _ = np.linalg.qr(a)
    return np.concatenate([u, q], axis=1)


def _fetch(coef_array, m, n):
    """The coefficient tensor as a host (m, n) matrix."""
    if isinstance(coef_array, torch.Tensor):
        coef_array = coef_array.detach().cpu().numpy()
    return np.asarray(coef_array).reshape(m, n)


def _sector_indices(localqnl, localqnr, qntot):
    """Host-side sector map: list of (nl, lset, rset) with both sides
    non-empty."""
    sectors = []
    for nl in sorted(set(tuple(t) for t in localqnl)):
        nr = np.array(qntot) - np.array(nl)
        rset = np.nonzero(get_qn_mask(localqnr, nr))[0]
        if len(rset) == 0:
            continue
        lset = np.nonzero(get_qn_mask(localqnl, np.array(nl)))[0]
        sectors.append((np.array(nl), lset, rset))
    return sectors


def svd_qn(
    coef_array,
    qnbigl: np.ndarray,
    qnbigr: np.ndarray,
    qntot: np.ndarray,
    QR: bool = False,
    system: str = None,
    full_matrices: bool = True,
):
    r"""Blockwise SVD/QR of a coefficient tensor respecting quantum numbers.

    Parameters mirror the reference ``svd_qn.py:99-155``.  Returns host
    factors and singular values / quantum number lists:

    * SVD: ``(U, S_u, qnl_list, V, S_v, qnr_list)`` — with
      ``full_matrices=False`` the columns are globally sorted by descending
      singular value.
    * QR: ``(U, qnl_list, V, qnr_list)``.
    """
    qntot = np.atleast_1d(np.asarray(qntot))
    qn_size = len(qntot)
    localqnl = np.asarray(qnbigl).reshape(-1, qn_size)
    localqnr = np.asarray(qnbigr).reshape(-1, qn_size)
    m, n = len(localqnl), len(localqnr)
    mat = _fetch(coef_array, m, n)

    sectors = _sector_indices(localqnl, localqnr, qntot)
    if len(sectors) == 0:
        raise ValueError("Invalid quantum number")

    u_blocks, v_blocks, s_blocks = [], [], []
    u_blocks0, v_blocks0, s_blocks0_u, s_blocks0_v = [], [], [], []
    qnl_list: List[tuple] = []
    qnr_list: List[tuple] = []
    qnl_list0: List[tuple] = []
    qnr_list0: List[tuple] = []

    for nl, lset, rset in sectors:
        nr = qntot - nl
        block = mat[np.ix_(lset, rset)]
        dim = min(len(lset), len(rset))
        if not QR:
            bu, bs, bvt = _robust_svd(block)
            bv = bvt.T  # same convention as the reference: caller uses v.T
            s_blocks.append(bs)
            if full_matrices:
                # pad each side with orthonormal complement columns carrying
                # zero singular values; for very unbalanced sectors only add
                # `dim` extra columns instead of the full complement
                # (reference ``svd_qn.py:12-49`` "optimized_svd")
                def pad(b, idx_set, qn_tuple, blocks0, qn_list0, s_list0):
                    nrows = len(idx_set)
                    if nrows <= dim:
                        return
                    if 3 * dim < nrows:
                        n_extra = dim
                    else:
                        n_extra = nrows - dim
                    b_full = _orthonormal_complement(b, n_extra)
                    blocks0.append((idx_set, b_full[:, dim:]))
                    qn_list0.extend([qn_tuple] * n_extra)
                    s_list0.append(np.zeros(n_extra))

                pad(bu, lset, tuple(nl), u_blocks0, qnl_list0, s_blocks0_u)
                pad(bv, rset, tuple(nr), v_blocks0, qnr_list0, s_blocks0_v)
            u_blocks.append((lset, bu[:, :dim]))
            v_blocks.append((rset, bv[:, :dim]))
        else:
            if system == "L":
                bq, br = np.linalg.qr(block)
                u_blocks.append((lset, bq))
                v_blocks.append((rset, br.T))
            elif system == "R":
                br, bq = _rq_econ(block)
                u_blocks.append((lset, br))
                v_blocks.append((rset, bq.T))
            else:
                raise AssertionError("system must be L or R for QR")
        qnl_list.extend([tuple(nl)] * dim)
        qnr_list.extend([tuple(nr)] * dim)

    def scatter(blocks, nrows):
        total_cols = sum(b.shape[1] for _, b in blocks)
        out = np.zeros((nrows, total_cols), dtype=mat.dtype)
        col = 0
        for idx, b in blocks:
            out[idx, col:col + b.shape[1]] = b.astype(mat.dtype)
            col += b.shape[1]
        return out

    u = scatter(u_blocks + u_blocks0, m)
    v = scatter(v_blocks + v_blocks0, n)
    new_qnl = qnl_list + qnl_list0
    new_qnr = qnr_list + qnr_list0

    if QR:
        return u, new_qnl, v, new_qnr

    # singular values (host, tiny) for truncation decisions
    s_main = np.concatenate(s_blocks) if s_blocks else np.zeros(0)
    su = np.concatenate([s_main] + s_blocks0_u) if s_blocks0_u else s_main
    sv = np.concatenate([s_main] + s_blocks0_v) if s_blocks0_v else s_main

    if not full_matrices:
        order = np.argsort(su)[::-1]
        u = u[:, order]
        v = v[:, order]
        su = sv = su[order]
        new_qnl = [new_qnl[i] for i in order]
        new_qnr = [new_qnr[i] for i in order]
    return u, su, new_qnl, v, sv, new_qnr


def eigh_qn(dm: torch.Tensor, qnbigl, qnbigr, qntot, system: str):
    """Blockwise diagonalization of the state-averaged reduced density
    matrix (reference ``svd_qn.py:243-302``), on the device: each sector
    block goes through ``trunc_device.gram_eigh`` (a real block to the
    Jacobi kernel, a complex one to ``torch.linalg.eigh`` in complex128,
    counted in ``LINALG_EIGH_GRAMS``).  Returns ``(u, s, qn_list)``: ``u``
    the device eigenvectors scattered into the full row space, sector by
    sector in ascending eigenvalue order, ``s`` the host square roots of the
    eigenvalues (negative rounding clipped to 0) and the per-column
    quantum numbers."""
    from renormalizer_tpu_torch.mps.trunc_device import gram_eigh

    assert system in ("L", "R")
    qnbig, comp = (qnbigl, qnbigr) if system == "L" else (qnbigr, qnbigl)
    qntot = np.atleast_1d(np.asarray(qntot))
    qn_size = len(qntot)
    localqn = np.asarray(qnbig).reshape(-1, qn_size)
    comp_flat = np.asarray(comp).reshape(-1, qn_size)
    n = len(localqn)
    mat = backend.tensor(dm).reshape(n, n)

    u_blocks, w_list, new_qn = [], [], []
    for nl in sorted(set(tuple(t) for t in localqn)):
        if not get_qn_mask(comp_flat, qntot - np.array(nl)).any():
            continue
        sel = np.nonzero(get_qn_mask(localqn, np.array(nl)))[0]
        idx = torch.as_tensor(sel, device=mat.device)
        w, bu = gram_eigh(mat[idx][:, idx])
        w_list.append(w)
        u_blocks.append((idx, bu))
        new_qn.extend([tuple(nl)] * len(sel))

    u = torch.zeros((n, len(new_qn)), dtype=mat.dtype, device=mat.device)
    col = 0
    for idx, bu in u_blocks:
        u[idx, col:col + bu.shape[1]] = bu
        col += bu.shape[1]
    # ONE fetch of every block's spectrum
    w = torch.cat(w_list).cpu().numpy()
    return u, np.sqrt(np.where(w < 0, 0, w)), new_qn
