r"""Iterative solvers of the local problems: Davidson for DMRG, Lanczos
``expm`` and the one-site TDVP-PS site visit for time evolution.

Port of ``_davidson_core``/``davidson_fused``, ``_lanczos_expm``,
``expm_krylov``/``expm_krylov_fused`` and ``tdvp_ps_site_fused``
(``renormalizer_tpu/lib/solvers.py:105-310, 559-838``).  The JAX package fuses the
loop into one ``lax.while_loop``; PyTorch runs eagerly, so the loop is a
Python loop whose convergence test reads one scalar per iteration — a few
microseconds on a local card.  The trial basis is a fixed (S, N) workspace
with thick restart; the S x S subspace eigh is ``torch.linalg.eigh``.
"""

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from renormalizer_tpu_torch.ops.contract import (
    _ENV_FORMULAS,
    _HOP_FORMULAS,
    einsum,
    hop_diag,
)

_OUT_OF_SECTOR = 1e10


def _davidson_core(hop, x0: torch.Tensor, hdiag: torch.Tensor, tol: float,
                   max_cycle: int, max_space: int):
    """Lowest eigenpair of the hermitian operator ``hop`` from the flat
    guess ``x0``, preconditioned by the diagonal ``hdiag``.  Returns
    ``(theta, x, iterations)``; ``theta`` is a 0-d device tensor."""
    n = x0.shape[0]
    space = min(max_space, n)
    hdiag = hdiag.to(x0.real.dtype)
    v = torch.zeros((space, n), dtype=x0.dtype, device=x0.device)
    w = torch.zeros_like(v)
    v[0] = x0 / torch.linalg.norm(x0)
    w[0] = hop(v[0])
    size = 1
    theta, x = None, v[0]
    for it in range(max_cycle):
        g = v[:size].conj() @ w[:size].T
        g = (g + g.conj().T) / 2
        w_eig, c = torch.linalg.eigh(g)
        c0 = c[:, 0]
        theta = w_eig[0].real
        x = c0 @ v[:size]
        hx = c0 @ w[:size]
        r = hx - theta * x
        if float(torch.linalg.norm(r)) <= tol:
            return theta, x, it
        # preconditioned new direction, orthogonalized twice against V
        t = r / (hdiag - theta + 1e-4)
        for _ in range(2):
            t = t - v[:size].T @ (v[:size].conj() @ t)
        tnorm = torch.linalg.norm(t)
        t = torch.where(tnorm > 1e-14, t / tnorm, t)
        if size >= space:
            # thick restart when the workspace is full: collapse to the ritz pair
            v.zero_()
            w.zero_()
            v[0], w[0] = x, hx
            size = 1
        t = t - v[:size].T @ (v[:size].conj() @ t)
        tnorm = torch.linalg.norm(t)
        t = torch.where(tnorm > 1e-14, t / tnorm, t)
        v[size] = t
        w[size] = hop(t)
        size += 1
    return theta, x, max_cycle


def davidson_fused(formula: str, operands, cshape, x0_full: torch.Tensor,
                   mask: torch.Tensor, inverse: float = 1.0, tol: float = 1e-10,
                   max_cycle: int = 100, max_space: int = 12):
    """qn-masked Davidson in the FULL local space.

    ``einsum(formula, *operands, c)`` is the effective-H matvec, with
    ``operands = (L, W..., R)``; ``mask`` is the flat boolean quantum-number
    mask.  The diagonal preconditioner is built here from the same
    operands.  The returned ritz vector has shape ``cshape``, is zero
    outside the sector and carries the gauge "largest element positive"."""

    def hop(vec):
        # the MPO and the environments are exactly qn-block-sparse, so H of
        # a masked vector is exactly zero outside the sector
        return einsum(formula, *operands, vec.reshape(cshape)).reshape(-1) * inverse

    hdiag_full = hop_diag(operands[0], operands[-1], list(operands[1:-1]))
    hdiag = torch.where(mask, hdiag_full.reshape(-1) * inverse, _OUT_OF_SECTOR)
    x0 = torch.where(mask, x0_full.reshape(-1), 0)
    theta, x, it = _davidson_core(hop, x0, hdiag, tol, max_cycle, max_space)
    x = x / torch.sign(x[torch.argmax(torch.abs(x))])
    return theta, x.reshape(cshape), it


# --- Lanczos expm ----------------------------------------------------------

def _lanczos_expm(hop: Callable, dt, v0: torch.Tensor, m_max: int,
                  breakdown_eps: float = 64.0):
    """``expm(dt * A) @ v0`` from ``m_max`` Lanczos steps with full
    reorthogonalization.  The step count is fixed and a breakdown is masked
    on the device, so the loop never reads a device value on the host; rows
    of ``V`` past a breakdown are zero and contribute zero couplings to
    ``T``.  ``alpha``, ``beta`` and ``T`` are real; ``dt`` is a python scalar
    (complex for real-time propagation).

    Breakdown is ``beta <= max(1e-14, breakdown_eps eps max_j |A v_j|)``
    (``breakdown_eps = 0`` is the absolute rule, kept for the tests): once the
    Krylov space is exhausted, what the orthogonalization leaves of ``A v``
    is the matvec's rounding error, ``~eps |A|``, and the largest ``|A v_j|``
    so far stands for ``|A|``.  The JAX package's absolute ``1e-14`` catches
    that in fp64 only.  In fp32 the remainder is normalized into a unit
    vector; where the basis already spans every direction the operator can
    reach (a qn sector, the few live directions of a state padded by
    ``expand_bond_dimension``) that vector lies inside the span, the one-pass
    orthogonalization against a basis that is no longer orthonormal stops
    being a projection, and ``beta`` grows severalfold a step from then on:
    NaN on the CPU for a 6-dimensional block after 22 more steps, and on an
    NVIDIA H100 in complex64 a deviation of 2.4e-4 from the dense oracle on
    the 3-molecule Holstein run (3.8e-7 with this rule).  What the rule gives
    up: a live direction whose ``beta`` lies under the threshold is dropped,
    at a cost of at most ``|dt| beta``, so a spectrum narrower than 64 ulp of
    its own offset is propagated as if degenerate."""
    real = v0.real.dtype
    tol = breakdown_eps * torch.finfo(real).eps
    out_dtype = (torch.promote_types(v0.dtype, torch.complex64)
                 if isinstance(dt, complex) else v0.dtype)
    beta0 = torch.linalg.vector_norm(v0)
    big_v = torch.zeros((m_max + 1, v0.shape[0]), dtype=v0.dtype, device=v0.device)
    big_v[0] = v0 / beta0
    alpha = torch.zeros(m_max, dtype=real, device=v0.device)
    beta = torch.zeros(m_max, dtype=real, device=v0.device)
    vprev = torch.zeros_like(v0)
    bprev = torch.zeros((), dtype=real, device=v0.device)
    scale = torch.zeros((), dtype=real, device=v0.device)
    for j in range(m_max):
        v = big_v[j]
        w = hop(v)
        scale = torch.maximum(scale, torch.linalg.vector_norm(w))
        a = torch.vdot(v, w).real
        w = w - a * v - bprev * vprev
        # full reorthogonalization; rows beyond j are still zero.
        # conj(V) w = conj(V conj(w)): conjugate the vector, not the basis
        basis = big_v[: j + 1]
        w = w - basis.T @ (basis @ w.conj()).conj()
        b = torch.linalg.vector_norm(w)
        keep = b > torch.clamp(tol * scale, min=1e-14)
        big_v[j + 1] = torch.where(keep, w / b, 0)
        alpha[j] = a
        beta[j] = bprev = torch.where(keep, b, 0)
        vprev = v
    t_mat = (torch.diag(alpha) + torch.diag(beta[: m_max - 1], 1)
             + torch.diag(beta[: m_max - 1], -1))
    w_eig, u = torch.linalg.eigh(t_mat)
    # coef = u diag(exp(dt w)) u^T e_1, with the real u kept out of the
    # complex product until the end
    phase = torch.exp(dt * w_eig)
    coef = (u * u[0, :][None, :]).to(phase.dtype) @ phase
    return (beta0 * coef.to(out_dtype)) @ big_v[:m_max].to(out_dtype), m_max


def _python_dt(dt):
    """``dt`` as a python scalar: real when its imaginary part is zero, so
    imaginary-time propagation of a real state stays in real arithmetic."""
    dt = complex(dt)
    return dt.real if dt.imag == 0 else dt


def expm_krylov(hop: Callable, dt, v0: torch.Tensor, max_m: int = 30):
    """Approximate ``expm(dt * A) @ v0`` for hermitian ``A`` via Lanczos
    with full reorthogonalization.  ``dt`` may be complex (real-time
    evolution uses ``-1j*tau``).  Returns ``(w, m_used)``."""
    dt = _python_dt(dt)
    if isinstance(dt, complex) and not v0.is_complex():
        v0 = v0.to(torch.promote_types(v0.dtype, torch.complex64))
    return _lanczos_expm(hop, dt, v0, int(min(max_m, v0.shape[0])))


def expm_krylov_fused(formula: str, operands, dt, c0: torch.Tensor,
                      max_m: int = 30) -> torch.Tensor:
    """Lanczos expm of an einsum-defined effective Hamiltonian:
    ``expm(dt * H_eff) c0`` with ``H_eff c = einsum(formula, *operands, c)``.
    The state and the operands are brought to one dtype here, once, outside
    the Lanczos loop (complex when ``dt`` or any operand is)."""
    dt = _python_dt(dt)
    dtype = c0.dtype
    for o in operands:
        dtype = torch.promote_types(dtype, o.dtype)
    if isinstance(dt, complex):
        dtype = torch.promote_types(dtype, torch.complex64)
    c0 = c0.to(dtype)
    operands = [o.to(dtype) for o in operands]
    cshape = tuple(c0.shape)

    def hop(v):
        return einsum(formula, *operands, v.reshape(cshape)).reshape(-1)

    w, _ = _lanczos_expm(hop, dt, c0.reshape(-1), int(min(max_m, c0.numel())))
    return w.reshape(cshape)


# --- the TDVP-PS site visit --------------------------------------------------

# ``(row_ids, col_ids, device) -> [(row index tensor, column index tensor)]``:
# the per-sector index sets of a qn-structured QR split, uploaded once.
_SECTOR_INDEX: Dict[Tuple, list] = {}


def _sector_index(row_ids: Tuple[int, ...], col_ids: Tuple[int, ...], device):
    key = (row_ids, col_ids, device)
    sectors = _SECTOR_INDEX.get(key)
    if sectors is None:
        rid, cid = np.asarray(row_ids), np.asarray(col_ids)
        sectors = []
        for g in np.unique(cid):
            rows_g = np.flatnonzero(rid == g)
            cols_g = np.flatnonzero(cid == g)
            assert len(rows_g) >= len(cols_g) > 0  # guarded by the caller
            sectors.append((torch.as_tensor(rows_g, device=device),
                            torch.as_tensor(cols_g, device=device)))
        _SECTOR_INDEX[key] = sectors
    return sectors


def tdvp_ps_site_fused(dt, c, ltensor, w, rtensor, neighbor, cshape,
                       m: int, n: int, to_right: bool,
                       max_m: int = 30, qnbigl=None, qnbigr=None, qntot=None):
    """A full TDVP-PS site visit with no host read in it: forward Lanczos
    expm -> economy QR split -> environment update -> backward bond expm ->
    neighbor rotation.  ``m``/``n`` are the QR split dimensions.  Every
    visit has its backward step: the last site of a half-sweep is not split
    (its R factor has no neighbor to go to), so the caller propagates it
    alone, outside this function.

    Quantum numbers.  With a single full sector (``qnbigl`` None) one plain
    economy QR is exact.  With real sector structure (pass
    ``qnbigl``/``qnbigr``/``qntot``) the local matrix is qn-block-sparse and
    the QR runs per sector, scattered into zeroed ``q``/``rr``, so sector
    purity holds by construction — including for rank-deficient blocks of
    states padded by ``expand_bond_dimension``.  (One full-matrix QR with a
    block mask is not enough: for a rank-deficient block Householder places
    the deficient directions in other sectors at O(1) magnitude, and masking
    then zeroes live columns.)  A canonical MPS bond never exceeds the
    product of the dims beside it, so every kept column keeps its quantum
    number and the caller keeps its ``qn`` arrays.

    Returns ``(site, new_env, new_neighbor)``, or ``None`` when the qn
    structure is infeasible for this split (a bond sector wider than its
    free-leg support): the caller then takes the unfused path."""
    formula1 = _HOP_FORMULAS[(1, False, False)][0]
    formula0 = _HOP_FORMULAS[(0, False, False)][0]
    env_formula = _ENV_FORMULAS[("L" if to_right else "R", 3)]
    cshape = tuple(cshape)
    k = min(m, n)
    sectors = None
    if qnbigl is not None:
        qntot = np.atleast_1d(np.asarray(qntot))
        ql = np.asarray(qnbigl).reshape(-1, len(qntot))
        # left-accumulated qn of the right-side legs
        qr_ = qntot[None, :] - np.asarray(qnbigr).reshape(-1, len(qntot))
        rows, cols = (ql, qr_) if to_right else (qr_, ql)
        if len(cols) != k:
            return None  # bond wider than its free legs: not canonical
        # one id map for both axes, so equal qn vectors get equal ids
        _, inv = np.unique(np.concatenate([rows, cols]), axis=0,
                           return_inverse=True)
        inv = inv.reshape(-1)
        row_ids = tuple(inv[: len(rows)].tolist())
        col_ids = tuple(inv[len(rows):].tolist())
        nid = int(inv.max()) + 1
        if (np.bincount(col_ids, minlength=nid)
                > np.bincount(row_ids, minlength=nid)).any():
            return None  # a bond sector exceeds its row support
        sectors = _sector_index(row_ids, col_ids, c.device)

    dt = _python_dt(dt)
    w1 = expm_krylov_fused(formula1, (ltensor, w, rtensor), dt, c, max_m)
    dtype = w1.dtype
    ltensor, w, rtensor = ltensor.to(dtype), w.to(dtype), rtensor.to(dtype)
    cmat = w1.reshape(m, n)
    qr_in = cmat if to_right else cmat.T              # (rows, k)
    if sectors is None:
        q, rr = torch.linalg.qr(qr_in, mode="reduced")
    else:
        q = torch.zeros_like(qr_in)
        rr = torch.zeros((qr_in.shape[1],) * 2, dtype=dtype, device=c.device)
        for rg, cg in sectors:
            q_g, r_g = torch.linalg.qr(qr_in[rg][:, cg], mode="reduced")
            q[rg[:, None], cg[None, :]] = q_g
            rr[cg[:, None], cg[None, :]] = r_g
    # plain transposes, never conjugate ones
    if to_right:
        site = q.reshape(cshape[:-1] + (-1,))
        bond = rr                                     # (k, n)
    else:
        site = q.T.reshape((-1,) + cshape[1:])
        bond = rr.T                                   # (m, k)
    new_env = einsum(env_formula, ltensor if to_right else rtensor,
                     site.conj(), w, site)
    operands0 = (new_env, rtensor) if to_right else (ltensor, new_env)
    bond_t = expm_krylov_fused(formula0, operands0, -dt, bond, max_m)
    if to_right:
        nbr_new = torch.tensordot(bond_t, neighbor.to(dtype), dims=1)
    else:
        nbr_new = torch.tensordot(neighbor.to(dtype), bond_t, dims=1)
    return site, new_env, nbr_new
