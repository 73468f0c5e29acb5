r"""Lowest-eigenpair Davidson for the DMRG local problem.

Port of ``_davidson_core`` and ``davidson_fused``
(``renormalizer_tpu/lib/solvers.py:105-310``).  The JAX package fuses the
loop into one ``lax.while_loop``; PyTorch runs eagerly, so the loop is a
Python loop whose convergence test reads one scalar per iteration — a few
microseconds on a local card.  The trial basis is a fixed (S, N) workspace
with thick restart; the S x S subspace eigh is ``torch.linalg.eigh``.
"""

import torch

from renormalizer_tpu_torch.ops.contract import einsum, hop_diag

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
