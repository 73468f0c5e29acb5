"""One step of one-site TDVP with projector splitting (Lubich, Oseledets and
Vandereycken 2015; Haegeman et al., PRB 94, 165116), in complex128.

The step is the symmetric second-order scheme: a half-sweep with dt/2 in one
direction, then one with dt/2 back.  At each site of a half-sweep the site
tensor is propagated forward by exp(-i H_site dt/2), split towards the
sweep's direction at its numerical rank (``split``), and the bond matrix propagated backward by
exp(+i H_bond dt/2) before it moves into the next site; the half-sweep's
last site is propagated forward only.  The exponentials are Lanczos
propagations with full reorthogonalization, run until the next Krylov
vector's weight falls below 1e-13 of the state's norm.

Site tensors have legs (left, physical, right); operator tensors (left
channel, out, in, right channel).
"""

import numpy as np
import torch

from reference import network


def chain_operator(sites, terms, dtype, device):
    """The chain's operator tensors as (left, out, in, right); ``sites`` the
    chain's ``(label, dim)``."""
    nodes = [{"tensor": torch.zeros([1] * min(i, 1) + [d, 1]),
              "children": [i - 1] if i else [], "label": lab}
             for i, (lab, d) in enumerate(sites)]
    ops = network.operator(nodes, len(nodes) - 1, terms, dtype, device)
    ops[0] = ops[0].unsqueeze(0)
    return ops


def _left(env, a, w):
    t = torch.einsum("bwk,ksq->bwsq", env, a)
    t = torch.einsum("bwsq,wtsv->btvq", t, w)
    return torch.einsum("btvq,btp->pvq", t, a.conj())


def _right(env, a, w):
    t = torch.einsum("ksq,pvq->kspv", a, env)
    t = torch.einsum("kspv,wtsv->ktpw", t, w)
    return torch.einsum("ktpw,btp->bwk", t, a.conj())


def _site(lenv, w, renv):
    def apply(c):
        t = torch.einsum("bwk,ksq->bwsq", lenv, c)
        t = torch.einsum("bwsq,wtsv->btvq", t, w)
        return torch.einsum("btvq,pvq->btp", t, renv)
    return apply


def _bond(lenv, renv):
    def apply(c):
        t = torch.einsum("bwk,kq->bwq", lenv, c)
        return torch.einsum("bwq,pwq->bp", t, renv)
    return apply


def expm_lanczos(apply, v, tau, tol=1e-13, max_steps=80):
    """exp(tau H) v for hermitian H (``apply``) and complex ``tau``."""
    shape = v.shape
    v = v.reshape(-1)
    beta0 = torch.linalg.vector_norm(v)
    basis = [v / beta0]
    alpha, beta = [], []
    for j in range(max_steps):
        w = apply(basis[j].reshape(shape)).reshape(-1)
        alpha.append(torch.vdot(basis[j], w).real.item())
        stack = torch.stack(basis)
        w = w - stack.T @ (stack.conj() @ w)
        w = w - stack.T @ (stack.conj() @ w)
        b = torch.linalg.vector_norm(w).item()
        t = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
        evals, evecs = np.linalg.eigh(t)
        coef = evecs @ (np.exp(tau * evals) * evecs[0].conj())
        if b * abs(coef[-1]) < tol or b < 1e-14 * max(1.0, max(abs(a) for a in alpha)):
            break
        beta.append(b)
        basis.append(w / b)
    else:
        raise RuntimeError("Lanczos propagation did not converge")
    coef = torch.as_tensor(coef, dtype=v.dtype, device=v.device)
    return (beta0 * (coef @ torch.stack(basis))).reshape(shape)


def split(a, rtol=1e-10):
    """``a = q @ c`` with ``q``'s columns orthonormal and as many as the
    numerical rank of ``a`` (singular values above ``rtol`` of the largest).
    A bond wider than its state's rank (a random MPS has such bonds at its
    ends) is cut to the rank, as a split by quantum-number sectors cuts it:
    the extra columns a plain QR would keep are arbitrary, and they widen
    the tangent space that TDVP projects onto."""
    q, r = torch.linalg.qr(a)
    u, s, vh = torch.linalg.svd(r)
    k = int((s > rtol * s[0]).sum())
    return q @ u[:, :k], s[:k, None] * vh[:k]


def _left_canonical(sites):
    sites = [s.clone() for s in sites]
    for i in range(len(sites) - 1):
        l, d, r = sites[i].shape
        q, rr = split(sites[i].reshape(l * d, r))
        sites[i] = q.reshape(l, d, q.shape[1])
        sites[i + 1] = torch.einsum("ab,bsc->asc", rr, sites[i + 1])
    return sites


def _right_canonical(sites):
    sites = [s.clone() for s in sites]
    for i in range(len(sites) - 1, 0, -1):
        l, d, r = sites[i].shape
        q, rr = split(sites[i].reshape(l, d * r).T.conj())
        sites[i] = q.T.conj().reshape(q.shape[1], d, r)
        sites[i - 1] = torch.einsum("asb,bc->asc", sites[i - 1], rr.T.conj())
    return sites


def _half_sweep_left(sites, ops, lenvs, tau):
    """From the last site to the first; ``lenvs[i]`` is the environment of
    sites 0..i-1 (left-canonical), returns the right environments."""
    n = len(sites)
    one = torch.ones((1, 1, 1), dtype=sites[0].dtype, device=sites[0].device)
    renvs = [None] * (n + 1)
    renvs[n] = one
    for i in range(n - 1, -1, -1):
        sites[i] = expm_lanczos(_site(lenvs[i], ops[i], renvs[i + 1]), sites[i], -1j * tau)
        if i == 0:
            break
        l, d, r = sites[i].shape
        q, rr = split(sites[i].reshape(l, d * r).T.conj())
        sites[i] = q.T.conj().reshape(q.shape[1], d, r)
        c = rr.T.conj()
        renvs[i] = _right(renvs[i + 1], sites[i], ops[i])
        c = expm_lanczos(_bond(lenvs[i], renvs[i]), c, 1j * tau)
        sites[i - 1] = torch.einsum("asb,bc->asc", sites[i - 1], c)
    return renvs


def _half_sweep_right(sites, ops, renvs, tau):
    n = len(sites)
    one = torch.ones((1, 1, 1), dtype=sites[0].dtype, device=sites[0].device)
    lenvs = [None] * n
    lenvs[0] = one
    for i in range(n):
        sites[i] = expm_lanczos(_site(lenvs[i], ops[i], renvs[i + 1]), sites[i], -1j * tau)
        if i == n - 1:
            break
        l, d, r = sites[i].shape
        q, rr = split(sites[i].reshape(l * d, r))
        sites[i] = q.reshape(l, d, q.shape[1])
        lenvs[i + 1] = _left(lenvs[i], sites[i], ops[i])
        c = expm_lanczos(_bond(lenvs[i + 1], renvs[i + 1]), rr, 1j * tau)
        sites[i + 1] = torch.einsum("ab,bsc->asc", c, sites[i + 1])
    return lenvs


def step(sites, ops, dt, first_to_right):
    """One TDVP-PS step of the chain ``sites`` (complex128 (l, d, r)
    tensors) under ``ops``; the first half-sweep runs to the right when
    ``first_to_right``.  Returns the normalized sites."""
    n = len(sites)
    one = torch.ones((1, 1, 1), dtype=sites[0].dtype, device=sites[0].device)
    tau = dt / 2
    if first_to_right:
        sites = _right_canonical(sites)
        renvs = [None] * (n + 1)
        renvs[n] = one
        for i in range(n - 1, 0, -1):
            renvs[i] = _right(renvs[i + 1], sites[i], ops[i])
        lenvs = _half_sweep_right(sites, ops, renvs, tau)
        _half_sweep_left(sites, ops, lenvs, tau)
    else:
        sites = _left_canonical(sites)
        lenvs = [None] * n
        lenvs[0] = one
        for i in range(n - 1):
            lenvs[i + 1] = _left(lenvs[i], sites[i], ops[i])
        renvs = _half_sweep_left(sites, ops, lenvs, tau)
        _half_sweep_right(sites, ops, renvs, tau)
    # the centre is the last site visited, every other site is an isometry
    centre = 0 if first_to_right else n - 1
    sites[centre] = sites[centre] / torch.linalg.vector_norm(sites[centre])
    return sites


def overlap(bra, ket):
    """<bra|ket> of two chains."""
    env = torch.ones((1, 1), dtype=ket[0].dtype, device=ket[0].device)
    for b, k in zip(bra, ket):
        env = torch.einsum("bk,ksq->bsq", env, k)
        env = torch.einsum("bsq,bsp->pq", env, b.conj())
    return env.reshape(-1)[0]
