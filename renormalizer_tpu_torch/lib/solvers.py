r"""Iterative solvers of the local problems: the Davidson family for DMRG
and TDA, LOBPCG, the correction vector's conjugate gradient, Lanczos
``expm`` and the one-site TDVP-PS site visit for time evolution, and the
adaptive RKF45 ``solve_ivp`` of the VMF/CMF schemes.

Port of ``davidson``/``_davidson_core``/``davidson_fused`` (with the
workspace budget and its host spill), ``davidson_multiroot``,
``davidson_host``, ``_lanczos_expm``, ``expm_krylov``/``expm_krylov_fused``,
``tdvp_ps_site_fused`` and ``solve_ivp``
(``renormalizer_tpu/lib/solvers.py:47-960``), of the
``jax.experimental.sparse.linalg.lobpcg_standard`` and
``jax.scipy.sparse.linalg.cg`` that the JAX package calls.  The JAX package
fuses each loop into one ``lax.while_loop``; PyTorch runs eagerly, so each
loop is a Python loop whose convergence test reads one scalar per
iteration, a few microseconds on a local card.  The Lanczos exponential
reads nothing back (fixed step count, masked breakdown, the tridiagonal on
the Jacobi kernel), so on a CUDA device ``expm_krylov_fused`` replays it as
one CUDA graph per operator shape.  The Davidson trial basis is a fixed
(S, N) workspace with thick restart; the S x S subspace eigh is
``torch.linalg.eigh`` in double precision (:func:`eigh_wide`).
"""

import os
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from renormalizer_tpu_torch.ops import jacobi
from renormalizer_tpu_torch.ops.contract import (
    _ENV_FORMULAS,
    _HOP_FORMULAS,
    einsum,
    hop_diag,
)
from renormalizer_tpu_torch.parallel import hop as phop
from renormalizer_tpu_torch.parallel.mesh import get_global_mesh
from renormalizer_tpu_torch.utils.profiling import COUNTERS, count_wait, span

_OUT_OF_SECTOR = 1e10

# --- Davidson workspace budget ----------------------------------------------
# The trial basis is two (S, N) panels.  A byte budget (``RENO_DAVIDSON_WS_
# BYTES``; default 4 GiB on the card, none on the CPU) shrinks S first (the
# thick restart keeps a small workspace convergent, only slower); below the
# minimal workspace the basis spills to host RAM and only the matvec stays
# on the device (reference ``renormalizer/lib/davidson/davidson.py:515-560``).

_MIN_DEVICE_SPACE = 4


def eigh_wide(a: torch.Tensor):
    """``torch.linalg.eigh`` of the Hermitian ``a`` computed in double
    precision, returned in ``a``'s precision.  In single precision cuSOLVER's
    eigh put the lowest eigenvalue of H2O/STO-3G's QC-DMRG local problems
    (norm 84) 1.062e-3 off that of the same float32 matrix solved in
    double (n 66; LAPACK's float32 eigh: up to 4.909e-5;
    ``eigh_precision_probe.py``), and the sweeps reported energies 1.126e-3
    below the FCI energy, 3.467e-5 below with this (``chip_smoke.py``
    13(b); NVIDIA H100 80GB HBM3, 700 W)."""
    if a.dtype in (torch.float64, torch.complex128):
        w, v = torch.linalg.eigh(a)
    else:
        wide = torch.complex128 if a.is_complex() else torch.float64
        w, v = torch.linalg.eigh(a.to(wide))
    if a.is_cuda:
        count_wait()  # cuSOLVER's own wait, which the sync debug mode misses
    return w.to(a.real.dtype), v.to(a.dtype)


def _davidson_ws_budget() -> float:
    env = os.environ.get("RENO_DAVIDSON_WS_BYTES")
    if env:
        return float(env)
    from renormalizer_tpu_torch.backend import backend

    return 4 * 2 ** 30 if backend.device.type == "cuda" else float("inf")


def _budgeted_max_space(max_space: int, n: int, itemsize: int) -> int:
    """Largest workspace <= ``max_space`` whose two (S, N) panels fit the
    budget; 0 means even the minimal device workspace does not (spill)."""
    budget = _davidson_ws_budget()
    if budget == float("inf"):
        return max_space
    cap = int(budget // (2 * n * itemsize))
    if cap < _MIN_DEVICE_SPACE:
        return 0
    return min(max_space, cap)


def _davidson_core(hop, x0: torch.Tensor, hdiag: torch.Tensor, tol: float,
                   max_cycle: int, max_space: int):
    """Lowest eigenpair of the hermitian operator ``hop`` from the flat
    guess ``x0``, preconditioned by the diagonal ``hdiag``.  Returns
    ``(theta, x, iterations)``; ``theta`` is a 0-d device tensor.  The
    iterations are counted in ``davidson.iterations``."""
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
        w_eig, c = eigh_wide(g)
        c0 = c[:, 0]
        theta = w_eig[0].real
        x = c0 @ v[:size]
        hx = c0 @ w[:size]
        r = hx - theta * x
        if float(torch.linalg.norm(r)) <= tol:
            COUNTERS["davidson.iterations"] += it
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
    COUNTERS["davidson.iterations"] += max_cycle
    return theta, x, max_cycle


def davidson(hop: Callable, x0: torch.Tensor, hdiag: torch.Tensor,
             tol: float = 1e-10, max_cycle: int = 100, max_space: int = 12):
    """Lowest eigenpair of the hermitian operator ``hop`` on flat vectors.
    Returns ``(theta, x, niter)``.  A closure cannot spill (there is no
    formula to run on the host's basis), so over budget it runs with the
    minimal workspace."""
    space = _budgeted_max_space(max_space, int(x0.numel()), x0.element_size())
    return _davidson_core(hop, x0, hdiag, tol, max_cycle,
                          space or _MIN_DEVICE_SPACE)


def _two_layer_cmo(operands):
    # (L, W1, W1[, W2, W2], R) -> [W1[, W2]]
    return list(operands[1:-1:2])


def davidson_fused(formula: str, operands, cshape, x0_full: torch.Tensor,
                   mask: torch.Tensor, inverse: float = 1.0, tol: float = 1e-10,
                   max_cycle: int = 100, max_space: int = 12,
                   twolayer: bool = False):
    """qn-masked Davidson in the FULL local space.

    ``einsum(formula, *operands, c)`` is the effective-H matvec, with
    ``operands = (L, W..., R)`` (each W twice with ``twolayer``); ``mask``
    is the flat boolean quantum-number mask.  The diagonal preconditioner is
    built here from the same operands.  The returned ritz vector has shape
    ``cshape``, is zero outside the sector and carries the gauge "largest
    element positive".  Over the workspace budget the trial space shrinks,
    and below the minimal workspace the host-spilled Davidson runs
    (``niter`` -1).

    With a global mesh (``parallel.set_global_mesh``) the matvec is
    bond-tensor-parallel over the mesh's ``i``/``j`` axes for the local
    problems whose bond dimensions divide them (``parallel.hop``: the
    operands are placed once per call, the blocks come home every matvec);
    the diagonal, the mask, the gauge fix and the spilled path stay
    unsharded, as in the JAX package.  Its ``_mesh_replicator`` has no
    counterpart: the sharded hop returns its product on the caller's
    device, so every result here already lives there."""
    cmo = _two_layer_cmo(operands) if twolayer else list(operands[1:-1])
    hdiag_full = hop_diag(operands[0], operands[-1], cmo, twolayer)
    hdiag = torch.where(mask, hdiag_full.reshape(-1) * inverse, _OUT_OF_SECTOR)
    x0 = torch.where(mask, x0_full.reshape(-1), 0)
    space = _budgeted_max_space(max_space, x0.numel(), x0.element_size())
    if space == 0:
        return _davidson_spilled(formula, operands, cshape, x0, hdiag,
                                 inverse, tol, max_cycle)

    mesh = get_global_mesh()
    sharded = None if mesh is None else phop.sharded_hop_factory(
        mesh, formula, tuple(tuple(o.shape) for o in operands), cshape)
    matvec = None if sharded is None else sharded.bind(*operands)

    def hop(vec):
        # the MPO and the environments are exactly qn-block-sparse, so H of
        # a masked vector is exactly zero outside the sector
        if matvec is not None:
            return matvec(vec) * inverse
        return einsum(formula, *operands, vec.reshape(cshape)).reshape(-1) * inverse

    theta, x, it = _davidson_core(hop, x0, hdiag, tol, max_cycle, space)
    x = x / torch.sign(x[torch.argmax(torch.abs(x))])
    return theta, x.reshape(cshape), it


def _davidson_spilled(formula, operands, cshape, x0, hdiag, inverse, tol,
                      max_cycle):
    """Out-of-core Davidson: the trial basis lives in host RAM
    (:func:`davidson_host`), only the active vector and the matvec run on
    the device; two vector transfers an iteration, so strictly a
    does-not-run-out-of-memory path."""
    dev, dtype = x0.device, x0.dtype
    hd = hdiag.cpu().numpy()

    def hop(v):
        vec = torch.as_tensor(v, device=dev, dtype=dtype).reshape(cshape)
        return (einsum(formula, *operands, vec).reshape(-1) * inverse).cpu().numpy()

    def precond(r, e):
        return r / (hd - e + 1e-4)

    # the strict residual test: the device Davidson converges on rnorm
    e, c = davidson_host(hop, [x0.cpu().numpy()], precond, nroots=1, tol=tol,
                         max_cycle=max_cycle, strict_residual=True)
    c = c / np.sign(c[np.argmax(np.abs(c))])
    return (torch.as_tensor(e, dtype=x0.real.dtype, device=dev),
            torch.as_tensor(c, dtype=dtype, device=dev).reshape(cshape), -1)


def _orth_rows(m: torch.Tensor) -> torch.Tensor:
    q, _ = torch.linalg.qr(m.T, mode="reduced")
    return q.T


def _new_directions(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rows of ``t`` orthonormalized against the orthonormal rows of
    ``v`` and each other, in order; a row that lies in the span already
    (less than 1e-3 of it is new) becomes a zero row.  A QR would complete
    it with an arbitrary unit vector, out of the sector as likely as not,
    where the masked matvec gives 0: a spurious zero Ritz value below every
    physical one."""
    rows = []
    for row in t:
        x = row
        for _ in range(2):
            x = x - (v.conj() @ x) @ v
            for q in rows:
                x = x - (q.conj() @ x) * q
        nrm = torch.linalg.vector_norm(x)
        new = nrm > 1e-3 * torch.linalg.vector_norm(row)
        rows.append(torch.where(new, x / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny),
                                torch.zeros_like(x)))
    return torch.stack(rows)


def davidson_multiroot(hop: Callable, x0_list, hdiag: torch.Tensor,
                       nroots: int, tol: float = 1e-9, max_cycle: int = 100,
                       max_space: int = None):
    """Block Davidson for the ``nroots`` lowest eigenpairs (reference callers
    ``renormalizer/mps/gs.py:536-538``), one host read per iteration.
    ``hop`` maps an (k, N) block of rows to its image; ``hdiag`` above 1e9
    flags the entries outside the sector.  Returns ``(thetas, X, niter)``
    with ``X`` of shape (nroots, N); ``niter`` is counted in
    ``davidson.iterations``."""
    x0 = torch.stack(list(x0_list))
    n = x0.shape[1]
    dtype = x0.dtype
    hdiag = hdiag.to(x0.real.dtype)
    if max_space is None:
        max_space = max(4 * nroots, 12)
    space = min(max_space, n)
    if space < 2 * nroots:
        # too small for block iteration (tiny masked local problems at the
        # chain's edges): solve densely; out-of-sector entries (flagged by
        # the huge preconditioner diagonal) must not give spurious zero modes
        ham = hop(torch.eye(n, dtype=dtype, device=x0.device)).T
        ham = ham + torch.diag(torch.where(hdiag > 1e9, hdiag, 0).to(dtype))
        w_eig, v = eigh_wide((ham + ham.mH) / 2)
        k = min(nroots, n)
        return w_eig[:k].real, v[:, :k].T, 0
    v = torch.zeros((space, n), dtype=dtype, device=x0.device)
    w = torch.zeros_like(v)
    start = _new_directions(x0, v[:0])
    dead = torch.linalg.vector_norm(start, dim=1) < 0.5
    if bool(dead.any()):
        # a zero or repeated guess: seeded random rows in the sector instead
        gen = torch.Generator(device=x0.device).manual_seed(0)
        noise = torch.randn(x0.shape, generator=gen, device=x0.device).to(dtype)
        noise = torch.where(hdiag[None, :] < 1e9, noise, 0)
        start = _new_directions(torch.where(dead[:, None], noise, x0), v[:0])
    v[:nroots] = start
    w[:nroots] = hop(v[:nroots])
    size = nroots
    thetas, x = None, v[:nroots]
    idx = torch.arange(space, device=x0.device)
    for it in range(max_cycle):
        g = v.conj() @ w.T
        g = (g + g.mH) / 2
        pad = torch.sum(torch.abs(g)) + 1.0
        # unused slots and the zero rows of _new_directions stay out
        empty = (idx >= size) | (torch.linalg.vector_norm(v, dim=1) < 0.5)
        g = g + torch.diag(torch.where(empty, pad, 0.0).to(g.dtype))
        w_eig, c = eigh_wide(g)
        cs = c[:, :nroots]
        thetas = w_eig[:nroots].real
        x = cs.T @ v
        hx = cs.T @ w
        r = hx - thetas[:, None] * x
        if float(torch.linalg.vector_norm(r, dim=1).max()) <= tol:
            COUNTERS["davidson.iterations"] += it
            return thetas, x, it
        t = r / (hdiag[None, :] - thetas[:, None] + 1e-4)
        for _ in range(2):
            t = t - (t @ v.conj().T) @ v
        if size + nroots > space:
            v = torch.zeros_like(v)
            w = torch.zeros_like(w)
            v[:nroots] = _orth_rows(x)
            w[:nroots] = hop(v[:nroots])
            size = nroots
        t = _new_directions(t, v)
        slots = (size + torch.arange(nroots, device=x0.device)) % space
        v[slots] = t
        w[slots] = hop(t)
        size += nroots
    COUNTERS["davidson.iterations"] += max_cycle
    return thetas, x, max_cycle


def davidson_host(hop, cguess, precond, nroots=1, tol=1e-9, max_cycle=100,
                  max_space=None, strict_residual=False):
    """Host block Davidson (numpy) for operators whose matvec is a Python
    procedure (the TDA tangent-space Hamiltonian sweeps environments), and
    the spill path of :func:`davidson_fused`.  ``hop`` maps a 1-d numpy
    vector to a 1-d numpy vector; ``precond(r, e)`` preconditions a
    residual.  Returns ``(e, c)``: ``c`` a list of eigenvectors, or one
    vector when ``nroots == 1`` (``renormalizer_tpu/lib/solvers.py:487-557``)."""
    if max_space is None:
        max_space = max(6 * nroots, 14)
    dtype = np.result_type(float, *[np.asarray(x).dtype for x in cguess])
    x0 = [np.asarray(x, dtype=dtype) for x in cguess]
    n = x0[0].shape[0]
    max_space = min(max_space, n)

    def add_vectors(vs, basis):
        for vec in vs:
            for _ in range(2):
                if len(basis):
                    vec = vec - basis.T @ (basis.conj() @ vec)
            norm = np.linalg.norm(vec)
            if norm > 1e-10:
                basis = np.vstack([basis, vec / norm])
        return basis

    basis = add_vectors(x0, np.zeros((0, n), dtype=dtype))
    images = np.array([hop(vec) for vec in basis])
    e_prev = None
    for _ in range(max_cycle):
        g = basis.conj() @ images.T
        g = (g + g.conj().T) / 2
        w_eig, c = np.linalg.eigh(g)
        k = min(nroots, len(w_eig))
        thetas = w_eig[:k]
        x = c[:, :k].T @ basis
        hx = c[:, :k].T @ images
        r = hx - thetas[:, None] * x
        rnorms = np.linalg.norm(r, axis=1)
        converged = np.all(rnorms < tol) or (
            not strict_residual
            and e_prev is not None and len(e_prev) == k
            and np.allclose(thetas, e_prev, atol=tol))
        if converged:
            break
        e_prev = thetas
        if len(basis) + k > max_space:
            # thick restart with the current ritz vectors
            basis = add_vectors(list(x), np.zeros((0, n), dtype=basis.dtype))
            images = np.array([hop(vec) for vec in basis])
        old = len(basis)
        basis = add_vectors([precond(r[i], thetas[i]) for i in range(k)], basis)
        if len(basis) == old:
            break
        images = np.vstack([images, [hop(vec) for vec in basis[old:]]])
    e = thetas if nroots > 1 else float(thetas[0])
    c = [x[i] for i in range(min(nroots, x.shape[0]))]
    return e, (c[0] if nroots == 1 else c)


# --- Lanczos expm ----------------------------------------------------------

BREAKDOWN_EPS = 64.0


def _dt_is_complex(dt) -> bool:
    return dt.is_complex() if isinstance(dt, torch.Tensor) else isinstance(dt, complex)


def _dt_tensor(dt, real: torch.dtype, device) -> torch.Tensor:
    """The python scalar ``dt`` as a 0-d tensor that promotes with a
    ``real`` tensor as the scalar does: ``real`` itself, or the complex type
    of its precision."""
    if isinstance(dt, complex):
        dtype = torch.complex64 if real == torch.float32 else torch.complex128
    else:
        dtype = real
    return torch.full((), dt, dtype=dtype, device=device)


def _tridiag_eigh(t_mat: torch.Tensor):
    """Eigenpairs of the Lanczos tridiagonal ``t_mat`` in its own (real)
    precision, with the solve's relative residual and sweep count (None on
    the CPU).  On a CUDA tensor it is one launch of the port's Jacobi kernel
    on the current stream, which reads nothing back (cuSOLVER's ``eigh``
    waits on its host workspace twice), counted in
    ``lanczos.jacobi_launches`` unless a CUDA graph is capturing it (each
    replay counts its own).  On the CPU ``torch.linalg.eigh``."""
    if not t_mat.is_cuda:
        return tuple(torch.linalg.eigh(t_mat)) + (None, None)
    out = jacobi.kernel_eigh(t_mat, return_resid=True, return_sweeps=True)
    if not torch.cuda.is_current_stream_capturing():
        COUNTERS["lanczos.jacobi_launches"] += 1
    return out


def _lanczos_core(hop: Callable, dt, v0: torch.Tensor, m_max: int,
                  breakdown_eps: float):
    """The body of :func:`_lanczos_expm`, with no span or host read: what a
    CUDA graph captures.  Returns the result and the tridiagonal with what
    :func:`_tridiag_eigh` gave for it, ``(t_mat, w, u, resid, nsweeps)``."""
    real = v0.real.dtype
    tol = breakdown_eps * torch.finfo(real).eps
    out_dtype = (torch.promote_types(v0.dtype, torch.complex64)
                 if _dt_is_complex(dt) else v0.dtype)
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
    tridiagonal = (t_mat,) + _tridiag_eigh(t_mat)
    _, w_eig, u, _, _ = tridiagonal
    # coef = u diag(exp(dt w)) u^T e_1, with the real u kept out of the
    # complex product until the end
    phase = torch.exp(dt * w_eig)
    coef = (u * u[0, :][None, :]).to(phase.dtype) @ phase
    return (beta0 * coef.to(out_dtype)) @ big_v[:m_max].to(out_dtype), tridiagonal


def _lanczos_expm(hop: Callable, dt, v0: torch.Tensor, m_max: int,
                  breakdown_eps: float = BREAKDOWN_EPS):
    """``expm(dt * A) @ v0`` from ``m_max`` Lanczos steps with full
    reorthogonalization.  The step count is fixed and a breakdown is masked
    on the device, and on a CUDA device the tridiagonal is solved by the
    port's Jacobi kernel, so the call never reads a device value on the
    host; rows of ``V`` past a breakdown are zero and contribute zero
    couplings to ``T``.  ``alpha``, ``beta`` and ``T`` are real; ``dt`` is a
    python scalar (complex for real-time propagation) or a 0-d tensor of the
    type :func:`_dt_tensor` gives it, which computes the same numbers.

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
    with span("lanczos"):
        COUNTERS["lanczos.calls"] += 1
        COUNTERS["lanczos.steps"] += m_max
        return _lanczos_core(hop, dt, v0, m_max, breakdown_eps)[0], m_max


def _python_dt(dt):
    """``dt`` as a python scalar: real when its imaginary part is zero, so
    imaginary-time propagation of a real state stays in real arithmetic."""
    dt = complex(dt)
    return dt.real if dt.imag == 0 else dt


def expm_krylov(hop: Callable, dt, v0: torch.Tensor, max_m: int = 30):
    """Approximate ``expm(dt * A) @ v0`` for hermitian ``A`` via Lanczos
    with full reorthogonalization.  ``dt`` may be complex (real-time
    evolution uses ``-1j*tau``).  Returns ``(w, m_used)``.  It runs eagerly
    (``lanczos.graph.eager.cpu``/``.opaque_hop``): a capture would freeze
    the tensors inside the opaque ``hop`` at their addresses."""
    dt = _python_dt(dt)
    if isinstance(dt, complex) and not v0.is_complex():
        v0 = v0.to(torch.promote_types(v0.dtype, torch.complex64))
    COUNTERS["lanczos.graph.eager." + ("opaque_hop" if v0.is_cuda else "cpu")] += 1
    return _lanczos_expm(hop, dt, v0, int(min(max_m, v0.shape[0])))


# --- the Lanczos expm as CUDA graphs ------------------------------------------
# On a CUDA device :func:`expm_krylov_fused` runs the whole ``_lanczos_core``
# as one CUDA graph per key: the formula, the operands' and the state's
# shapes, dtypes and strides, the Krylov dimension, the breakdown rule,
# whether dt is complex, the TF32 setting and the device.  A key is captured
# at its second sighting (the first runs eagerly, the warm-up a capture
# wants), into static operand, state and dt buffers; a call copies its
# operands, state and dt into them, replays the graph and clones the result
# out of its static output.  The graphs of a device share one memory pool:
# replays run one after another on one stream and each output is cloned out,
# so only one graph's workspace is alive at a time.  The static buffers of
# the cache are held to a share of the device memory that is free when a key
# is met (or held by the cache already); past it a key runs eagerly.  Each
# ``Mps.evolve`` ends an evolution step (:func:`end_graph_step`): a key met
# in neither of the last ``_KEEP_STEPS`` steps is forgotten with its graph,
# so shapes that do not come back (bonds that grow or are truncated) hold no
# memory.  Counters: ``lanczos.graph.captures``, ``lanczos.graph.replays``,
# ``lanczos.graph.dropped``, ``lanczos.graph.eager.<reason>`` (``cpu``,
# ``opaque_hop``, ``first_sighting``, ``budget``).

_GRAPH_SHARE = 0.5
# two steps, so that jobs that evolve two states in turn (bra and ket) keep
# the keys of both
_KEEP_STEPS = 2


class _LanczosGraph:
    """``_lanczos_core`` of ``einsum(formula, *operands, c)`` captured once
    into the pool of ``graphs`` and replayed from static buffers.  After a
    replay ``tridiagonal`` holds that call's ``(t_mat, w, u, resid,
    nsweeps)``."""

    def __init__(self, graphs, formula, operands, c0, dt, dtype, m_max):
        self.m_max = m_max
        self.ops = [torch.empty_like(o, dtype=dtype) for o in operands]
        self.c0 = torch.empty_like(c0, dtype=dtype)
        self.dt = _dt_tensor(dt, self.c0.real.dtype, c0.device)
        cshape = tuple(c0.shape)

        def hop(v):
            return einsum(formula, *self.ops, v.reshape(cshape)).reshape(-1)

        self.graph = torch.cuda.CUDAGraph()
        graphs.stream.wait_stream(torch.cuda.current_stream(c0.device))
        # the capture's device is the current one
        with torch.cuda.device(c0.device), torch.cuda.stream(graphs.stream):
            self.graph.capture_begin(pool=graphs.pool)
            try:
                out, self.tridiagonal = _lanczos_core(
                    hop, self.dt, self.c0.reshape(-1), m_max, BREAKDOWN_EPS)
                self.out = out.reshape(cshape)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(c0.device).wait_stream(graphs.stream)
        self.nbytes = sum(t.numel() * t.itemsize for t in self.ops + [self.c0, self.out])

    def __call__(self, operands, dt, c0) -> torch.Tensor:
        for static, o in zip(self.ops, operands):
            static.copy_(o)
        self.c0.copy_(c0)
        self.dt.fill_(dt)
        self.graph.replay()
        COUNTERS["lanczos.calls"] += 1
        COUNTERS["lanczos.steps"] += self.m_max
        COUNTERS["lanczos.graph.replays"] += 1
        COUNTERS["lanczos.jacobi_launches"] += 1  # the graph's one kernel launch
        return self.out.clone()


class _DeviceGraphs:
    """The Lanczos graphs of one device: the captured keys, the step in
    which each key was last met, the static bytes held, the shared memory
    pool and the capture stream."""

    def __init__(self, device):
        self.device = device
        self.graphs: Dict[tuple, _LanczosGraph] = {}
        self.met: Dict[tuple, int] = {}
        self.step = 0
        self.nbytes = 0
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def admits(self, need: int) -> bool:
        """Whether ``need`` more static bytes keep the cache within its share
        of the memory that is free on the device or held by the cache."""
        free, _ = torch.cuda.mem_get_info(self.device)
        cached = (torch.cuda.memory_reserved(self.device)
                  - torch.cuda.memory_allocated(self.device))
        return self.nbytes + need <= _GRAPH_SHARE * (free + cached + self.nbytes)

    def get(self, formula, operands, dt, c0, dtype, m_max):
        """The key's graph, captured now if this is its second sighting and
        the budget admits it; None (counted with its reason) where the call
        runs eagerly."""
        key = (formula, tuple((tuple(o.shape), o.dtype, o.stride()) for o in operands),
               (tuple(c0.shape), c0.dtype, c0.stride()), dtype, m_max, BREAKDOWN_EPS,
               isinstance(dt, complex), torch.backends.cuda.matmul.allow_tf32)
        first = key not in self.met
        self.met[key] = self.step
        graph = self.graphs.get(key)
        if graph is not None:
            return graph
        if first:
            reason = "first_sighting"
        else:
            # the Krylov basis is the capture's workspace, alive while it runs
            elems = sum(o.numel() for o in operands) + (m_max + 3) * c0.numel()
            if self.admits(elems * dtype.itemsize):
                graph = self.graphs[key] = _LanczosGraph(self, formula, operands, c0,
                                                         dt, dtype, m_max)
                self.nbytes += graph.nbytes
                COUNTERS["lanczos.graph.captures"] += 1
                return graph
            reason = "budget"
        COUNTERS["lanczos.graph.eager." + reason] += 1
        return None

    def end_step(self):
        """Forget the keys met in none of the last ``_KEEP_STEPS`` steps,
        with their graphs."""
        self.step += 1
        dropped = 0
        for key in [k for k, step in self.met.items() if step < self.step - _KEEP_STEPS]:
            del self.met[key]
            graph = self.graphs.pop(key, None)
            if graph is not None:
                self.nbytes -= graph.nbytes
                dropped += 1
        COUNTERS["lanczos.graph.dropped"] += dropped
        if dropped and not self.graphs:
            # the allocator releases a pool once no graph holds it, and
            # refuses a capture into it after that: the next one takes a new pool
            self.pool = torch.cuda.graph_pool_handle()


_DEVICE_GRAPHS: Dict[torch.device, _DeviceGraphs] = {}


def end_graph_step():
    """End an evolution step for the Lanczos graphs of every device
    (``Mps.evolve`` calls it once a step)."""
    for graphs in _DEVICE_GRAPHS.values():
        graphs.end_step()


def expm_krylov_fused(formula: str, operands, dt, c0: torch.Tensor,
                      max_m: int = 30) -> torch.Tensor:
    """Lanczos expm of an einsum-defined effective Hamiltonian:
    ``expm(dt * H_eff) c0`` with ``H_eff c = einsum(formula, *operands, c)``.
    The state and the operands are brought to one dtype, once, outside the
    Lanczos loop (complex when ``dt`` or any operand is).  On a CUDA device
    the call replays the key's CUDA graph (see above), and the conversion is
    the copy into its static buffers."""
    dt = _python_dt(dt)
    dtype = c0.dtype
    for o in operands:
        dtype = torch.promote_types(dtype, o.dtype)
    if isinstance(dt, complex):
        dtype = torch.promote_types(dtype, torch.complex64)
    m_max = int(min(max_m, c0.numel()))
    cshape = tuple(c0.shape)
    if c0.is_cuda:
        with span("lanczos"):
            graphs = _DEVICE_GRAPHS.get(c0.device)
            if graphs is None:
                graphs = _DEVICE_GRAPHS[c0.device] = _DeviceGraphs(c0.device)
            graph = graphs.get(formula, operands, dt, c0, dtype, m_max)
            if graph is not None:
                return graph(operands, dt, c0)
    else:
        COUNTERS["lanczos.graph.eager.cpu"] += 1
    c0 = c0.to(dtype)
    operands = [o.to(dtype) for o in operands]

    def hop(v):
        return einsum(formula, *operands, v.reshape(cshape)).reshape(-1)

    w, _ = _lanczos_expm(hop, dt, c0.reshape(-1), m_max)
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


# --- adaptive RKF45 initial-value solver -------------------------------------

class IvpResult(NamedTuple):
    y: torch.Tensor
    t: float
    nfev: int
    nsteps: int


# Fehlberg 4(5) coefficients
_FB_A = np.array(
    [
        [0, 0, 0, 0, 0],
        [1 / 4, 0, 0, 0, 0],
        [3 / 32, 9 / 32, 0, 0, 0],
        [1932 / 2197, -7200 / 2197, 7296 / 2197, 0, 0],
        [439 / 216, -8, 3680 / 513, -845 / 4104, 0],
        [-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40],
    ]
)
_FB_C = np.array([0, 1 / 4, 3 / 8, 12 / 13, 1, 1 / 2])
_FB_B5 = np.array([16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55])
_FB_B4 = np.array([25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0])

# The RKF45 solves are counted in ``utils.profiling.COUNTERS`` (``chip_smoke.py``
# prints them per evolution step): ``ivp.solves``, ``ivp.nfev`` (right-hand-side
# evaluations) and ``ivp.nsteps`` (attempted steps).


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.abs(x) ** 2))


def _rk_step_finish(y, ks, dt, atol, rtol):
    """The 5th/4th order solutions and the per-component-scaled RMS error
    (SciPy's ``atol + rtol * max(|y0|, |y1|)`` rule, ref
    ``lib/integrate/_ivp/rk.py``), all on the device; the error stays a
    0-d tensor for the caller's one host read."""
    b5 = torch.as_tensor(_FB_B5, device=ks.device).to(ks.dtype)
    b4 = torch.as_tensor(_FB_B4, device=ks.device).to(ks.dtype)
    y5 = y + dt * torch.tensordot(b5, ks, dims=1)
    y4 = y + dt * torch.tensordot(b4, ks, dims=1)
    scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
    return y5, _rms((y5 - y4) / scale)


def _select_initial_step(fun, t0, y0, f0, direction, rtol, atol):
    """SciPy's empirical initial-step rule (``_ivp/common.py``): matching it
    keeps the accepted-step counts comparable to the reference's."""
    scale = atol + rtol * torch.abs(y0)
    d0 = float(_rms(y0 / scale))
    d1 = float(_rms(f0 / scale))
    h0 = 1e-6 if d0 < 1e-5 or d1 < 1e-5 else 0.01 * d0 / d1
    y1 = y0 + h0 * direction * f0
    f1 = fun(t0 + h0 * direction, y1)
    d2 = float(_rms((f1 - f0) / scale)) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** 0.2  # order 4+1
    return min(100 * h0, h1)


def solve_ivp(fun, t_span, y0, rtol=1e-3, atol=1e-6, max_steps=100000,
              first_step=None, max_step=np.inf) -> IvpResult:
    """Adaptive RKF45 integration of ``dy/dt = fun(t, y)`` from ``t_span[0]``
    to ``t_span[1]``, final state only (the evolution schemes never need the
    dense output).  Port of ``renormalizer_tpu/lib/solvers.py:845-960``.

    The controller runs on the host, because ``fun`` (the TDVP-VMF equation
    of motion) keeps host-side bookkeeping, but the vector arithmetic stays
    on the device and exactly one scalar (the scaled error) is read per
    attempted step, after the three of SciPy's initial-step rule.  Error
    control is per component, ``atol + rtol |y|``, with SciPy's step-factor
    clamps; a non-finite error shrinks the step tenfold and counts as a
    step, and a step at the ``span 1e-12`` floor is accepted whatever its
    error."""
    t0, t1 = t_span
    y = torch.as_tensor(y0)
    direction = np.sign(t1 - t0) if t1 != t0 else 1.0
    span = abs(t1 - t0)
    if span == 0:
        return IvpResult(y, t0, 0, 0)
    nfev = 0
    if first_step is not None:
        h = first_step
    else:
        f0 = fun(t0, y)
        h = _select_initial_step(fun, t0, y, f0, direction, rtol, atol)
        nfev += 2
    h = min(h, span, max_step)
    if not np.isfinite(h):
        raise FloatingPointError("solve_ivp: right-hand side produced non-finite values")
    t = t0
    nsteps = 0
    while (t - t1) * direction < 0 and nsteps < max_steps:
        h = min(h, abs(t1 - t), max_step)
        dt = direction * h
        ks = []
        for i in range(6):
            yi = y
            for j in range(i):
                if _FB_A[i, j] != 0:
                    yi = yi + dt * _FB_A[i, j] * ks[j]
            ks.append(fun(t + _FB_C[i] * dt, yi))
            nfev += 1
        y5, err_dev = _rk_step_finish(y, torch.stack(ks), dt, atol, rtol)
        err = float(err_dev)  # the one host read per attempted step
        if not np.isfinite(err):
            h = h * 0.1
            nsteps += 1
            if h < span * 1e-14:
                raise FloatingPointError(
                    "solve_ivp: right-hand side produced non-finite values")
            continue
        if err <= 1.0 or h <= span * 1e-12:
            t = t + dt
            y = y5
            nsteps += 1
            factor = 10.0 if err == 0 else min(10.0, max(0.2, 0.9 * err ** (-0.2)))
            h = h * factor
        else:
            h = h * max(0.2, 0.9 * err ** (-0.2))
    COUNTERS["ivp.solves"] += 1
    COUNTERS["ivp.nfev"] += nfev
    COUNTERS["ivp.nsteps"] += nsteps
    return IvpResult(y, t, nfev, nsteps)


# --- LOBPCG ----------------------------------------------------------------
# The largest eigenpairs of an operator given by its action, as
# ``jax.experimental.sparse.linalg.lobpcg_standard`` (which the JAX package
# calls): an orthonormal [X, P, R] basis kept by SVQB, Rayleigh-Ritz on it,
# no preconditioner, no locking, and the same convergence test.  A torch loop
# over the caller's matvec with one host read per iteration; ``torch.lobpcg``
# needs the matrix itself.

def _svqb(x: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(x, dim=0, keepdim=True)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.mH @ x
    w, v = torch.linalg.eigh(inner)
    w, v = w.flip(0), v.flip(1)
    tau = torch.finfo(x.real.dtype).eps * w[0]
    sqrted = torch.where(tau > 0, torch.maximum(w, tau), 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :].to(v.dtype))
    keep = ((w > tau) & (torch.diagonal(inner).real > 0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = torch.linalg.vector_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(x: torch.Tensor) -> torch.Tensor:
    return _svqb(_svqb(x))


def _project_out(basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        u = u - basis @ (basis.mH @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.mH @ u)
    norms = torch.linalg.vector_norm(u, dim=0, keepdim=True)
    return u * (norms >= 0.99).to(u.dtype)


def _extend_basis(x: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` orthonormal columns orthogonal to the orthonormal ``x`` by a
    block Householder reflector (deterministic)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype, device=x.device)])
    w = y @ (vt.mH * ((2 * (1 + s)) ** -0.5)[None, :].to(x.dtype))
    h = -2 * (w @ (w[k:].mH @ other))
    h[k:] += other
    return h


def lobpcg_standard(a_op: Callable, x: torch.Tensor, m: int = 100,
                    tol: float = None):
    """Top-k eigenpairs of the hermitian operator ``a_op`` ((n, k) -> (n,
    k)) from the start block ``x`` (n, k), ``k * 5 < n``.  Returns
    ``(theta, U, iterations)``."""
    n, k = x.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"expected 0 < search dim * 5 < matrix dim (got {k}, {n})")
    if tol is None:
        tol = float(torch.finfo(x.real.dtype).eps)
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a_op(x)
    theta = torch.sum(x.conj() * ax, dim=0).real
    r = ax - theta[None, :] * x
    it = 0
    while it < m:
        r = _project_out(torch.cat([x, p], dim=1), r)
        xpr = torch.cat([x, p, r], dim=1)
        sas = xpr.mH @ a_op(xpr)
        w_all, q = eigh_wide((sas + sas.mH) / 2)
        theta_all, q = w_all.flip(0), q.flip(1)
        b = q[:, :k]
        b = b / torch.linalg.vector_norm(b, dim=0, keepdim=True)
        x = xpr @ b
        x = x / torch.linalg.vector_norm(x, dim=0, keepdim=True)
        qq, _ = torch.linalg.qr(q[:k, k:].mH)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = torch.linalg.vector_norm(p, dim=0, keepdim=True)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a_op(x)
        theta = theta_all[:k]
        r = ax - theta[None, :] * x
        it += 1
        reltol = 10 * n * (torch.linalg.vector_norm(ax, dim=0) + theta)
        if int((torch.linalg.vector_norm(r, dim=0) < tol * reltol).sum()) >= k:
            break
    return theta, x, it


# --- conjugate gradient ----------------------------------------------------

# CG solves and iterations are counted in ``cg.solves`` and ``cg.iterations``
# (``chip_smoke.py`` prints iterations per site)


def _vdot_real(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    res = torch.dot(x.real.reshape(-1), y.real.reshape(-1))
    if x.is_complex() or y.is_complex():
        res = res + torch.dot(x.imag.reshape(-1), y.imag.reshape(-1))
    return res


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float = 1e-5,
       precond: Callable = None, maxiter: int = 100):
    """Preconditioned conjugate gradient with the stopping rule of
    ``jax.scipy.sparse.linalg.cg`` (which the JAX package calls): stop when
    the UNpreconditioned residual has ``r.r <= tol^2 b.b`` (real parts of
    the dot products) or after ``maxiter`` iterations; one host read per
    check.  Returns ``(x, iterations)``."""
    precond = precond if precond is not None else (lambda v: v)
    atol2 = tol ** 2 * float(_vdot_real(b, b))
    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    gamma = _vdot_real(r, z)
    k = 0
    while k < maxiter and float(_vdot_real(r, r)) > atol2:
        ap = matvec(p)
        alpha = gamma / _vdot_real(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        gamma_new = _vdot_real(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    COUNTERS["cg.solves"] += 1
    COUNTERS["cg.iterations"] += k
    return x, k
