r"""Symmetric eigensolver by parallel-ordered Jacobi: CUDA kernel + plain twin.

Port of ``renormalizer_tpu/ops/jacobi.py`` (the Pallas TPU kernel).  It
solves the Rayleigh-Ritz Gram matrices of the truncation path
(``mps/trunc_device.py``): every round rotates n/2 disjoint pairs at once,
re-pairs them by a round-robin tournament (period n-1, so after each full
sweep the ordering is the identity again), and the sweep loop keeps going
past ``sweeps`` while the off-diagonal Frobenius norm is above the dtype
floor, up to ``sweeps + 16``.

* A CUDA tensor launches the hand-written kernel ``csrc/jacobi.cu`` (one CTA
  per matrix, the whole solve in one launch) or raises.
* A CPU tensor runs :func:`jacobi_eigh_reference`: the same pairing,
  rotations, tournament and convergence rule in batched torch ops.  It is
  also the kernel's plain version for comparisons on the card.

Matrices are zero-padded to a multiple of 16 (at least 16), as the TPU
kernel pads; zero padding is exact (identity rotations, eigenvalue 0) and
is stripped before returning.
"""

import torch

MAX_EXTRA_SWEEPS = 16
# dynamic shared memory a kernel may use without opting in to more; the
# kernel's need grows with n (``smem_bytes``), which bounds the padded n at
# 4080 (f32) and 3040 (f64), far above the main path's widest Gram (544)
SMEM_LIMIT = 48 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_size(n0: int) -> int:
    return max(_round_up(int(n0), 16), 16)


def smem_bytes(n: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA at padded size ``n``: the n/2 (c, s)
    pairs, 33 reduction slots and two (top, bot) int32 pair tables."""
    return (n + 33) * itemsize + 2 * n * 4


def default_sweeps(dtype: torch.dtype) -> int:
    return 10 if dtype == torch.float32 else 14


def _off_diag2(a: torch.Tensor):
    """(off-diagonal, diagonal) Frobenius norms squared per matrix, with the
    off-diagonal part taken as total - diagonal, as the TPU kernel does.  At
    convergence the difference sits at the rounding level of ||A||^2, so
    the extra sweeps run only while a solve is visibly unconverged."""
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    d2 = (diag * diag).sum(-1)
    return (a * a).sum((-2, -1)) - d2, d2


def _tournament(top: torch.Tensor, bot: torch.Tensor):
    """Round-robin re-pairing: top' = [t0, b0, t1..t_{m-2}],
    bot' = [b1..b_{m-1}, t_{m-1}]."""
    new_top = torch.cat([top[:1], bot[:1], top[1:-1]])
    new_bot = torch.cat([bot[1:], top[-1:]])
    return new_top, new_bot


def _solve_reference(a: torch.Tensor, sweeps: int):
    """Parallel Jacobi on a padded (B, n, n) stack; returns the unsorted
    diagonal (B, n), the eigenvector columns (B, n, n) and the relative
    off-diagonal residual (B,)."""
    a = a.clone()
    bsz, n, _ = a.shape
    m = n // 2
    finfo = torch.finfo(a.dtype)
    v = torch.eye(n, dtype=a.dtype, device=a.device).repeat(bsz, 1, 1)
    top = torch.arange(m, device=a.device)
    bot = torch.arange(m, n, device=a.device)
    off0, diag0 = _off_diag2(a)
    norm2 = off0 + diag0
    tol2 = finfo.eps ** 2 * norm2
    off = off0 + 1
    max_sweeps = sweeps + MAX_EXTRA_SWEEPS
    isweep = 0
    while True:
        active = (off > tol2) & (isweep < max_sweeps) if isweep >= sweeps \
            else torch.ones(bsz, dtype=torch.bool, device=a.device)
        if not bool(active.any()):
            break
        for _ in range(n - 1):
            app = a[:, top, top]
            aqq = a[:, bot, bot]
            apq = a[:, top, bot]
            safe = (apq.abs() > finfo.tiny) & active[:, None]
            theta = (aqq - app) / torch.where(safe, 2 * apq,
                                              torch.ones_like(apq))
            sgn = torch.where(theta >= 0, 1.0, -1.0).to(a.dtype)
            t = sgn / (theta.abs() + torch.sqrt(1 + theta * theta))
            c = 1 / torch.sqrt(1 + t * t)
            s = t * c
            c = torch.where(safe, c, torch.ones_like(c))
            s = torch.where(safe, s, torch.zeros_like(s))
            # rows p, q <- (c p - s q, s p + c q)
            cr, sr = c[:, :, None], s[:, :, None]
            ap, aq = a[:, top, :], a[:, bot, :]
            a[:, top, :] = cr * ap - sr * aq
            a[:, bot, :] = sr * ap + cr * aq
            # columns p, q of A and V
            cc, sc = c[:, None, :], s[:, None, :]
            ap, aq = a[:, :, top], a[:, :, bot]
            a[:, :, top] = ap * cc - aq * sc
            a[:, :, bot] = ap * sc + aq * cc
            vp, vq = v[:, :, top], v[:, :, bot]
            v[:, :, top] = vp * cc - vq * sc
            v[:, :, bot] = vp * sc + vq * cc
            top, bot = _tournament(top, bot)
        off = torch.where(active, _off_diag2(a)[0], off)
        isweep += 1
    w = torch.diagonal(a, dim1=-2, dim2=-1).clone()
    resid = torch.sqrt(off.clamp(min=0) / (norm2 + tol2))
    return w, v, resid


def _solve_cuda(a: torch.Tensor, sweeps: int):
    from renormalizer_tpu_torch import _build

    lib = _build.load()
    fn = {torch.float32: lib.reno_jacobi_eigh_f32,
          torch.float64: lib.reno_jacobi_eigh_f64}[a.dtype]
    bsz, n, _ = a.shape
    v = torch.empty_like(a)
    w = torch.empty((bsz, n), dtype=a.dtype, device=a.device)
    resid = torch.empty((bsz,), dtype=a.dtype, device=a.device)
    if not all(t.is_contiguous() for t in (a, v, w, resid)) or n % 2:
        raise ValueError("jacobi kernel needs contiguous buffers and even n")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), v.data_ptr(), w.data_ptr(), resid.data_ptr(),
             bsz, n, int(sweeps), int(sweeps) + MAX_EXTRA_SWEEPS, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eigh kernel launch failed: CUDA error {err}")
    jacobi_eigh.launches += 1
    return w, v, resid


def _check(a: torch.Tensor):
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"jacobi_eigh needs (n, n) or (B, n, n), got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"jacobi_eigh takes float32/float64, got {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"jacobi_eigh: unsupported device {a.device}")
    if smem_bytes(padded_size(a.shape[-1]), a.element_size()) > SMEM_LIMIT:
        raise ValueError(f"jacobi_eigh: n = {a.shape[-1]} needs more than "
                         f"{SMEM_LIMIT} bytes of shared memory per matrix")


def _pad(a: torch.Tensor, n: int) -> torch.Tensor:
    """Contiguous zero-padded (B, n, n) copy: the kernel overwrites it."""
    bsz, n0, _ = a.shape
    out = torch.zeros((bsz, n, n), dtype=a.dtype, device=a.device)
    out[:, :n0, :n0] = a
    return out


def _finish(w, v, resid, n0: int, batched: bool, return_resid: bool):
    # padding never mixes with the real block: restrict, then sort ascending
    w = w[:, :n0]
    v = v[:, :n0, :n0]
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, 2, order[:, None, :].expand_as(v))
    if not batched:
        w, v, resid = w[0], v[0], resid[0]
    return (w, v, resid) if return_resid else (w, v)


def jacobi_eigh_reference(a: torch.Tensor, sweeps: int = None,
                          return_resid: bool = False):
    """Plain torch version of :func:`jacobi_eigh` (any device)."""
    _check(a)
    batched = a.ndim == 3
    a3 = a if batched else a[None]
    n0 = a3.shape[-1]
    sweeps = default_sweeps(a.dtype) if sweeps is None else sweeps
    w, v, resid = _solve_reference(_pad(a3, padded_size(n0)), sweeps)
    return _finish(w, v, resid, n0, batched, return_resid)


def jacobi_eigh(a: torch.Tensor, sweeps: int = None, return_resid: bool = False):
    """Eigenpairs of real symmetric ``a`` ((n, n) or (B, n, n)), eigenvalues
    ascending, like ``torch.linalg.eigh``.  ``return_resid`` adds the
    relative off-diagonal residual per matrix, so a solve that hit the
    sweep cap can be seen.  On a CUDA tensor this launches the kernel (and
    counts the launch in ``jacobi_eigh.launches``); on a CPU tensor it runs
    the plain version."""
    _check(a)
    if a.device.type == "cpu":
        return jacobi_eigh_reference(a, sweeps, return_resid)
    batched = a.ndim == 3
    a3 = a if batched else a[None]
    n0 = a3.shape[-1]
    sweeps = default_sweeps(a.dtype) if sweeps is None else sweeps
    w, v, resid = _solve_cuda(_pad(a3, padded_size(n0)), sweeps)
    return _finish(w, v, resid, n0, batched, return_resid)


jacobi_eigh.launches = 0
