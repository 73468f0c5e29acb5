r"""Symmetric eigensolver by block Jacobi: CUDA kernel + plain twin.

Port of ``renormalizer_tpu/ops/jacobi.py`` (the Pallas TPU kernel, a scalar
parallel-ordered Jacobi).  It solves the Rayleigh-Ritz Gram matrices of the
truncation path (``mps/trunc_device.py``).  The algorithm is block Jacobi:

* the matrix, zero-padded to a multiple of ``WIDTH`` = 32, is cut into 2k
  blocks of ``BLOCK`` = 16 rows.  A round pairs the blocks (I, J) by the
  round-robin tournament (2k - 1 rounds form a sweep) and solves each pair's
  32 x 32 subproblem [[A_II, A_IJ], [A_JI, A_JJ]] by scalar parallel Jacobi,
  which gives an orthogonal Q_P per pair;
* the subproblem solve runs one scalar sweep of 31 rounds, and none while
  no entry of the subproblem is above the threshold (at the same block
  sweep count, one sweep beats sweeps to convergence 2.4x on an H100,
  PERF.md §6);
* each off-diagonal tile then takes A[P, P'] <- Q_P^T A[P, P'] Q_P' (the
  kernel computes P < P' and writes the transpose into the mirror tile),
  each diagonal tile takes its subproblem's result, made exactly symmetric
  from its upper triangle, and V[:, P'] <- V[:, P'] Q_P';
* a rotation of (p, q) is applied only while |a_pq| > eps sqrt|a_pp|
  sqrt|a_qq| + eps ||A||_F / n + tiny, and sets a_pq to exactly 0.  From
  the ``sweeps``-th sweep on, the solve stops after the first sweep that
  leaves every off-diagonal entry at or below that threshold, and after
  ``sweeps + 16`` sweeps at the latest.  The working type can meet the
  test: its relative part keeps the well-separated eigenvalues of a graded
  Gram spectrum accurate, and its absolute part, the old ``off <= eps
  ||A||_F`` shared out over the entries, ends the solve where clustered
  small eigenvalues only converge linearly.

``resid`` is the relative off-diagonal Frobenius norm, summed directly.

* A CUDA tensor launches the hand-written kernel ``csrc/jacobi.cu`` (one
  thread-block cluster per matrix, the whole solve in one launch) or raises.
* A CPU tensor runs :func:`jacobi_eigh_reference`: the same blocking,
  tournament, subproblem solve and stop test in batched torch ops.  It is
  also the kernel's plain version for comparisons on the card.

Zero padding is exact (rotations never touch it, eigenvalue 0) and is
stripped before returning.
"""

import torch

from renormalizer_tpu_torch.utils.profiling import COUNTERS, span

BLOCK = 16
WIDTH = 2 * BLOCK          # subproblem width
MAX_EXTRA_SWEEPS = 16
# the kernel's block-index table holds 512 blocks of 16 (csrc/jacobi.cu,
# kMaxBlocks): the padded n it takes, far above the main path's widest Gram
# (544 at M=256; ~2100 at M=1024)
MAX_N = 8192


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_size(n0: int) -> int:
    return max(_round_up(int(n0), WIDTH), WIDTH)


def default_sweeps(dtype: torch.dtype) -> int:
    """Base sweep count: the stop test ends a solve at convergence, so one
    sweep is the floor in either precision."""
    return 1


def _tournament(top: torch.Tensor, bot: torch.Tensor):
    """Round-robin re-pairing: top' = [t0, b0, t1..t_{m-2}],
    bot' = [b1..b_{m-1}, t_{m-1}]."""
    new_top = torch.cat([top[:1], bot[:1], top[1:-1]])
    new_bot = torch.cat([bot[1:], top[-1:]])
    return new_top, new_bot


def _floor(norm2: torch.Tensor, n: int) -> torch.Tensor:
    """Absolute part of the rotation threshold, per matrix."""
    finfo = torch.finfo(norm2.dtype)
    return finfo.eps * torch.sqrt(norm2) / n + finfo.tiny


def _threshold(dp: torch.Tensor, dq: torch.Tensor, floor: torch.Tensor):
    eps = torch.finfo(dp.dtype).eps
    return eps * torch.sqrt(dp.abs()) * torch.sqrt(dq.abs()) + floor


def _above(a: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """Per matrix of a stack: is any off-diagonal entry above the
    rotation threshold?"""
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    out = a.abs() > _threshold(d[..., :, None], d[..., None, :], floor[..., None, None])
    out.diagonal(dim1=-2, dim2=-1).fill_(False)
    return out.flatten(-2).any(-1)


def _off_norm2(a: torch.Tensor) -> torch.Tensor:
    """Off-diagonal Frobenius norm squared per matrix, summed directly."""
    off = a * a
    off.diagonal(dim1=-2, dim2=-1).zero_()
    return off.sum((-2, -1))


def _inner_tables(device):
    """Index tables of the 32-wide scalar tournament.  Pair l rotates the
    positions (l, l + 16); a round then moves position p to ``dest[p]``
    (31 rounds bring every position back).  ``r_idx`` places the four
    entries (c, -s, s, c) of each rotation, with the move folded in, in a
    flat 32 x 32 matrix R; ``fix_idx`` the new (pp, qq, pq, qp) entries."""
    h = BLOCK
    top, bot = _tournament(torch.arange(h), torch.arange(h, WIDTH))
    gather = torch.cat([top, bot])
    dest = torch.empty(WIDTH, dtype=torch.long)
    dest[gather] = torch.arange(WIDTH)
    lo = torch.arange(h)
    p, q = dest[lo], dest[lo + h]
    r_idx = torch.cat([lo * WIDTH + p, (lo + h) * WIDTH + p,
                       lo * WIDTH + q, (lo + h) * WIDTH + q])
    fix_idx = torch.cat([p * WIDTH + p, q * WIDTH + q, p * WIDTH + q, q * WIDTH + p])
    return gather.to(device), r_idx.to(device), fix_idx.to(device)


def _inner_round(s, q, todo, floor, tables):
    """One round of scalar parallel Jacobi on a stack of 32 x 32
    subproblems ``s`` with their accumulated rotations ``q``; only the
    subproblems flagged in ``todo`` rotate."""
    gather, r_idx, fix_idx = tables
    nsub, h = s.shape[0], BLOCK
    d = torch.diagonal(s, dim1=1, dim2=2)
    app, aqq = d[:, :h], d[:, h:]
    apq = torch.diagonal(s[:, :h, h:], dim1=1, dim2=2)
    rot = (apq.abs() > _threshold(app, aqq, floor[:, None])) & todo[:, None]
    # Rutishauser rotation zeroing a_pq; t = 0 (c = 1, s = 0) elsewhere
    theta = (aqq - app) / torch.where(rot, 2 * apq, torch.ones_like(apq))
    sgn = torch.where(theta >= 0, 1.0, -1.0).to(s.dtype)
    t = torch.where(rot, sgn / (theta.abs() + torch.sqrt(1 + theta * theta)),
                    torch.zeros_like(theta))
    c = 1 / torch.sqrt(1 + t * t)
    sn = t * c
    tau = sn / (1 + c)
    r = s.new_zeros((2, nsub, WIDTH * WIDTH))
    r[0][:, r_idx] = torch.cat([c, -sn, sn, c], 1)
    r[1][:, r_idx] = torch.cat([-sn * tau, -sn, sn, -sn * tau], 1)
    r, e = r.view(2, nsub, WIDTH, WIDTH)
    # rows p, q <- (c p - s q, s p + c q), then the columns, then the move
    s = (r.mT @ s) @ r
    # Q in the form p <- p - s (q + tau p), q <- q + s (p - tau q): c - 1 =
    # -s tau stays exact where c rounds to 1, so Q stays orthogonal
    q = q[:, :, gather] + q @ e
    flat = s.view(nsub, WIDTH * WIDTH)
    both = rot.repeat(1, 2)
    flat[:, fix_idx] = torch.cat([
        app - t * apq, aqq + t * apq,
        torch.where(both, torch.zeros_like(apq).repeat(1, 2), flat[:, fix_idx[2 * h:]])], 1)
    return s, q


def _solve_sub(s, enabled, floor, tables):
    """Scalar parallel Jacobi on a stack of 32 x 32 subproblems: one sweep
    of 31 rounds for the subproblems with an entry above the threshold.
    Returns the result, made exactly symmetric from its upper triangle, and
    the rotations Q."""
    q = torch.eye(WIDTH, dtype=s.dtype, device=s.device).repeat(s.shape[0], 1, 1)
    todo = enabled & _above(s, floor)
    if bool(todo.any()):
        for _ in range(WIDTH - 1):
            s, q = _inner_round(s, q, todo, floor, tables)
    s = torch.triu(s) + torch.triu(s, 1).mT
    return s, q


def _block_round(a, v, top, bot, active, floor, tables):
    """One block round: solve the pairs (top[i], bot[i]) of blocks, then
    rotate every tile of A and V.  Matrices not ``active`` stay as they are,
    bit for bit."""
    bsz, n, _ = a.shape
    k = n // WIDTH
    dev = a.device
    ar = torch.arange(BLOCK, device=dev)
    perm = torch.cat([top[:, None] * BLOCK + ar, bot[:, None] * BLOCK + ar], 1).reshape(-1)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    ap = a[:, perm][:, :, perm].view(bsz, k, WIDTH, k, WIDTH)
    sub = torch.diagonal(ap, dim1=1, dim2=3).permute(0, 3, 1, 2)
    s_new, q = _solve_sub(sub.reshape(bsz * k, WIDTH, WIDTH),
                          active.repeat_interleave(k), floor.repeat_interleave(k),
                          tables)
    q = q.view(bsz, k, WIDTH, WIDTH)
    # tile (P, P') <- Q_P^T A[P, P'] Q_P'; the lower tiles mirror the upper
    x = torch.einsum("bpki,bpkqj->bpiqj", q, ap)
    y = torch.einsum("bpiqk,bqkj->bpiqj", x, q)
    pidx = torch.arange(k, device=dev)
    lower = (pidx[:, None] > pidx[None, :])[None, :, None, :, None]
    y = torch.where(lower, y.permute(0, 3, 4, 1, 2), y)
    torch.diagonal(y, dim1=1, dim2=3).copy_(
        s_new.view(bsz, k, WIDTH, WIDTH).permute(0, 2, 3, 1))
    a = y.reshape(bsz, n, n)[:, inv][:, :, inv]
    vp = v[:, :, perm].view(bsz, n, k, WIDTH)
    v = torch.einsum("brpk,bpkj->brpj", vp, q).reshape(bsz, n, n)[:, :, inv]
    return a, v


def _solve_reference(a: torch.Tensor, sweeps: int):
    """Block Jacobi on a padded (B, n, n) stack.  Returns the unsorted
    diagonal (B, n), the eigenvector columns (B, n, n), the relative
    off-diagonal residual (B,) and the sweeps each matrix took (B,)."""
    bsz, n, _ = a.shape
    k = n // WIDTH
    dev = a.device
    finfo = torch.finfo(a.dtype)
    tables = _inner_tables(dev)
    v = torch.eye(n, dtype=a.dtype, device=dev).repeat(bsz, 1, 1)
    norm2 = (a * a).sum((-2, -1))
    floor = _floor(norm2, n)
    off = torch.zeros_like(norm2)
    nsweeps = torch.zeros(bsz, dtype=torch.int32, device=dev)
    active = torch.ones(bsz, dtype=torch.bool, device=dev)
    top = torch.arange(k, device=dev)
    bot = torch.arange(k, 2 * k, device=dev)
    max_sweeps = sweeps + MAX_EXTRA_SWEEPS
    isweep = 0
    while bool(active.any()):
        for _ in range(2 * k - 1):
            a, v = _block_round(a, v, top, bot, active, floor, tables)
            if k > 1:
                top, bot = _tournament(top, bot)
        isweep += 1
        nsweeps = torch.where(active, isweep, nsweeps)
        if isweep >= sweeps:
            off = torch.where(active, _off_norm2(a), off)
            active = active & _above(a, floor) & (isweep < max_sweeps)
    w = torch.diagonal(a, dim1=-2, dim2=-1).clone()
    resid = torch.sqrt(off / (norm2 + finfo.tiny))
    return w, v, resid, nsweeps


def _workspace_size(n: int) -> int:
    """Elements of kernel scratch per matrix: the k Q_P of a round (32 x 32
    each) and 16 cluster slots of 3 partial sums."""
    return (n // WIDTH) * WIDTH * WIDTH + 16 * 3


def _solve_cuda(a: torch.Tensor, sweeps: int):
    from renormalizer_tpu_torch import _build

    lib = _build.load()
    fn = {torch.float32: lib.reno_jacobi_eigh_f32,
          torch.float64: lib.reno_jacobi_eigh_f64}[a.dtype]
    bsz, n, _ = a.shape
    if not a.is_contiguous() or n % WIDTH or n > MAX_N:
        raise ValueError(f"jacobi kernel needs a contiguous stack with n a "
                         f"multiple of {WIDTH} up to {MAX_N}, got {tuple(a.shape)}")
    v = torch.empty_like(a)
    w = torch.empty((bsz, n), dtype=a.dtype, device=a.device)
    resid = torch.empty((bsz,), dtype=a.dtype, device=a.device)
    nsweeps = torch.empty((bsz,), dtype=torch.int32, device=a.device)
    work = torch.empty((bsz, _workspace_size(n)), dtype=a.dtype, device=a.device)
    # the launch goes to the current device: make it the tensor's
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), v.data_ptr(), w.data_ptr(), resid.data_ptr(),
                 nsweeps.data_ptr(), work.data_ptr(), bsz, n, int(sweeps),
                 int(sweeps) + MAX_EXTRA_SWEEPS, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eigh kernel launch failed: CUDA error {err}")
    return w, v, resid, nsweeps


def _check(a: torch.Tensor):
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"jacobi_eigh needs (n, n) or (B, n, n), got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"jacobi_eigh takes float32/float64, got {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"jacobi_eigh: unsupported device {a.device}")


def check_kernel_size(n0: int):
    """Refuse what the kernel cannot take: a padded n past its block table."""
    if padded_size(n0) > MAX_N:
        raise ValueError(f"jacobi_eigh: n = {n0} pads past the kernel's block "
                         f"table ({MAX_N // BLOCK} blocks of {BLOCK}, n <= {MAX_N})")


def _pad(a: torch.Tensor, n: int) -> torch.Tensor:
    """Contiguous zero-padded (B, n, n) copy: the kernel overwrites it."""
    bsz, n0, _ = a.shape
    out = torch.zeros((bsz, n, n), dtype=a.dtype, device=a.device)
    out[:, :n0, :n0] = a
    return out


def _finish(w, v, resid, nsweeps, n0: int, batched: bool, return_resid: bool,
            return_sweeps: bool):
    # padding never mixes with the real block: restrict, then sort ascending
    w = w[:, :n0]
    v = v[:, :n0, :n0]
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, 2, order[:, None, :].expand_as(v))
    if not batched:
        w, v, resid, nsweeps = w[0], v[0], resid[0], nsweeps[0]
    return (w, v) + ((resid,) if return_resid else ()) \
        + ((nsweeps,) if return_sweeps else ())


def jacobi_eigh_reference(a: torch.Tensor, sweeps: int = None,
                          return_resid: bool = False, return_sweeps: bool = False):
    """Plain torch version of :func:`jacobi_eigh` (any device, any size)."""
    _check(a)
    batched = a.ndim == 3
    a3 = a if batched else a[None]
    n0 = a3.shape[-1]
    sweeps = default_sweeps(a.dtype) if sweeps is None else sweeps
    out = _solve_reference(_pad(a3, padded_size(n0)), sweeps)
    return _finish(*out, n0, batched, return_resid, return_sweeps)


def jacobi_eigh_reference_stacks(stacks, sweeps: int = None):
    """:func:`jacobi_eigh_reference` of several (B, n, n) stacks of one dtype
    whose n pad to the same size, solved as one batch; returns one ``(w,
    v)`` per stack.  The padding never mixes with a real block and a matrix
    that has converged stays as it is, so each result is that of its own
    call up to the rounding of the batched products."""
    size = padded_size(stacks[0].shape[-1])
    assert all(padded_size(s.shape[-1]) == size for s in stacks)
    for s in stacks:
        _check(s)
    sweeps = default_sweeps(stacks[0].dtype) if sweeps is None else sweeps
    w, v, resid, nsweeps = _solve_reference(
        torch.cat([_pad(s, size) for s in stacks]), sweeps)
    out, start = [], 0
    for s in stacks:
        part = slice(start, start + s.shape[0])
        out.append(_finish(w[part], v[part], resid[part], nsweeps[part],
                           s.shape[-1], True, False, False))
        start += s.shape[0]
    return out


def jacobi_eigh(a: torch.Tensor, sweeps: int = None, return_resid: bool = False,
                return_sweeps: bool = False):
    """Eigenpairs of real symmetric ``a`` ((n, n) or (B, n, n)), eigenvalues
    ascending, like ``torch.linalg.eigh``.  ``return_resid`` adds the
    relative off-diagonal residual per matrix and ``return_sweeps`` the
    sweeps each solve took, so a solve that hit the sweep cap can be seen.
    On a CUDA tensor this launches the kernel (and counts the launch in
    ``jacobi.launches`` of ``utils.profiling.COUNTERS``); on a CPU tensor it
    runs the plain version.  Its span is ``trunc.jacobi``."""
    with span("trunc.jacobi"):
        _check(a)
        if a.device.type == "cpu":
            return jacobi_eigh_reference(a, sweeps, return_resid, return_sweeps)
        out = kernel_eigh(a, sweeps, return_resid, return_sweeps)
        COUNTERS["jacobi.launches"] += 1
        return out


def kernel_eigh(a: torch.Tensor, sweeps: int = None, return_resid: bool = False,
                return_sweeps: bool = False):
    """:func:`jacobi_eigh` of a CUDA tensor with no span and no count: pad,
    launch the kernel on the current stream, restrict and sort.  The callers
    count the launch (``jacobi.launches``, ``lanczos.jacobi_launches``)."""
    batched = a.ndim == 3
    a3 = a if batched else a[None]
    n0 = a3.shape[-1]
    check_kernel_size(n0)
    sweeps = default_sweeps(a.dtype) if sweeps is None else sweeps
    out = _solve_cuda(_pad(a3, padded_size(n0)), sweeps)
    return _finish(*out, n0, batched, return_resid, return_sweeps)
