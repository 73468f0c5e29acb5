r"""On-device quantum-number-blocked truncation (randomized, sector-pure).

Port of ``renormalizer_tpu/mps/trunc_device.py``.  Each site update of the
sweep factorizes the local coefficient per quantum-number sector with a
randomized range finder and a Rayleigh-Ritz step:

    Y   = A @ Omega                 (range sketch, l1 columns)
    Y   = orth(Y); Y = A (A^H Y)    (power iteration sharpens the sketch)
    Q   = orth([Y | Omega_c])       (orthonormal candidates; Omega_c adds
                                     in-sector complement columns for
                                     percent-based state allocation)
    B   = Q^H A;  G = B B^H
    lam, W = eigh(G);  U = Q W      (Rayleigh-Ritz: candidates sorted by
                                     projected singular value)

When the sketch width reaches the sector rank the factorization is exact;
otherwise it captures the top ``cap + OVERSAMPLE`` states, which is all a
truncation to ``cap`` states can keep.

Every real Gram eigh goes through :func:`ops.jacobi.jacobi_eigh` (the CUDA
kernel on the card, its plain twin on the CPU); a complex Gram goes to
``torch.linalg.eigh`` and is counted in :data:`LINALG_EIGH_GRAMS`.  The
only device-to-host traffic per site update is the candidate spectrum (a
few KB) that the host-side selection reads.

Differences from the JAX package: the TPU-only 128-lane policies
(``align_l1p``/``pick_eigh``) are gone, so l1p = min(rank, cap + OVERSAMPLE);
there is no sector-to-device placement; the async static-plan selection and
the bucketed/gather-batched kernels are not carried (the masked batch and
the per-sector path cover every case).
"""

from typing import List

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.mps.svd_qn import _sector_indices
from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

OVERSAMPLE = 32

# Gram matrices sent to torch.linalg.eigh instead of the Jacobi kernel
# (complex only); ``chip_smoke.py`` reads it with ``jacobi_eigh.launches``.
LINALG_EIGH_GRAMS = 0


# Byte budget for the one-launch masked sector batch's (nsec, m, n) blocks;
# larger updates run the per-sector path.
MASK_BUDGET = 256 * 2**20


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    # drawn in float32 and cast, as the JAX package draws its sketches
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=backend.device).to(dtype)


def _solve_lh(lmat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q @ L^{-H}`` for lower-triangular ``L``."""
    return torch.linalg.solve_triangular(lmat.mH, q, upper=True, left=False)


def _double(x: torch.Tensor) -> torch.Tensor:
    """``x`` in double precision (itself when it already is)."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def _qr(z: torch.Tensor):
    """Economy Householder QR of ``z``, computed in double precision.  In
    single precision the QR returns NaN on a column whose entries reach the
    underflow range: in fp32 a relaxed start state of a nearly undisplaced
    mode (the band-limit charge diffusion of ``tests/test_apps.py``,
    displacement 1e-10) carries coefficients from 1 down to 1e-43, and both
    LAPACK's and cuSOLVER's QR turned ``[[-1, 6e-10], [0, 0], [4e-31 -
    2.4e-43j, 0]]`` and a rank-1 (4, 3) block with rows of 1e-3, 1e-16 and
    1e-20 into NaN.  The JAX package's XLA flushes subnormals on its own."""
    q, r = torch.linalg.qr(_double(z), mode="reduced")
    return q.to(z.dtype), r.to(z.dtype)


def _orth(z: torch.Tensor) -> torch.Tensor:
    """Orthonormal columns by Householder QR; rank-deficient directions are
    completed with arbitrary orthonormal columns, which is what the
    complement states need.  Batched over leading dims."""
    return _qr(z)[0]


def _colnormalize(y: torch.Tensor) -> torch.Tensor:
    """Scale each column to (at most) unit norm before orthogonalization;
    exactly-zero columns stay zero."""
    norms = torch.linalg.vector_norm(y, dim=-2, keepdim=True)
    tiny = torch.finfo(y.real.dtype).tiny
    return y / torch.clamp(norms, min=tiny ** 0.5)


def lam_to_sigma(lam) -> np.ndarray:
    """Candidate spectrum (host): sqrt of the projected eigenvalues, with
    the pad/sentinel slots (``lam < 0``) kept at -1 so selection can never
    retain them."""
    if isinstance(lam, torch.Tensor):
        lam = lam.detach().cpu().numpy()
    lam = np.asarray(lam)
    return np.where(lam < 0, -1.0, np.sqrt(np.maximum(lam, 0.0)))


def gram_eigh(g: torch.Tensor):
    """Ascending eigenpairs of a Hermitian Gram matrix or stack: real goes
    to the Jacobi kernel, complex to ``torch.linalg.eigh`` (counted), in
    double precision: in complex64 cuSOLVER's eigh did not converge on a
    Gram of the band-limit charge diffusion on an H100 (entries from 1 down
    to the underflow range; see ``_qr``)."""
    global LINALG_EIGH_GRAMS
    if g.is_complex():
        LINALG_EIGH_GRAMS += 1 if g.ndim == 2 else g.shape[0]
        w, v = torch.linalg.eigh(_double(g))
        return w.to(g.real.dtype), v.to(g.dtype)
    return jacobi_eigh(g)


def _candidate_core(a: torch.Tensor, mask_a: torch.Tensor,
                    l1_real: torch.Tensor, l1p: int, gen: torch.Generator):
    """Randomized range finder + Rayleigh-Ritz on a stack of masked sector
    blocks ``a`` (B, rows, cols) whose rows outside the sector are zero
    (``mask_a`` (B, rows), 1 inside).  Returns candidates (B, rows, l1p)
    and lam (B, l1p) descending; pad slots (>= ``l1_real``) and columns
    whose in-sector mass was lost report ``lam = -1``.

    The f32 rank-edge fixes of the JAX package are kept as they are: the
    in-sector regularizer, the re-masking with fully-leaked-column
    replacement, the shifted CholeskyQR3 refinement, the structural zeroing,
    the ``delta`` diagonal shift and the sentinel sort.  Householder QR
    completes rank-edge columns differently on every library, and these
    steps are what make that harmless."""
    dtype = a.dtype
    rows, cols = a.shape[-2], a.shape[-1]
    finfo = torch.finfo(a.real.dtype)
    mask_col = mask_a[..., :, None].to(dtype)             # (B, rows, 1)
    col_ok = (torch.arange(l1p, device=a.device)[None, :]
              < l1_real[:, None])                          # (B, l1p)
    colok_f = col_ok[:, None, :].to(dtype)                 # (B, 1, l1p)

    omega = _randn(gen, (cols, l1p), dtype)
    y = _orth(a @ omega)
    y = a @ (a.mH @ y)
    yn = _colnormalize(y)
    # in-sector completion regularizer: below the numerical rank QR
    # completes with junk spread over ALL rows, including rows outside the
    # sector; a tiny in-sector component keeps every completion inside
    reg = _randn(gen, (rows, l1p), dtype)
    yn = yn + reg * (mask_col * finfo.eps ** 0.75)
    q = _orth(yn)
    # re-confine, replace fully-leaked columns with fresh in-sector random
    # columns, then re-orthonormalize by shifted CholeskyQR3
    q = q * mask_col
    colnorm2 = (q.abs() ** 2).sum(-2)                      # (B, l1p)
    reg2 = _randn(gen, (rows, l1p), dtype) * mask_col
    q = torch.where((colnorm2 < 0.5)[:, None, :], reg2, q) * colok_f
    eye_r = _eye(l1p, q)
    for ipass in range(3):
        gq = q.mH @ q
        # only the first pass carries the stabilizing shift
        shift = (16 * finfo.eps if ipass == 0 else 0.0) * torch.diagonal(
            gq, dim1=-2, dim2=-1).real.sum(-1) + finfo.tiny
        lq, _ = torch.linalg.cholesky_ex(gq + shift[:, None, None] * eye_r)
        q = _solve_lh(lq, q) * colok_f
    # structural slots are zeroed exactly so g decouples into [g_real, 0]
    q = q * colok_f
    b = q.mH @ a
    g = b @ b.mH
    # delta shift on the non-structural diagonal: genuine tail eigenvalues
    # stay above the structural zeros; eigenvectors are unchanged
    delta = 4 * finfo.eps * torch.diagonal(g, dim1=-2, dim2=-1).real.sum(-1) \
        + finfo.tiny                                       # (B,)
    g = g + torch.diag_embed((delta[:, None] * col_ok).to(dtype))
    lam, w = gram_eigh(g)
    # post: descending order, sentinels for lost or structural slots
    lam = torch.nan_to_num(torch.clamp(lam.flip(-1) - delta[:, None], min=0))
    u = q @ w.flip(-1)
    vals = u * mask_col
    colmass = (vals.abs() ** 2).sum(-2)
    slot_ok = col_ok & (colmass > 0.5)
    lam = torch.where(slot_ok, lam, torch.full_like(lam, -1.0))
    scale = torch.where(colmass > 0.25,
                        1.0 / torch.sqrt(torch.clamp(colmass, min=0.25)),
                        torch.ones_like(colmass))
    vals = vals * scale[:, None, :].to(dtype)
    # stable descending sort sinks the sentinels to the end
    order = torch.sort(-lam, dim=-1, stable=True)[1]
    vals = torch.gather(vals, 2, order[:, None, :].expand_as(vals))
    return vals, torch.gather(lam, 1, order)


def _gram_pass(a, l1, l2, gen):
    """One randomized range finder + Rayleigh-Ritz pass on the block ``a``
    (rows x cols): ``l1`` sketched columns and ``l2`` random complement
    columns.  Returns the candidates (rows, l1 + l2) and lam descending."""
    ra, rb = a.shape
    omega = _randn(gen, (rb, l1), a.dtype)
    y = _orth(a @ omega)
    y = a @ (a.mH @ y)
    if l2 > 0:
        y = torch.cat([y, _randn(gen, (ra, l2), a.dtype)], dim=1)
    q = _orth(_colnormalize(y))
    b = q.mH @ a
    g = b @ b.mH
    finfo = torch.finfo(a.real.dtype)
    delta = 4 * finfo.eps * torch.diagonal(g).real.sum() + finfo.tiny
    g = g + delta * _eye(l1 + l2, g)
    lam, w = gram_eigh(g)
    lam = torch.nan_to_num(torch.clamp(lam.flip(-1) - delta, min=0))
    return q @ w.flip(-1), lam


def _seeded_completion(done: torch.Tensor, need: int, gen) -> torch.Tensor:
    """``need`` orthonormal columns orthogonal to the orthonormal ``done``
    (rows x p): Gaussian columns from the port's seeded generator, with
    ``done`` projected out twice and a QR whose R diagonal is made positive.
    The directions come from the seed, not from a factorization's
    rounding; random ones, because imaginary-time evolution can only grow
    along padding that overlaps the states it needs (unit vectors of the
    first rows ended 1.8e-4 off on the J = 0.2 chain below)."""
    z = _randn(gen, (done.shape[0], need), done.dtype)
    for _ in range(2):
        z = z - done @ (done.mH @ z)
    q, r = _qr(z)
    return q * torch.sgn(torch.diagonal(r))[None, :]


def _resolved_range(a: torch.Tensor, gen):
    """All ``min(rows, cols)`` left singular vectors of the block ``a`` and
    lam descending, with every singular value above the rounding of ``a``
    resolved and the exact zeros completed by :func:`_seeded_completion`.

    One Gram pass resolves a singular value only down to ~sqrt(eps) of the
    largest: the Gram squares it under its own rounding (eps |a|^2), so the
    1e-10-weight directions that ``expand_bond_dimension`` adds come out as
    rounding noise, as do the completions of the exact zeros.  Imaginary-time
    TDVP-PS grows along whatever directions the padding holds (exp(tau |H|)),
    and from noise it ended 8.1e-4 off the dense ensemble where a full SVD's
    padding ends 4.8e-6 off.  So the block is deflated by the resolved
    directions and factorized again until what is left is rounding.

    The result still depends on the seed (ROADMAP queue 3;
    ``padding_seed_probe.py``): on that chain seeds 0, 1 and 2 end 5.4e-6,
    1.5e-3 and 9.8e-6 off (2019, the default: 4.4e-6), while LAPACK's SVD
    ends 5.4e-6 off for each; LAPACK also resolves the singular values
    below eps |a| (1e-17 to 1e-27 here), and the cut orders the padding by
    them."""
    k = min(a.shape)
    finfo = torch.finfo(a.real.dtype)
    resolve = 16 * finfo.eps ** 0.5
    floor = 64 * finfo.eps * float(torch.linalg.matrix_norm(a))
    us, lams = [], []
    rest = a
    # a block of zeros, or a remainder at the rounding of ``a``, has nothing
    # left to resolve: one host read instead of a Gram
    while k > 0 and float(torch.linalg.matrix_norm(rest)) > floor:
        u, lam = _gram_pass(rest, k, 0, gen)
        if us:
            # rest lies in the complement up to the rounding of ``a``
            done = torch.cat(us, dim=1)
            u = u - done @ (done.mH @ u)
            q, r = _qr(u)
            u = q * torch.sgn(torch.diagonal(r))[None, :]
        sigma = np.sqrt(lam.cpu().numpy())
        if sigma[0] <= floor:
            break
        n_ok = max(1, int((sigma > resolve * sigma[0]).sum()))
        u = u[:, :n_ok]
        us.append(u)
        lams.append(lam[:n_ok])
        rest = rest - u @ (u.mH @ rest)
        k -= n_ok
    if k > 0:
        done = torch.cat(us, dim=1) if us else a[:, :0]
        us.append(_seeded_completion(done, k, gen))
        lams.append(torch.zeros(k, dtype=a.real.dtype, device=a.device))
    return torch.cat(us, dim=1), torch.cat(lams)


def _sector_candidates(cmat, lset, rset, l1, l2, transpose, want_v, gen,
                       resolve=False):
    """Per-sector candidates on the gathered block: returns candidates
    scattered into the full row space (rows = n if ``transpose`` else m),
    lam descending, and with ``want_v`` the matching right factor.  With
    ``resolve`` the block's whole range is factorized by
    :func:`_resolved_range` (``l1`` is then its rank and ``l2`` 0)."""
    m, n = cmat.shape
    dev = cmat.device
    gr = torch.as_tensor(lset, device=dev)
    gc = torch.as_tensor(rset, device=dev)
    block = cmat[gr][:, gc]
    a = block.T if transpose else block
    if resolve:
        u, lam = _resolved_range(a, gen)
    else:
        u, lam = _gram_pass(a, l1, l2, gen)
    rows_out = n if transpose else m
    out = torch.zeros((rows_out, l1 + l2), dtype=cmat.dtype, device=dev)
    out[gc if transpose else gr] = u
    if not want_v:
        return out, lam, None
    # right factor: A^H U = V diag(sigma) up to column phases; QR makes the
    # zero-sigma columns proper orthonormal completions and the phase of
    # R's diagonal restores the U <-> V pairing
    t = a.mH @ u
    qv, rv = _qr(_colnormalize(t))
    d = torch.diagonal(rv)
    tiny = torch.finfo(lam.dtype).tiny
    phase = torch.where(d.abs() > tiny, d / torch.clamp(d.abs(), min=tiny),
                        torch.ones_like(d))
    vmat = qv * phase[None, :]
    out_v = torch.zeros((m if transpose else n, l1 + l2), dtype=cmat.dtype,
                        device=dev)
    out_v[gr if transpose else gc] = vmat
    return out, lam, out_v


def candidates(coef_array, qnbigl, qnbigr, qntot, system: str, cap: int,
               want_complement: bool, want_v: bool = False,
               resolve: bool = False):
    """Truncation candidates of the coefficient ``coef_array``.

    Returns ``(parts, sigma, qn_list)`` — plus ``parts_v`` with ``want_v`` —
    where ``parts`` are device matrices (rows x slots, sector-major,
    scattered into the full row space of the kept side), ``sigma`` the host
    candidate singular values (-1 marks unselectable slots) and ``qn_list``
    the per-slot quantum numbers.  Without complement or right factor all
    sectors run as one masked batch with one eigensolver launch; otherwise
    each sector runs on its gathered block."""
    qntot = np.atleast_1d(np.asarray(qntot))
    qn_size = len(qntot)
    localqnl = np.asarray(qnbigl).reshape(-1, qn_size)
    localqnr = np.asarray(qnbigr).reshape(-1, qn_size)
    m, n = len(localqnl), len(localqnr)
    sectors = _sector_indices(localqnl, localqnr, qntot)
    if len(sectors) == 0:
        raise ValueError("Invalid quantum number")
    cmat = backend.tensor(coef_array).reshape(m, n)
    transpose = system == "R"
    gen = backend.generator()

    def label(nl):
        return tuple(nl) if not transpose else tuple(qntot - nl)

    secs = [s for s in sectors if min(len(s[1]), len(s[2])) > 0]
    # pad the sector axis to a multiple of 2, as the JAX package does; a pad
    # slot has all-zero masks and l1_real = 0, so it reports only sentinels
    nsec_p = -(-len(secs) // 2) * 2
    itemsize = cmat.element_size()
    if (not want_complement and not want_v
            and nsec_p * m * n * itemsize <= MASK_BUDGET):
        l1p = min(min(m, n), cap + OVERSAMPLE)
        mask_r = np.zeros((nsec_p, m), dtype=bool)
        mask_c = np.zeros((nsec_p, n), dtype=bool)
        l1_b = np.zeros(nsec_p, dtype=np.int64)
        qn_list: List[tuple] = []
        for i in range(nsec_p):
            if i >= len(secs):
                qn_list.extend([qn_list[-1]] * l1p)
                continue
            nl, lset, rset = secs[i]
            mask_r[i, lset] = True
            mask_c[i, rset] = True
            l1_b[i] = min(len(lset), len(rset), l1p)
            qn_list.extend([label(nl)] * l1p)
        mr = backend.tensor(mask_r)
        mc = backend.tensor(mask_c)
        block = cmat[None] * (mr[:, :, None] & mc[:, None, :]).to(cmat.dtype)
        a = block.mT if transpose else block
        vals, lam = _candidate_core(a, mc if transpose else mr,
                                    backend.tensor(l1_b), l1p, gen)
        # (nsec, rows_out, l1p) -> (rows_out, nsec*l1p), sector-major
        out = vals.permute(1, 0, 2).reshape(vals.shape[1], nsec_p * l1p)
        return [out], lam_to_sigma(lam.reshape(-1)), qn_list

    parts, parts_v, lams = [], [], []
    qn_list = []
    for nl, lset, rset in secs:
        rank = min(len(lset), len(rset))
        l1 = min(rank, cap + OVERSAMPLE)
        rows = len(rset) if transpose else len(lset)
        l2 = min(max(rows - l1, 0), cap) if want_complement else 0
        if want_v:
            # complement candidates beyond the b-side have no right factor
            assert l2 == 0
        out, lam, out_v = _sector_candidates(cmat, lset, rset, l1, l2,
                                             transpose, want_v, gen, resolve)
        parts.append(out)
        parts_v.append(out_v)
        lams.append(lam)
        qn_list.extend([label(nl)] * (l1 + l2))
    # ONE small synchronous fetch: all candidate spectra at once
    sigma = lam_to_sigma(torch.cat(lams))
    if want_v:
        return parts, sigma, qn_list, parts_v
    return parts, sigma, qn_list


def apply_selection(coef_array, parts, sidx, m: int, n: int, system: str,
                    lshape: tuple = None, rshape: tuple = None):
    """Gather the selected candidate columns and rotate the complement.

    With ``lshape``/``rshape`` (the qnbig free-leg shapes) the returned
    tensors are the chain's site tensors: to_right ``(lshape + (M,),
    (M,) + rshape)``, to_left ``((M,) + rshape, lshape + (M,))``.  Without
    them, flat matrices: to_right ``ms`` (m, M) and ``comp = ms^H C``
    (M, n); to_left ``ms`` (n, M) (Vset convention, i.e. conj(V)) and
    ``comp = C conj(ms)`` (m, M)."""
    cmat = backend.tensor(coef_array).reshape(m, n)
    u = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    ms = u[:, torch.as_tensor(np.asarray(sidx, dtype=np.int64), device=u.device)]
    transpose = system == "R"
    comp = cmat @ ms.conj() if transpose else ms.mH @ cmat
    if lshape is None:
        return ms, comp
    msdim = ms.shape[1]
    if transpose:
        site = torch.movedim(ms.reshape(tuple(rshape) + (msdim,)), -1, 0)
        compms = comp.reshape(tuple(lshape) + (msdim,))
    else:
        site = ms.reshape(tuple(lshape) + (msdim,))
        compms = comp.reshape((msdim,) + tuple(rshape))
    return site, compms


def _spread_zero_weight(sigma: np.ndarray, qn_list) -> np.ndarray:
    """Descending order of the candidates, with the zero-weight ones spread
    over the sectors: each next zero-weight slot goes to the sector with the
    most zero-weight candidates left (its room: min(rows, columns) of its
    block less its nonzero candidates and the slots already ahead of it),
    ties to the earlier sector.

    A cut through the zeros (the padding of ``expand_bond_dimension``) then
    keeps padding in every sector up to its room.  Ordered by the sort alone,
    the exact zeros of the Gram eigh stay in sector order and one sector
    takes all the padding: on a 2-molecule chain at its exact bond
    dimension the sum with the state then held 9 states of one sector where
    its rows allow 8, and the next canonicalisation dropped one (15 of 16)."""
    order = np.argsort(-sigma, kind="stable")
    zero = sigma[order] <= 0
    if not zero.any():
        return order
    labels = [tuple(np.atleast_1d(q)) for q in qn_list]
    queues = {}
    for i in order[zero]:
        queues.setdefault(labels[i], []).append(i)
    tail = []
    while len(tail) < int(zero.sum()):
        lab = max(queues, key=lambda lab: len(queues[lab]))
        tail.append(queues[lab].pop(0))
    return np.concatenate([order[~zero], np.array(tail, dtype=order.dtype)])


def compress_factors(coef_array, qnbigl, qnbigr, qntot, system: str,
                     resolve: bool = False):
    """Exact qn-blocked SVD factors, API-compatible with
    ``svd_qn(..., full_matrices=False)``: ``(u, sigma, qnl_list, v, sigma,
    qnr_list)`` sorted by descending singular value, with device ``u``/``v``
    and ``C = u diag(sigma) v^T``.  With ``resolve`` every sector's kept
    side comes from :func:`_resolved_range` (``compress``: the padding of
    ``expand_bond_dimension``); without it one Gram pass (the MU-VMF/CMF
    gauge factorizations, inside every right-hand side).  The gauge
    factorizations keep the one pass because through
    :func:`_resolved_range` MU-VMF stalled: one step of 1 a.u. of
    ``ChargeDiffusionDynamics`` on the 6-molecule bench chain at M=64 ran
    over 8 minutes on an H100 where one pass takes 6.5-7.9 s, and on a
    3-molecule chain at M=16 over 300 s on the CPU where one pass takes
    7.3 s (92 right-hand sides)."""
    qntot = np.atleast_1d(np.asarray(qntot))
    qn_size = len(qntot)
    m = int(np.asarray(qnbigl).reshape(-1, qn_size).shape[0])
    n = int(np.asarray(qnbigr).reshape(-1, qn_size).shape[0])
    parts, sigma, qn_kept, parts_v = candidates(
        coef_array, qnbigl, qnbigr, qntot, system, min(m, n),
        want_complement=False, want_v=True, resolve=resolve)
    order = _spread_zero_weight(sigma, qn_kept)
    sigma = sigma[order]
    sel = torch.as_tensor(order, device=parts[0].device)
    a_side = torch.cat(parts, dim=1)[:, sel]
    b_side = torch.cat(parts_v, dim=1)[:, sel]
    qn_sorted = [tuple(q) for q in np.asarray(qn_kept)[order]]
    qn_other = [tuple(qntot - np.asarray(q)) for q in qn_sorted]
    if system == "L":
        # C = a_side diag(sigma) b_side^H; host convention v = conj(V)
        return a_side, sigma, qn_sorted, b_side.conj(), sigma, qn_other
    # ran on C^T: a_side = conj(V_C), b_side = conj(U_C)
    return b_side.conj(), sigma, qn_other, a_side, sigma, qn_sorted


def qr_qn_device(coef_array, qnbigl, qnbigr, qntot, system: str):
    """qn-blocked economy QR (``system="L"``) or RQ (``"R"``),
    API-compatible with ``svd_qn.svd_qn(..., QR=True,
    full_matrices=False)``: returns ``(u, qnl_list, v, qnr_list)`` with
    device ``u`` (m, K) and ``v`` (n, K).  No host sync."""
    qntot = np.atleast_1d(np.asarray(qntot))
    qn_size = len(qntot)
    localqnl = np.asarray(qnbigl).reshape(-1, qn_size)
    localqnr = np.asarray(qnbigr).reshape(-1, qn_size)
    m, n = len(localqnl), len(localqnr)
    sectors = _sector_indices(localqnl, localqnr, qntot)
    if len(sectors) == 0:
        raise ValueError("Invalid quantum number")
    cmat = backend.tensor(coef_array).reshape(m, n)
    parts_u, parts_v = [], []
    qnl_list: List[tuple] = []
    qnr_list: List[tuple] = []
    for nl, lset, rset in sectors:
        gr = torch.as_tensor(lset, device=cmat.device)
        gc = torch.as_tensor(rset, device=cmat.device)
        block = cmat[gr][:, gc]
        k = min(len(lset), len(rset))
        if system == "R":
            # RQ via QR of the flipped transpose (same as the host path)
            q, r = _qr(block.flip(0, 1).T)
            pu, pv = r.flip(0, 1).T, q.flip(0, 1)
        else:
            q, r = _qr(block)
            pu, pv = q, r.T
        u_out = torch.zeros((m, k), dtype=cmat.dtype, device=cmat.device)
        v_out = torch.zeros((n, k), dtype=cmat.dtype, device=cmat.device)
        u_out[gr] = pu
        v_out[gc] = pv
        parts_u.append(u_out)
        parts_v.append(v_out)
        qnl_list.extend([tuple(nl)] * k)
        qnr_list.extend([tuple(qntot - nl)] * k)
    return torch.cat(parts_u, dim=1), qnl_list, torch.cat(parts_v, dim=1), qnr_list
