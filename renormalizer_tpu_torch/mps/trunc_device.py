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
``torch.linalg.eigh`` and is counted in ``trunc.linalg_eigh_grams``.  The
factorization of ``compress`` (``compress_factors`` with ``resolve``) is
not randomized: a full SVD of each sector block (``_resolved_range``,
counted in ``trunc.svd_blocks``).  The only device-to-host traffic per site
update is the candidate spectrum (a few KB) that the host-side selection
reads (``trunc.spectrum_reads``), and with ``fetch=False`` even that copy is
started without waiting (:class:`PendingSpectrum`): the asynchronous
static-plan selection of ``MatrixProduct._update_mps_device`` reads it one
visit later, or not at all.

Two routes compute the candidates.  Without complement or right factor,
while the batch fits :data:`MASK_BUDGET`, all sectors run as one batch of
blocks masked to the full (m, n) extent with one eigensolver launch
(:func:`_masked_batch`).  Otherwise each sector runs on its own gathered
block (:func:`_per_sector`).  Every index set and mask goes to the device
through the content-keyed cache :func:`_device_idx`.

With a global mesh over more than one distinct device
(``parallel.set_global_mesh``; :data:`PLACE_SECTORS`), an update of several
sectors skips the masked batch and places sector ``k`` on
``mesh.devices.flat[k % n]``: its
block, factorization and Gram eigh (the Jacobi kernel on that device) run
there, and the candidates, lambda and right factor come back to the
coefficient's device.  The sketches are drawn on that home device from the
update's one generator, in the same order as without placement, and then
moved, so placement on and off give bitwise equal results.  Such an update
has no slot layout, so the asynchronous static plan cannot arm on it (it
selects from the previous visit's spectrum or the current one).

Differences from the JAX package: the TPU-only 128-lane policies
(``align_l1p``/``pick_eigh``) are gone, so l1p = min(rank, cap + OVERSAMPLE);
there is no per-sector bucketed kernel (the per-sector path gathers each
block at its own extent: PyTorch compiles nothing per shape) and no
gather-batched path (above the mask budget the per-sector path was
1.5-2.6x faster on the H100: ``gather_probe.py``).  The JAX package's tuning
knobs are module constants here; only :func:`async_enabled` reads the
environment (at call time).  The JAX package's ``RENO_SECTOR_PARALLEL`` is
not read: whether to place follows from the mesh.

The counters live in ``utils.profiling.COUNTERS`` under ``trunc.``:
``linalg_eigh_grams`` (complex Grams sent to ``torch.linalg.eigh``, which
``chip_smoke.py`` reads beside ``jacobi.launches``), ``svd_blocks`` (sector
blocks factored by ``torch.linalg.svd`` in ``_resolved_range``: ``compress``
and OFS), ``spectrum_reads`` (host reads of a candidate spectrum, a blocking
fetch or the read of a :class:`PendingSpectrum`; a static-plan update reads
none; also readable as ``trunc_device.SPECTRUM_READS``), ``sketch_retries``
(sketched threshold updates whose saturation check failed, so
``MatrixProduct._update_mps_device`` computed exact candidates again),
``idx_cache.hits``/``.misses`` (:func:`_device_idx`), ``sectors_placed.<device>``
(sectors placed on each mesh device), ``plan.<path>`` (which selection path
each asynchronous site update took: ``static`` = plan-constrained, no
spectrum read; ``stale`` = the previous visit's spectrum, revalidations
included; ``sync`` = the current spectrum, read at once, its reason counted
in ``plan_sync.<reason>``; ``noarm`` = a selection that was not top-k per
sector, so the static path could not arm; the tree's ``tree_stale`` and
``tree_sync``).
"""

import hashlib
import logging
import os
from typing import List

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.mps.svd_qn import _sector_indices
from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
from renormalizer_tpu_torch.parallel.mesh import get_global_mesh
from renormalizer_tpu_torch.utils.profiling import COUNTERS, count_wait

logger = logging.getLogger(__name__)

OVERSAMPLE = 32
# Threshold-criteria truncations take exact (full-rank) candidates up to
# this rank; above it a sketch of SKETCH_CAP states, normalized by the
# exact ||C||_F and checked for saturation.
EXACT_CAP = 2048
SKETCH_CAP = 1024
# Byte budget for the one-launch masked sector batch's (nsec, m, n) blocks;
# larger updates run the per-sector path.
MASK_BUDGET = 256 * 2**20
# Every STATIC_REVALIDATE consecutive static selections of one plan
# (staggered per plan up to twice that; 0 never), re-derive the per-sector
# counts from the previous visit's spectrum, so drifting sector weights
# cannot freeze an early allocation.
STATIC_REVALIDATE = 24
# Relative kept-weight gain below which a revalidated selection keeps the
# plan's frozen counts.
HYSTERESIS_RTOL = 1e-6
# Self-check level of the device truncation (:func:`verify_update`): 0 off,
# 1 the orthonormality of the kept basis, 2 also its spectrum against
# LAPACK's SVD.  Each check reads the device.
VERIFY_LEVEL = 0

# Sector placement under a global mesh: None places the sectors of an
# update round-robin over the mesh's devices when it spans more than one
# distinct device (on a mesh that names one card several times placement
# buys no parallelism and would stop the static plan from arming); True
# places them on any mesh of several entries and False never.  Tests and
# ``chip_smoke.py`` set it with ``setattr``.
PLACE_SECTORS = None


def __getattr__(name):
    # the spectrum-read counter under its earlier module name
    if name == "SPECTRUM_READS":
        return COUNTERS["trunc.spectrum_reads"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def async_enabled() -> bool:
    """The asynchronous static-plan selection of fixed-M, percent-0 site
    updates (``RENO_ASYNC_TRUNC=1/0``; default on when the port runs on a
    CUDA device, off on the CPU, as the JAX package's accelerator test)."""
    flag = os.environ.get("RENO_ASYNC_TRUNC", "")
    if flag in ("0", "1"):
        return flag == "1"
    return backend.device.type == "cuda"


def _sector_devices():
    """The mesh's devices, flat, when the sectors are to be placed: by
    default while the global mesh spans more than one distinct device."""
    mesh = get_global_mesh()
    if mesh is None or PLACE_SECTORS is False:
        return None
    devices = list(mesh.devices.flat)
    wanted = len(devices) > 1 if PLACE_SECTORS else len(set(devices)) > 1
    return devices if wanted else None


_IDX_CACHE = {}


def _device_idx(arr: np.ndarray, device=None) -> torch.Tensor:
    """Device copy of a small host index or mask array, cached by content.
    Keyed by the raw bytes with shape, dtype and device, not by a hash: a
    64-bit collision would silently gather the wrong rows.  Callers must
    not write to the returned tensor."""
    arr = np.ascontiguousarray(arr)
    device = backend.device if device is None else torch.device(device)
    key = (arr.shape, arr.dtype.str, arr.tobytes(), str(device))
    hit = _IDX_CACHE.get(key)
    if hit is None:
        COUNTERS["trunc.idx_cache.misses"] += 1
        if len(_IDX_CACHE) > 4096:
            _IDX_CACHE.clear()
        hit = torch.as_tensor(arr.copy(), device=device)
        _IDX_CACHE[key] = hit
    else:
        COUNTERS["trunc.idx_cache.hits"] += 1
    return hit


def plan_pattern(qnbigl, qnbigr, qntot, cap: int, system: str) -> bytes:
    """Digest of what fixes an update's candidate layout, the key of an
    asynchronous selection plan: the super-block quantum numbers (as int64
    in C order, whatever route wrote them), qntot, cap and side."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(qnbigl, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(qnbigr, dtype=np.int64).tobytes())
    h.update(str((tuple(int(q) for q in np.atleast_1d(qntot)), cap,
                  system)).encode())
    return h.digest()


def frob_norm(arr) -> float:
    """Exact Frobenius norm of the coefficient, accumulated in double
    precision (one scalar read): it normalizes a sketched spectrum, whose
    tail the sketch misses.  In single precision the sum loses ~1e-7
    relative, which moves the threshold cut."""
    t = backend.tensor(arr)
    return float(torch.linalg.vector_norm(_double(t)))


class PendingSpectrum:
    """A device candidate spectrum (lambda) whose copy to the host has been
    started without waiting: into pinned memory with ``non_blocking=True``
    and a CUDA event on the card, a plain clone on the CPU.  The device
    tensor stays referenced until the event has fired; :meth:`sigma` waits
    for it before the buffer is read."""

    def __init__(self, lam: torch.Tensor):
        self.lam = lam
        if lam.is_cuda:
            self._host = torch.empty(lam.shape, dtype=lam.dtype, pin_memory=True)
            self._host.copy_(lam, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(lam.device))
        else:
            self._host = lam.detach().clone()
            self._event = None
        self._sigma = None

    def sigma(self) -> np.ndarray:
        """The host spectrum (sentinels at -1); the first call reads it."""
        if self._sigma is None:
            if self._event is not None:
                count_wait()
                self._event.synchronize()
                self._event = None
            self._sigma = lam_to_sigma(self._host.numpy())
            self.lam = None
            COUNTERS["trunc.spectrum_reads"] += 1
        return self._sigma


def _read_spectrum(lam: torch.Tensor) -> np.ndarray:
    """Blocking host read of a device spectrum (counted)."""
    COUNTERS["trunc.spectrum_reads"] += 1
    return lam_to_sigma(lam)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _randn(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Gaussian draws for ``device``, made on the generator's own device
    and moved: where a sector runs does not change its numbers."""
    # drawn in float32 and cast, as the JAX package draws its sketches
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device=device, dtype=dtype)


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
    if g.is_complex():
        n = 1 if g.ndim == 2 else g.shape[0]
        COUNTERS["trunc.linalg_eigh_grams"] += n
        w, v = torch.linalg.eigh(_double(g))
        if g.is_cuda:
            count_wait(n)  # cuSOLVER's own waits, which the sync debug mode misses
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

    omega = _randn(gen, (cols, l1p), dtype, a.device)
    y = _orth(a @ omega)
    y = a @ (a.mH @ y)
    yn = _colnormalize(y)
    # in-sector completion regularizer: below the numerical rank QR
    # completes with junk spread over ALL rows, including rows outside the
    # sector; a tiny in-sector component keeps every completion inside
    reg = _randn(gen, (rows, l1p), dtype, a.device)
    yn = yn + reg * (mask_col * finfo.eps ** 0.75)
    q = _orth(yn)
    # re-confine, replace fully-leaked columns with fresh in-sector random
    # columns, then re-orthonormalize by shifted CholeskyQR3
    q = q * mask_col
    colnorm2 = (q.abs() ** 2).sum(-2)                      # (B, l1p)
    reg2 = _randn(gen, (rows, l1p), dtype, a.device) * mask_col
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
    omega = _randn(gen, (rb, l1), a.dtype, a.device)
    y = _orth(a @ omega)
    y = a @ (a.mH @ y)
    if l2 > 0:
        y = torch.cat([y, _randn(gen, (ra, l2), a.dtype, a.device)], dim=1)
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
    No path of the package calls it since :func:`_resolved_range` became a
    full SVD; ``padding_seed_probe.py --factor svd-floor`` completes below a
    floor with it, to show how such padding moves with the seed."""
    z = _randn(gen, (done.shape[0], need), done.dtype, done.device)
    for _ in range(2):
        z = z - done @ (done.mH @ z)
    q, r = _qr(z)
    return q * torch.sgn(torch.diagonal(r))[None, :]


def _resolved_range(a: torch.Tensor, gen):
    """All ``min(rows, cols)`` left singular vectors of the block ``a`` and
    lam (the squared singular values) descending, from one SVD of the
    block in double precision on its own device (``torch.linalg.svd``:
    LAPACK on the CPU, cuSOLVER's ``gesvd`` on the card; why that driver is
    in :func:`compress_factors`).

    This is what the JAX package's ``svd_qn.svd_qn`` does on the host: a
    full SVD resolves the graded tail of a sector block far below eps |a|
    (1e-17 to 1e-27 of its norm on the expansion's padding), so the cut
    orders the padding across sectors by the data.  One Gram pass resolves
    a singular value only down to ~sqrt(eps) of the largest, and deflating
    by Gram passes down to 64 eps |a| with seeded completions below it made
    imaginary-time TDVP-PS from an expanded start end 4.4e-6 to 1.5e-3 off
    the dense ensemble depending on the seed (ROADMAP queue 3).  The SVD
    returns all ``min(rows, cols)`` columns, the exact zeros' included, so
    nothing is completed and ``gen`` is not drawn from."""
    COUNTERS["trunc.svd_blocks"] += 1
    u, s, _ = torch.linalg.svd(_double(a), full_matrices=False,
                               driver="gesvd" if a.is_cuda else None)
    if a.is_cuda:
        count_wait()  # cuSOLVER's own wait, which the sync debug mode misses
    return u.to(a.dtype), (s * s).to(a.real.dtype)


def _sector_candidates(cmat, lset, rset, l1, l2, transpose, want_v, gen,
                       resolve=False):
    """Per-sector candidates on the gathered block: returns candidates
    scattered into the full row space (rows = n if ``transpose`` else m),
    lam descending, and with ``want_v`` the matching right factor.  With
    ``resolve`` the block's whole range is factorized by
    :func:`_resolved_range` (``l1`` is then its rank and ``l2`` 0)."""
    m, n = cmat.shape
    dev = cmat.device
    gr = _device_idx(lset, dev)
    gc = _device_idx(rset, dev)
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


def _masked_batch(cmat, secs, cap, transpose, gen):
    """All sectors as one batch of full-extent blocks zeroed outside their
    sector: shapes depend only on (m, n), the padded sector count and the
    sketch width.  Returns (vals (nsec_p, rows_out, l1p), lam, l1p)."""
    m, n = cmat.shape
    nsec_p = -(-len(secs) // 2) * 2
    l1p = min(min(m, n), cap + OVERSAMPLE)
    mask_r = np.zeros((nsec_p, m), dtype=bool)
    mask_c = np.zeros((nsec_p, n), dtype=bool)
    l1_b = np.zeros(nsec_p, dtype=np.int64)
    for i, (_, lset, rset) in enumerate(secs):
        mask_r[i, lset] = True
        mask_c[i, rset] = True
        l1_b[i] = min(len(lset), len(rset), l1p)
    mr = _device_idx(mask_r, cmat.device)
    mc = _device_idx(mask_c, cmat.device)
    block = cmat[None] * (mr[:, :, None] & mc[:, None, :]).to(cmat.dtype)
    a = block.mT if transpose else block
    vals, lam = _candidate_core(a, mc if transpose else mr,
                                _device_idx(l1_b, cmat.device), l1p, gen)
    return vals, lam, l1p


def _per_sector(cmat, secs, cap, transpose, want_complement, want_v, gen,
                resolve=False, devices=None):
    """Each sector on its own gathered block (:func:`_sector_candidates`),
    sector ``k`` on ``devices[k % len(devices)]`` when given, its results
    brought back to ``cmat``'s device.  Returns the candidate parts, the
    right factors (``None`` each without ``want_v``), lam of all sectors
    concatenated and each sector's number of slots."""
    home = cmat.device
    cmat_on = {home: cmat}
    parts, parts_v, lams, widths = [], [], [], []
    for k, (_, lset, rset) in enumerate(secs):
        rank = min(len(lset), len(rset))
        l1 = min(rank, cap + OVERSAMPLE)
        rows = len(rset) if transpose else len(lset)
        l2 = min(max(rows - l1, 0), cap) if want_complement else 0
        if want_v:
            # complement candidates beyond the b-side have no right factor
            assert l2 == 0
        dev = home if devices is None else devices[k % len(devices)]
        if dev not in cmat_on:
            cmat_on[dev] = cmat.to(dev)
        if devices is not None:
            COUNTERS[f"trunc.sectors_placed.{dev}"] += 1
        out, lam, out_v = _sector_candidates(cmat_on[dev], lset, rset, l1, l2,
                                             transpose, want_v, gen, resolve)
        if dev != home:
            out, lam = out.to(home), lam.to(home)
            out_v = None if out_v is None else out_v.to(home)
        parts.append(out)
        parts_v.append(out_v)
        lams.append(lam)
        widths.append(l1 + l2)
    return parts, parts_v, torch.cat(lams), widths


def candidates(coef_array, qnbigl, qnbigr, qntot, system: str, cap: int,
               want_complement: bool, want_v: bool = False,
               resolve: bool = False, fetch: bool = True,
               return_layout: bool = False):
    """Truncation candidates of the coefficient ``coef_array``.

    Returns ``(parts, sigma, qn_list)`` — plus ``layout`` with
    ``return_layout``, plus ``parts_v`` with ``want_v`` — where ``parts``
    are device matrices (rows x slots, sector-major, scattered into the full
    row space of the kept side), ``sigma`` the host candidate singular
    values (-1 marks unselectable slots) and ``qn_list`` the per-slot
    quantum numbers.  With ``fetch=False`` the second element is instead a
    :class:`PendingSpectrum` of the device lambda = sigma^2, whose copy to
    the host has started and nothing waits for.

    Without complement, right factor or sector placement
    (:data:`PLACE_SECTORS` under a mesh), while ``nsec * m * n *
    itemsize`` fits :data:`MASK_BUDGET`, all sectors run as one masked
    batch with one eigensolver launch; otherwise each sector runs on its
    own gathered block, on its mesh device when placed.  ``layout`` is ``(nsec_padded, l1p)`` for the batch
    (sector-major, ``l1p`` slots a sector, each sector's slots by
    descending lambda with the sentinels last) and ``None`` for the
    per-sector path."""
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

    def spectrum(lam):
        return _read_spectrum(lam) if fetch else PendingSpectrum(lam)

    secs = [s for s in sectors if min(len(s[1]), len(s[2])) > 0]
    # several sectors under a mesh: placed one by one (the JAX package's
    # sector_devs skip its one-dispatch batch too)
    devices = _sector_devices() if len(secs) > 1 else None
    # the sector axis is padded to a multiple of 2, as the JAX package
    # does; a pad slot has all-zero masks and l1_real = 0, so it reports
    # only sentinels
    nsec_p = -(-len(secs) // 2) * 2
    if (devices is None and not want_complement and not want_v
            and nsec_p * m * n * cmat.element_size() <= MASK_BUDGET):
        vals, lam, l1p = _masked_batch(cmat, secs, cap, transpose, gen)
        qn_list: List[tuple] = []
        for nl, _, _ in secs:
            qn_list.extend([label(nl)] * l1p)
        qn_list.extend([qn_list[-1]] * (l1p * (nsec_p - len(secs))))
        # (nsec, rows_out, l1p) -> (rows_out, nsec*l1p), sector-major
        out = vals.permute(1, 0, 2).reshape(vals.shape[1], nsec_p * l1p)
        ret = ([out], spectrum(lam.reshape(-1)), qn_list)
        return ret + ((nsec_p, l1p),) if return_layout else ret

    parts, parts_v, lam, widths = _per_sector(cmat, secs, cap, transpose,
                                              want_complement, want_v, gen,
                                              resolve, devices)
    qn_list = [label(nl) for (nl, _, _), w in zip(secs, widths) for _ in range(w)]
    # ONE small fetch: all candidate spectra at once
    ret = (parts, spectrum(lam), qn_list)
    if return_layout:
        ret = ret + (None,)
    return ret + (parts_v,) if want_v else ret


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
    ms = u[:, _device_idx(np.asarray(sidx, dtype=np.int64), u.device)]
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
    side comes from :func:`_resolved_range`, a full SVD per sector block
    (``compress``: the padding of ``expand_bond_dimension``); without it
    one Gram pass (the MU-VMF/CMF gauge factorizations, inside every
    right-hand side).  The gauge factorizations keep the one pass, which
    keeps them on the Jacobi kernel: through the SVD one MU-VMF ThermalProp
    step of ``chip_smoke.py`` phase 10(d) took the same 122 right-hand sides
    to the same energy, in 34.10 and 32.95 s against the pass's 35.25 and
    25.22 s (``vmf_rhs_probe.py --gauge svd``, one call on an NVIDIA H100
    80GB HBM3 at 700 W).

    The SVD's driver on the card is cuSOLVER's ``gesvd``, which iterates to
    convergence (``gesvdj`` stops at a tolerance, ``gesvda`` is
    approximate).  With it, 10 imaginary-time TDVP-PS steps from the
    expanded 3-molecule, 3-level, J = 0.2 chain (``chip_smoke.py`` phase
    13(d)) end 6.700e-6 off the dense electron RDM at seeds 2019, 0, 1 and
    2 alike on an NVIDIA H100 80GB HBM3 at 700 W."""
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
        gr = _device_idx(lset, cmat.device)
        gc = _device_idx(rset, cmat.device)
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


def verify_update(ms_mat, coef_array, sigma, sidx, m, n, label="") -> bool:
    """With :data:`VERIFY_LEVEL` set, the kept basis ``ms_mat`` (rows x M) must be
    orthonormal (its violation makes DMRG energies dip below the
    variational minimum) and, at level 2, its spectrum ``sigma[sidx]`` must
    match LAPACK's SVD of the coefficient.  A failure is logged loudly and
    the run goes on; returns whether the update passed."""
    msh = ms_mat.detach().cpu().numpy()
    g = msh.conj().T @ msh
    err = float(np.abs(g - np.eye(g.shape[1])).max())
    tol = 1e-3 if msh.real.dtype.itemsize == 4 else 1e-8
    spec_err = 0.0
    if VERIFY_LEVEL >= 2:
        cm = backend.tensor(coef_array).detach().cpu().numpy().reshape(m, n)
        s_exact = np.linalg.svd(cm, compute_uv=False)
        kept = np.sort(np.asarray(sigma)[np.asarray(sidx, dtype=int)])[::-1]
        # complement slots (percent > 0) may keep more states than the rank
        s_exact = np.pad(s_exact, (0, max(len(kept) - len(s_exact), 0)))
        denom = max(s_exact[0], 1e-30)
        spec_err = float(np.abs(np.clip(kept, 0, None) - s_exact[:len(kept)]).max()
                         / denom)
    if err > tol or spec_err > 100 * tol:
        logger.error("TRUNC VERIFY FAIL %s: orth_err=%.3e spec_err=%.3e",
                     label, err, spec_err)
        return False
    return True
