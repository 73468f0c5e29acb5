r"""MatrixProduct: the shared container for MPS and MPO.

Port of the core of ``renormalizer_tpu/mps/mp.py``.  Site tensors are
tensors on the backend device; quantum-number bookkeeping (``qn`` per bond
with shape (dim, qn_size), the moving ``qnidx`` boundary, ``qntot`` and the
sweep direction ``to_right``) is host numpy since it only determines shapes
and masks.  Sweep decompositions run on the device
(``trunc_device.py``): a blockwise QR to move the canonical center and the
randomized sector-pure truncation in DMRG site updates, with the retained
basis selected on the host from the candidate spectrum.  On the card the
fixed-M, percent-0 updates select by the asynchronous static plan (no
spectrum read at steady state); a sketched threshold spectrum that fails
its saturation check is computed again exactly, on the device.  With
RENO_HOST_OFFLOAD site tensors far from the sweep center live in host
memory (``offload.py``).
"""

import hashlib
import logging
from typing import List

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.model import HolsteinModel, Model
from renormalizer_tpu_torch.mps import offload, svd_qn, trunc_device
from renormalizer_tpu_torch.mps.lib import Environ, select_basis, select_indices
from renormalizer_tpu_torch.mps.trunc_device import _double
from renormalizer_tpu_torch.mps.svd_qn import add_outer, get_qn_mask
from renormalizer_tpu_torch.ops.contract import chain_overlap, hop_expr, tensordot1
from renormalizer_tpu_torch.utils import OFS, CompressConfig, CompressCriteria
from renormalizer_tpu_torch.utils.utils import calc_vn_entropy, sizeof_fmt

logger = logging.getLogger(__name__)


def to_numpy(mt: torch.Tensor) -> np.ndarray:
    """A site tensor as a host array (a lazily conjugated tensor is
    resolved first)."""
    return mt.detach().resolve_conj().cpu().numpy()


def _content_digest(array):
    """128-bit digest of a host array's content, None for a device tensor
    (hashing one would read it back).  ``Mps.expectations`` keys its shared
    environments by it, so independently built identical MPO sites share
    them."""
    if not isinstance(array, np.ndarray):
        return None
    h = hashlib.blake2b(digest_size=16)
    h.update(str((array.shape, array.dtype.str)).encode())
    h.update(np.ascontiguousarray(array).tobytes())
    return h.digest()


def check_orthogonal(ms: torch.Tensor, left: bool, rtol=None, atol=None) -> bool:
    """Check left/right orthogonality of a site tensor."""
    rtol = rtol if rtol is not None else backend.canonical_rtol
    atol = atol if atol is not None else backend.canonical_atol
    if left:
        mat = ms.reshape(-1, ms.shape[-1])
        gram = mat.mH @ mat
    else:
        mat = ms.reshape(ms.shape[0], -1)
        gram = mat @ mat.mH
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    return bool(torch.allclose(gram, eye, rtol=rtol, atol=atol))


class MatrixProduct:
    def __init__(self):
        # NOTE: update `metacopy` when adding attributes
        self._mp: List = []
        # content digests of host-built site tensors (see ``_content_digest``)
        self._mt_hashes: List = []
        # indices of site tensors offloaded to host memory (RENO_HOST_OFFLOAD)
        self._cold_sites: set = set()
        # asynchronous selection plans: (cidx, direction) -> (qn pattern,
        # PendingSpectrum of the previous visit, frozen per-sector counts,
        # slot layout, static visits since the last revalidation)
        self._trunc_plans: dict = {}
        self.dtype = backend.real_dtype
        self.model: Model = None
        self.compress_config: CompressConfig = CompressConfig()
        # quantum number bookkeeping (host metadata)
        self.qn: List[np.ndarray] = []
        self.qnidx: int = None
        self.qntot: np.ndarray = None
        self.to_right: bool = None

    # --- IO ----------------------------------------------------------------
    @classmethod
    def load(cls, model: Model, fname: str):
        """Load an npz written by :meth:`dump` or by the JAX package's
        ``dump`` (protocol 0.4, which carries each bond's quantum numbers as
        a plain ``subqn_{i}`` array: nothing is unpickled)."""
        npload = np.load(fname)
        mp = cls()
        mp.model = model
        nsites = int(npload["nsites"])
        for i in range(nsites):
            mt = npload[f"mt_{i}"]
            mp.dtype = backend.complex_dtype if np.iscomplexobj(mt) else backend.real_dtype
            mp.append(mt)
        qn_size = np.atleast_1d(npload["qntot"]).size
        mp.qn = [npload[f"subqn_{i}"].astype(int).reshape(-1, qn_size)
                 for i in range(nsites + 1)]
        mp.qnidx = int(npload["qnidx"])
        mp.qntot = np.atleast_1d(npload["qntot"].astype(int))
        mp.to_right = bool(npload["to_right"])
        return mp

    def dump(self, fname, other_attrs=None):
        """npz dump, protocol "0.4" (reference ``mp.py:1085-1113``)."""
        if other_attrs is None:
            other_attrs = []
        elif isinstance(other_attrs, str):
            other_attrs = [other_attrs]
        data = {"version": "0.4", "nsites": self.site_num}
        for i, mt in enumerate(self):
            data[f"mt_{i}"] = to_numpy(mt)
        for attr in ["qnidx", "qntot", "to_right"] + other_attrs:
            data[attr] = getattr(self, attr)
        arr = np.empty(len(self.qn), object)
        arr[:] = [np.asarray(q) for q in self.qn]
        data["qn"] = arr
        for i, q in enumerate(self.qn):
            data[f"subqn_{i}"] = np.asarray(q)
        try:
            np.savez(fname, **data)
        except Exception:
            logger.exception("Dump MP failed.")

    @classmethod
    def from_mp(cls, model, mplist):
        """A chain of the given site tensors, with empty quantum numbers
        (as ``renormalizer_tpu/mps/mp.py:154``)."""
        mp = cls()
        mp.model = model
        if any(np.iscomplexobj(mt) if isinstance(mt, np.ndarray) else mt.is_complex()
               for mt in mplist):
            mp.dtype = backend.complex_dtype
        for mt in mplist:
            mp.append(mt)
        mp.build_empty_qn()
        return mp

    # --- basic properties ----------------------------------------------------
    @property
    def site_num(self):
        return len(self._mp)

    @property
    def threshold(self):
        return self.compress_config.threshold

    @threshold.setter
    def threshold(self, v):
        self.compress_config.threshold = v

    @property
    def is_complex(self):
        return self.dtype == backend.complex_dtype

    @property
    def is_mps(self):
        raise NotImplementedError

    @property
    def is_mpo(self):
        raise NotImplementedError

    @property
    def is_mpdm(self):
        raise NotImplementedError

    @property
    def bond_dims(self) -> List:
        if not self.site_num:
            return []
        return [int(mt.shape[0]) for mt in self] + [int(self[-1].shape[-1])]

    @property
    def bond_dims_mean(self) -> int:
        return int(round(np.mean(self.bond_dims)))

    @property
    def pbond_list(self):
        return self.model.pbond_list

    pbond_dims = pbond_list

    @property
    def bond_dims_exact(self) -> np.ndarray:
        """The largest bond dimensions an exact representation can need
        (an MPO or MpDm site has pbond^2 physical states)."""
        pbond = np.array(self.pbond_list, dtype=float)
        if self.is_mpo or self.is_mpdm:
            pbond = pbond ** 2
        with np.errstate(over="ignore"):
            dims1 = [1] + list(np.cumprod(pbond))
            dims2 = ([1] + list(np.cumprod(pbond[::-1])))[::-1]
        return np.minimum(dims1, dims2)

    @property
    def total_bytes(self):
        return sum(mt.numel() * mt.element_size() for mt in self)

    def _get_sigmaqn(self, idx):
        raise NotImplementedError

    def _pdim(self, idx):
        """physical dims of site idx as a tuple"""
        return tuple(self[idx].shape[1:-1])

    # --- qn bookkeeping ------------------------------------------------------
    def build_empty_qn(self):
        self.qntot = np.zeros(self.model.qn_size, dtype=int)
        if self.qnidx is None:
            self.qnidx = len(self) - 1
        self.qn = [
            np.zeros((dim, self.model.qn_size), dtype=int) for dim in self.bond_dims
        ]
        if self.to_right is None:
            self.to_right = False

    def build_none_qn(self):
        self.qntot = self.qnidx = self.qn = self.to_right = None

    def move_qnidx(self, dstidx: int):
        """Move the L/R quantum-number boundary (reference ``mp.py:159-172``)."""
        for idx in range(self.qnidx + 1, self.site_num + 1):
            self.qn[idx] = self.qntot - self.qn[idx]
        for idx in range(self.site_num, dstidx, -1):
            self.qn[idx] = self.qntot - self.qn[idx]
        self.qnidx = dstidx

    def _get_big_qn(self, cidx: List[int], swap=False):
        """Super-L/R-block quantum numbers around the active site(s)
        (reference ``mp.py:308-352``); ``swap`` takes the two sites' local
        quantum numbers in the other order (OFS)."""
        if len(cidx) == 2:
            cidx = sorted(cidx)
            assert cidx[0] + 1 == cidx[1]
        elif len(cidx) > 2:
            raise AssertionError
        assert self.qnidx in cidx

        sigmaqn = [np.array(self._get_sigmaqn(idx)) for idx in cidx]
        if swap:
            assert len(sigmaqn) == 2
            sigmaqn = sigmaqn[::-1]
        qnl = np.array(self.qn[cidx[0]])
        qnr = np.array(self.qn[cidx[-1] + 1])
        if len(cidx) == 1:
            if self.to_right:
                qnbigl, qnbigr = add_outer(qnl, sigmaqn[0]), qnr
            else:
                qnbigl, qnbigr = qnl, add_outer(sigmaqn[0], qnr)
        else:
            qnbigl = add_outer(qnl, sigmaqn[0])
            qnbigr = add_outer(sigmaqn[1], qnr)
        qnmat = add_outer(qnbigl, qnbigr)
        return qnbigl, qnbigr, qnmat

    # --- canonical form -------------------------------------------------------
    def check_left_canonical(self, rtol=None, atol=None):
        return all(check_orthogonal(self[i], True, rtol, atol) for i in range(len(self) - 1))

    def check_right_canonical(self, rtol=None, atol=None):
        return all(check_orthogonal(self[i], False, rtol, atol) for i in range(1, len(self)))

    @property
    def is_left_canonical(self):
        return self.qnidx == self.site_num - 1

    @property
    def is_right_canonical(self):
        return self.qnidx == 0

    def ensure_left_canonical(self, rtol=None, atol=None):
        if (
            self.to_right
            or self.qnidx != self.site_num - 1
            or (not self.check_left_canonical(rtol, atol))
        ):
            self.move_qnidx(0)
            self.to_right = True
            return self.canonicalise()
        return self

    def ensure_right_canonical(self, rtol=None, atol=None):
        if (
            (not self.to_right)
            or self.qnidx != 0
            or (not self.check_right_canonical(rtol, atol))
        ):
            self.move_qnidx(self.site_num - 1)
            self.to_right = False
            return self.canonicalise()
        return self

    def iter_idx_list(self, full: bool, stop_idx: int = None):
        """Site indices of a sweep in the current direction
        (reference ``mp.py:230-243``)."""
        if self.to_right:
            last = stop_idx if stop_idx is not None else (self.site_num if full else self.site_num - 1)
            return range(self.qnidx, last)
        last = stop_idx if stop_idx is not None else (-1 if full else 0)
        return range(self.qnidx, last, -1)

    def _switch_direction(self):
        assert self.to_right is not None
        if self.to_right:
            self.qnidx = self.site_num - 1
            self.to_right = False
        else:
            self.qnidx = 0
            self.to_right = True

    def _update_ms(self, idx, u, vt, sigma=None, qnlset=None, qnrset=None,
                   m_trunc=None):
        """Write the (truncated) factors back around site ``idx``
        (reference ``mp.py:245-295``).  Without ``sigma`` the factors come
        from a QR; with it (host singular values) from an SVD, and the
        retained weights go to the side the sweep moves to."""
        if m_trunc is None:
            m_trunc = u.shape[1]
        u = u[:, :m_trunc]
        vt = vt[:m_trunc, :]
        if sigma is None:
            if self.is_mpo:
                # keep MPO norms balanced across the bond
                if self.to_right:
                    norm = torch.linalg.norm(vt)
                    u, vt = u * norm, vt / norm
                else:
                    norm = torch.linalg.norm(u)
                    u, vt = u / norm, vt * norm
        else:
            sigma = backend.tensor(np.asarray(sigma[:m_trunc]), dtype=u.dtype)
            if self.is_mpo != self.to_right:
                vt = sigma[:, None] * vt
            else:
                u = u * sigma[None, :]
        pdim = list(self._pdim(idx))
        if self.to_right:
            self[idx + 1] = tensordot1(vt, self[idx + 1])
            self[idx] = u.reshape([u.shape[0] // int(np.prod(pdim))] + pdim + [m_trunc])
            if qnlset is not None:
                self.qn[idx + 1] = np.array(qnlset[:m_trunc])
                self.qnidx = idx + 1
        else:
            self[idx - 1] = tensordot1(self[idx - 1], u)
            self[idx] = vt.reshape([m_trunc] + pdim + [vt.shape[1] // int(np.prod(pdim))])
            if qnrset is not None:
                self.qn[idx] = np.array(qnrset[:m_trunc])
                self.qnidx = idx - 1
        self._offload_cold_sites(self.qnidx)

    def _push_cano(self, idx):
        """Move the canonical center across site ``idx`` by blockwise QR
        (reference ``mp.py:890-908``)."""
        qnbigl, qnbigr, _ = self._get_big_qn([idx])
        system = "L" if self.to_right else "R"
        u, qnlset, v, qnrset = trunc_device.qr_qn_device(
            self[idx], qnbigl, qnbigr, self.qntot, system
        )
        self._update_ms(idx, u, v.T, qnlset=qnlset, qnrset=qnrset)

    def canonicalise(self, stop_idx: int = None):
        if self.to_right:
            assert self.qnidx == 0
        else:
            assert self.qnidx == self.site_num - 1
        idx = self.qnidx
        for idx in self.iter_idx_list(full=False, stop_idx=stop_idx):
            self._push_cano(idx)
        if (not self.to_right and idx == 1) or (self.to_right and idx == self.site_num - 2):
            self._switch_direction()
        return self

    # --- compression ---------------------------------------------------------
    def compress(self, temp_m_trunc=None, ret_s=False):
        """SVD-compress a canonicalised MP (reference ``mp.py:437-511``).
        The qn-blocked factors come from the device factorization
        (:func:`trunc_device.compress_factors`: a full SVD of each sector
        block in double precision, as the JAX package's host ``svd_qn``);
        only the singular values travel to the host, where the cut is
        chosen."""
        if self.to_right:
            assert self.qnidx == 0
        else:
            assert self.qnidx == self.site_num - 1
        if self.compress_config.bonddim_should_set:
            self.compress_config.set_bonddim(len(self) + 1)
        system = "L" if self.to_right else "R"
        sz_before = self.total_bytes

        s_list = []
        for idx in self.iter_idx_list(full=False):
            qnbigl, qnbigr, _ = self._get_big_qn([idx])
            u, sigma, qnlset, v, _, qnrset = trunc_device.compress_factors(
                self[idx], qnbigl, qnbigr, self.qntot, system, resolve=True)
            s_list.append(sigma)
            if temp_m_trunc is None:
                m_trunc = self.compress_config.compute_m_trunc(sigma, idx, self.to_right)
            else:
                if isinstance(temp_m_trunc, (list, tuple, np.ndarray)):
                    m_trunc = temp_m_trunc[idx + 1 if self.to_right else idx]
                else:
                    m_trunc = temp_m_trunc
                m_trunc = int(min(m_trunc, len(sigma)))
            self._update_ms(idx, u, v.T, sigma, qnlset, qnrset, m_trunc)

        self._switch_direction()
        logger.debug(
            f"size before/after compress: {sizeof_fmt(sz_before)}/"
            f"{sizeof_fmt(self.total_bytes)}"
        )
        if not ret_s:
            return self
        max_len = max(len(s) for s in s_list)
        s_array = np.array([np.pad(np.asarray(s), (0, max_len - len(s))) for s in s_list])
        return self, s_array

    def variational_compress(self, mpo=None, guess=None):
        """Variational (sweeping-fit) compression of ``mpo @ self``
        (reference ``mp.py:514-649``): each site update applies the
        effective operator <guess| mpo |self> to the exact two-site (or
        one-site) tensor and truncates it into the guess; stops when two
        sweeps at ``percent == 0`` differ by less than ``vrtol``."""
        if mpo is None:
            raise NotImplementedError(
                "SVD compression is preferred for a standalone MP."
            )
        if guess is None:
            compressed_mpo = mpo.copy().canonicalise().compress(
                temp_m_trunc=self.compress_config.vguess_m[0]
            )
            compressed_mps = self.copy().canonicalise().compress(
                temp_m_trunc=self.compress_config.vguess_m[1]
            )
            guess = compressed_mpo.apply(compressed_mps)
        mps = guess
        mps.ensure_left_canonical()
        logger.info(f"initial guess bond dims: {mps.bond_dims}")
        procedure = mps.compress_config.vprocedure
        method = mps.compress_config.vmethod

        environ = Environ(self, mpo, "L", mps_conj=mps.conj())
        mps_old = None
        for isweep, (compress_config, percent) in enumerate(procedure):
            logger.debug(f"isweep: {isweep}, bond dims: {mps.bond_dims}")
            if isinstance(compress_config, CompressConfig):
                mps.compress_config = compress_config
            elif isinstance(compress_config, int):
                mps.compress_config = CompressConfig(
                    CompressCriteria.fixed, max_bonddim=compress_config
                )
            else:
                raise AssertionError

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

                mps_conj = mps.conj()
                ltensor = environ.GetLR("L", lidx, self, mpo, method=lmethod,
                                        mps_conj=mps_conj)
                rtensor = environ.GetLR("R", ridx, self, mpo, method=rmethod,
                                        mps_conj=mps_conj)

                qnbigl, qnbigr, qnmat = mps._get_big_qn(cidx)
                qn_mask = get_qn_mask(qnmat, mps.qntot)
                cmo = [mpo[i] for i in cidx]
                if method == "1site":
                    cms = self[cidx[0]]
                else:
                    cms = tensordot1(self[cidx[0]], self[cidx[1]])
                cout = hop_expr(ltensor, rtensor, cmo, cms.shape)(cms)
                cout = torch.where(backend.tensor(qn_mask), cout, 0)
                mps._update_mps(cout, cidx, qnbigl, qnbigr, percent)
                if mps.compress_config.ofs is not None:
                    raise NotImplementedError(
                        "OFS for variational compress not implemented"
                    )
            mps._switch_direction()

            if isweep > 0 and percent == 0 and mps_old is not None:
                error = mps.distance(mps_old) / np.sqrt(abs(mps.dot(mps.conj()).real))
                logger.info(f"Variational compress relative error: {error}")
                if error < mps.compress_config.vrtol:
                    logger.info("Variational compress is converged!")
                    break
            mps_old = mps.copy()
        else:
            logger.warning(
                "Variational compress is not converged! Please increase the procedure!"
            )
        mps.canonicalise()
        logger.info(f"{mps}")
        return mps

    # --- truncation ----------------------------------------------------------
    def _update_mps(self, cstruct, cidx, qnbigl, qnbigr, percent=0):
        """Truncate the active-site coefficient on the device and write the
        renormalized basis back (reference ``mp.py:651-888``).  A list of
        coefficients (state-averaged DMRG) diagonalizes their averaged
        density matrix instead, and returns each root's coefficient rotated
        into the new basis and merged with the neighbor (the next update's
        guesses)."""
        system = "L" if self.to_right else "R"
        if self.compress_config.bonddim_should_set:
            self.compress_config.set_bonddim(len(self) + 1)
        if isinstance(cstruct, list):
            return self._update_mps_averaged(cstruct, cidx, qnbigl, qnbigr,
                                             system, percent)
        if self.compress_config.ofs is not None:
            cstruct, qnbigl, qnbigr = self._ofs_select(cstruct, cidx, qnbigl,
                                                       qnbigr, system)
        ms, msdim, msqn, compms = self._update_mps_device(
            cstruct, cidx, qnbigl, qnbigr, system, percent)
        self._write_back(cidx, ms, msqn, compms)
        return None

    def _update_mps_averaged(self, cstruct, cidx, qnbigl, qnbigr, system,
                             percent):
        """The ``isinstance(cstruct, list)`` branch of the reference
        ``mp.py:594-642``: the sector blocks of the averaged density matrix
        go to ``svd_qn.eigh_qn`` (real blocks: the Jacobi kernel)."""
        nl = qnbigl.ndim - 1
        cstruct = [backend.tensor(c) for c in cstruct]
        ddm = 0.0
        for c in cstruct:
            ax = list(range(nl, c.ndim)) if self.to_right else list(range(nl))
            ddm = ddm + torch.tensordot(c, c.conj(), dims=(ax, ax))
        ddm = ddm / len(cstruct)
        u, s, qnnew = svd_qn.eigh_qn(ddm, qnbigl, qnbigr, self.qntot, system)
        m_trunc = self.compress_config.compute_m_trunc(
            s, cidx[0] if self.to_right else cidx[-1], self.to_right)
        ms, msdim, msqn, _ = select_basis(u, s, qnnew, None, m_trunc,
                                          percent=percent)
        if self.to_right:
            ms = ms.reshape(tuple(qnbigl.shape[:-1]) + (msdim,))
            rotated = [torch.tensordot(ms.conj(), c, dims=(list(range(nl)),) * 2)
                       for c in cstruct]
        else:
            nr = qnbigr.ndim - 1
            ms = ms.reshape(tuple(qnbigr.shape[:-1]) + (msdim,))
            rotated = [torch.tensordot(c, ms.conj(),
                                       dims=(list(range(nl, c.ndim)), list(range(nr))))
                       for c in cstruct]
            ms = torch.movedim(ms, -1, 0)
        return self._write_back(cidx, ms, msqn, rotated[0], rotated)

    def _update_mps_device(self, cstruct, cidx, qnbigl, qnbigr, system, percent):
        """Randomized sector-pure candidates on the device, the selection on
        the host from their spectrum, then the device gather and rotation.

        Fixed-M updates at percent 0 with :func:`trunc_device.async_enabled`
        select without waiting for the current spectrum (the JAX package's
        ``mp.py:643-872``): a plan per ``(cidx, direction)`` holds the
        quantum-number pattern of the previous visit, its spectrum (copied to
        the host meanwhile) and, once armed, the per-sector keep counts.  With
        the pattern and slot layout unchanged the update keeps the first k_i
        slots of each sector and reads no spectrum (static); every
        ``trunc_device.STATIC_REVALIDATE`` static visits (staggered per plan) it
        selects from the previous visit's spectrum (stale); on a miss it
        reads the current one (sync, reason in ``PLAN_STATS["sync_sites"]``).
        Threshold criteria take exact candidates up to
        ``trunc_device.EXACT_CAP`` and a sketch of ``trunc_device.SKETCH_CAP``
        above it, normalized by the exact ||C||_F; a sketch whose saturation
        check fails is replaced by exact candidates (counted in
        ``trunc_device.SKETCH_RETRIES``)."""
        m = int(np.prod(qnbigl.shape[:-1]))
        n = int(np.prod(qnbigr.shape[:-1]))
        bond_idx = cidx[0] if self.to_right else cidx[-1]
        fixed = self.compress_config.criteria is CompressCriteria.fixed
        sketched = False
        if fixed:
            cap = self.compress_config.compute_m_trunc(
                np.full(min(m, n), np.inf), bond_idx, self.to_right)
        else:
            # threshold criteria read the spectrum down to the cut: exact
            # candidates while cheap, a sketch checked for saturation above
            cap = min(m, n)
            if cap > trunc_device.EXACT_CAP:
                cap = trunc_device.SKETCH_CAP
                sketched = True
        use_async = fixed and percent == 0 and trunc_device.async_enabled()
        plan_key = (tuple(cidx), bool(self.to_right))
        pattern = (trunc_device.plan_pattern(qnbigl, qnbigr, self.qntot, cap, system)
                   if use_async else None)
        parts, lam, qn_list, layout = trunc_device.candidates(
            cstruct, qnbigl, qnbigr, self.qntot, system, cap,
            want_complement=(percent != 0), fetch=not use_async,
            return_layout=True)
        plan = None
        counts = None
        if use_async:
            sigma, counts, plan = self._plan_selection(plan_key, pattern, lam,
                                                       layout)
        else:
            sigma = lam
        if counts is not None:
            # static path: the first k_i slots of each sector
            l1p = layout[1]
            sidx = np.concatenate([np.arange(k, dtype=np.int64) + i * l1p
                                   for i, k in enumerate(counts) if k])
            return self._apply_selection(cstruct, parts, sidx, qn_list, m, n,
                                         qnbigl, qnbigr, system, lam, cidx)
        total_norm = None
        if sketched:
            # the exact ||C||_F, so the threshold normalizes against the
            # whole spectrum, not its sketched top
            total_norm = trunc_device.frob_norm(cstruct)
            thr_abs = self.compress_config.threshold * total_norm
            sat = trunc_device.OVERSAMPLE + cap
            by_qn = {}
            for q, s in zip(qn_list, sigma):
                if s >= 0:
                    cnt, smin = by_qn.get(q, (0, np.inf))
                    by_qn[q] = (cnt + 1, min(smin, s))
            if any(cnt >= sat and smin > thr_abs for cnt, smin in by_qn.values()):
                # a saturated sector never reached the cut: the sketch may
                # have missed kept states, so take exact candidates
                trunc_device.SKETCH_RETRIES += 1
                total_norm = None
                parts, sigma, qn_list = trunc_device.candidates(
                    cstruct, qnbigl, qnbigr, self.qntot, system, min(m, n),
                    want_complement=(percent != 0))
        # sentinel slots (sigma = -1) count toward neither the bond
        # dimension target nor the selection
        m_trunc = self.compress_config.compute_m_trunc(
            sigma[sigma >= 0], bond_idx, self.to_right, total_norm=total_norm)
        # canonical slot order (sector-major, lambda-descending per sector):
        # the static path emits this order, and the new bond's qn order
        # feeds the neighbour's pattern; ordered differently, every static
        # visit would flip the neighbour back to a sync visit
        sidx = sorted(select_indices(sigma, qn_list, m_trunc, percent))
        if (use_async and plan is not None and plan[2] is not None
                and plan[3] == layout):
            sidx = self._hysteresis(sidx, sigma, plan[2], layout)
        if use_async and layout is not None:
            self._arm_plan(plan_key, sidx, layout)
        return self._apply_selection(cstruct, parts, sidx, qn_list, m, n,
                                     qnbigl, qnbigr, system, sigma, cidx)

    def _plan_selection(self, plan_key, pattern, lam, layout):
        """The asynchronous update's choice of spectrum: returns (sigma or
        None, frozen counts or None, the previous plan) and stores this
        visit's plan (the new spectrum's copy is already under way)."""
        stats = trunc_device.PLAN_STATS
        plan = self._trunc_plans.get(plan_key)
        nvisit = plan[4] if plan is not None else 0
        revalidate = trunc_device.STATIC_REVALIDATE
        if revalidate:
            # stagger the revalidations: every plan arms in the same sweep,
            # so with one interval all would re-read in the same sweep
            revalidate += int.from_bytes(pattern[:2], "little") % revalidate
        sigma = counts = None
        if (plan is not None and plan[0] == pattern and plan[2] is not None
                and plan[3] == layout
                and not (revalidate and nvisit + 1 >= revalidate)):
            counts = plan[2]
            nvisit += 1
            stats["static"] += 1
        elif plan is not None and plan[0] == pattern:
            # the previous visit's spectrum, read on the host by now; also
            # the periodic revalidation of a static plan
            sigma = plan[1].sigma()
            nvisit = 0
            stats["stale"] += 1
        else:
            sigma = lam.sigma()
            nvisit = 0
            stats["sync"] += 1
            stats.setdefault("sync_sites", []).append(
                (plan_key,
                 "no-plan" if plan is None
                 else "pattern" if plan[0] != pattern
                 else "layout" if plan[3] != layout
                 else "unarmed"))
        self._trunc_plans[plan_key] = (pattern, lam, counts, layout, nvisit)
        return sigma, counts, plan

    @staticmethod
    def _hysteresis(sidx, sigma, counts, layout):
        """Keep the plan's frozen counts unless the fresh selection keeps
        materially more weight (relative gain above
        ``trunc_device.HYSTERESIS_RTOL``).  Tied splits would otherwise
        flip between visits.  The comparison is of kept weight, not of which
        slots were kept, and is gated by the layout, not by the pattern: a
        flip at one site changes the patterns downstream."""
        l1p = layout[1]
        old = sorted(i * l1p + k for i, cnt in enumerate(counts)
                     for k in range(cnt))
        if old == sidx or len(old) != len(sidx) or np.any(sigma[old] < 0):
            return sidx
        w = np.square(np.asarray(sigma, dtype=float))
        w_old = w[old].sum()
        gain = w[sidx].sum() - w_old
        if gain <= trunc_device.HYSTERESIS_RTOL * max(w_old, np.finfo(float).tiny):
            return old
        return sidx

    def _arm_plan(self, plan_key, sidx, layout):
        """Arm the static path for the next visit when the selection is the
        top k_i of each sector (no sentinel slot inside the kept range)."""
        l1p = layout[1]
        counts = [0] * layout[0]
        for i in sidx:
            counts[i // l1p] += 1
        if len(sidx) and all(i % l1p < counts[i // l1p] for i in sidx):
            plan = self._trunc_plans.get(plan_key)
            if plan is not None:
                self._trunc_plans[plan_key] = (plan[0], plan[1], tuple(counts),
                                               layout, plan[4])
        else:
            trunc_device.PLAN_STATS["noarm"] += 1

    def _apply_selection(self, cstruct, parts, sidx, qn_list, m, n, qnbigl,
                         qnbigr, system, sigma, cidx):
        """Gather the selected candidates and rotate the complement on the
        device; with ``trunc_device.VERIFY_LEVEL`` check the kept basis (a static
        update reads its current spectrum for that)."""
        msqn = np.array([qn_list[i] for i in sidx])
        ms, compms = trunc_device.apply_selection(
            cstruct, parts, sidx, m, n, system,
            lshape=qnbigl.shape[:-1], rshape=qnbigr.shape[:-1])
        msdim = len(sidx)
        if trunc_device.VERIFY_LEVEL:
            if isinstance(sigma, trunc_device.PendingSpectrum):
                sigma = sigma.sigma()
            ms_mat = (ms.reshape(m, msdim) if self.to_right
                      else torch.movedim(ms, 0, -1).reshape(n, msdim))
            trunc_device.verify_update(
                ms_mat, cstruct, sigma, sidx, m, n,
                label=f"cidx={cidx} to_right={self.to_right}")
        return ms, msdim, msqn, compms

    def _write_back(self, cidx, ms, msqn, compms, rotated=None):
        """Write the factors back into the chain.  With ``rotated`` (the
        state-averaged roots) returns each root merged like ``compms``."""
        averaged = [] if rotated is not None else None
        if len(cidx) == 1:
            self[cidx[0]] = ms
            if self.to_right:
                if cidx[0] != self.site_num - 1:
                    nxt = self[cidx[0] + 1]
                    self._merge_roots(averaged, rotated, lambda c: tensordot1(c, nxt))
                    self[cidx[0] + 1] = tensordot1(compms, nxt)
                    self.qn[cidx[0] + 1] = msqn
                    self.qnidx = cidx[0] + 1
                else:
                    cur = self[cidx[0]]
                    self._merge_roots(averaged, rotated, lambda c: tensordot1(cur, c))
                    self[cidx[0]] = tensordot1(cur, compms)
                    self.qnidx = self.site_num - 1
            else:
                if cidx[0] != 0:
                    prv = self[cidx[0] - 1]
                    self._merge_roots(averaged, rotated, lambda c: tensordot1(prv, c))
                    self[cidx[0] - 1] = tensordot1(prv, compms)
                    self.qn[cidx[0]] = msqn
                    self.qnidx = cidx[0] - 1
                else:
                    cur = self[cidx[0]]
                    self._merge_roots(averaged, rotated, lambda c: tensordot1(c, cur))
                    self[cidx[0]] = tensordot1(compms, cur)
                    self.qnidx = 0
        else:
            if self.to_right:
                self[cidx[0]] = ms
                self[cidx[1]] = compms
                self.qnidx = cidx[1]
            else:
                self[cidx[1]] = ms
                self[cidx[0]] = compms
                self.qnidx = cidx[0]
            if rotated is not None:
                averaged = rotated
            self.qn[cidx[1]] = msqn
        self._offload_cold_sites(self.qnidx)
        return averaged

    @staticmethod
    def _merge_roots(averaged, rotated, merge):
        if rotated is not None:
            averaged.extend(merge(c) for c in rotated)

    def _ofs_select(self, cstruct, cidx, qnbigl, qnbigr, system):
        """On-the-fly swapping (reference ``mp.py:696-757``): compare the
        two-site coefficient in the current and in the swapped order of the
        two DoFs by entanglement entropy and/or discarded weight; on a swap
        the model's basis order changes.  Returns the coefficient and the
        super-block quantum numbers of the order kept.

        Both orders' singular values come from the factorization of
        ``compress`` (:func:`trunc_device.compress_factors`, a full SVD per
        sector block on the device); the JAX package takes them from the
        host ``svd_qn``.  The kept order is then truncated as any update."""
        if isinstance(self.model, HolsteinModel):
            raise NotImplementedError("Can't perform OFS on Holstein model")

        def sigma(c, ql, qr):
            return trunc_device.compress_factors(c, ql, qr, self.qntot, system,
                                                 resolve=True)[1]

        qnbigl2, qnbigr2, _ = self._get_big_qn(cidx, swap=True)
        c = backend.tensor(cstruct)
        if c.ndim == 4:
            cstruct2 = c.permute(0, 2, 1, 3)
        else:
            assert c.ndim == 6
            cstruct2 = c.permute(0, 3, 4, 1, 2, 5)
        cstruct2 = cstruct2.contiguous()
        if self.compress_config.ofs_swap_jw:
            assert cstruct2.ndim == 4
            cstruct2[:, 1, 1, :] *= -1
        s1 = np.clip(sigma(c, qnbigl, qnbigr), 0, None)
        s2 = np.clip(sigma(cstruct2, qnbigl2, qnbigr2), 0, None)
        entropy1 = calc_vn_entropy(s1 ** 2)
        entropy2 = calc_vn_entropy(s2 ** 2)
        assert self.compress_config.criteria == CompressCriteria.fixed
        m_max = self.compress_config.bond_dim_max_value
        loss1 = float((np.sort(s1)[::-1][m_max:] ** 2).sum())
        loss2 = float((np.sort(s2)[::-1][m_max:] ** 2).sum())
        ofs = self.compress_config.ofs
        if ofs is OFS.ofs_d:
            retain = loss1 <= loss2
        elif ofs is OFS.ofs_ds:
            retain = (entropy1 <= entropy2 if (loss1 < 1e-10 and loss2 < 1e-10)
                      else loss1 <= loss2)
        elif ofs is OFS.ofs_s:
            retain = entropy1 <= entropy2
        else:
            assert ofs is OFS.ofs_debug
            retain = True
        logger.debug(
            f"OFS: site index {cidx}, should swap: {not retain}, "
            f"S: {entropy1}, {entropy2}, loss: {loss1}, {loss2}"
        )
        if retain:
            return c, qnbigl, qnbigr
        new_basis = self.model.basis.copy()
        new_basis[cidx[0]:cidx[1] + 1] = reversed(self.model.basis[cidx[0]:cidx[1] + 1])
        self.model = Model(new_basis, self.model.ham_terms, self.model.dipole,
                           self.model.output_ordering)
        logger.debug(f"DOF ordering: {[b.dof for b in self.model.basis]}")
        return cstruct2, qnbigl2, qnbigr2

    # --- algebra -----------------------------------------------------------------
    @property
    def mp_norm(self) -> float:
        """The norm, from an overlap taken in double precision: the
        adaptive RK's error estimate is the norm of a sum of stages that
        cancel, as in :meth:`distance`."""
        wide = [_double(mt) for mt in self]
        res = chain_overlap(wide, wide, conj_first=True).real
        if res < 0:
            assert np.abs(res) < 1e-8
            res = 0
        return float(np.sqrt(res))

    def add(self, other: "MatrixProduct"):
        """Direct (block-diagonal) sum of two MPs (reference ``mp.py:374-435``)."""
        assert np.all(self.qntot == other.qntot)
        assert self.site_num == other.site_num

        new_mps = self.metacopy()
        if other.is_complex or self.is_complex:
            new_mps.dtype = backend.complex_dtype
        new_mps.compress_config.update(self.compress_config)
        dtype = new_mps.dtype

        # the bond legs are the first and the last, for MPS and MPO alike
        new_mps[0] = torch.cat([self[0].to(dtype), other[0].to(dtype)], dim=-1)
        for i in range(1, self.site_num - 1):
            mta, mtb = self[i], other[i]
            assert mta.shape[1:-1] == mtb.shape[1:-1]
            new_ms = torch.zeros(
                (mta.shape[0] + mtb.shape[0],) + tuple(mta.shape[1:-1])
                + (mta.shape[-1] + mtb.shape[-1],),
                dtype=dtype, device=mta.device)
            new_ms[: mta.shape[0], ..., : mta.shape[-1]] = mta
            new_ms[mta.shape[0]:, ..., mta.shape[-1]:] = mtb
            new_mps[i] = new_ms
        new_mps[-1] = torch.cat([self[-1].to(dtype), other[-1].to(dtype)], dim=0)

        new_mps.move_qnidx(other.qnidx)
        new_mps.to_right = other.to_right
        new_mps.qn = [
            np.concatenate([np.asarray(q1), np.asarray(q2)])
            for q1, q2 in zip(self.qn, other.qn)
        ]
        new_mps.qn[0] = np.zeros((1, new_mps.qn[0].shape[1]), dtype=int)
        new_mps.qn[-1] = np.zeros((1, new_mps.qn[0].shape[1]), dtype=int)
        return new_mps

    def dot(self, other: "MatrixProduct") -> complex:
        """Overlap <self*|other> with both taken as-is
        (reference ``mp.py:933-956``)."""
        assert len(self) == len(other)
        return chain_overlap(list(self), list(other))

    def dot_ob(self, other: "MatrixProduct") -> torch.Tensor:
        """Open-boundary overlap of chains whose edge bonds may exceed 1
        (reference ``mp.py:958-979``): a (l_self, l_other, r_self, r_other)
        tensor."""
        assert len(self) == len(other)
        dtype = torch.promote_types(self[0].dtype, other[0].dtype)
        eye = lambda n: torch.eye(n, dtype=dtype, device=self[0].device)
        e0 = torch.tensordot(eye(self[0].shape[0]), eye(other[0].shape[0]),
                             dims=0).permute(0, 2, 1, 3)
        for mt1, mt2 in zip(self, other):
            e0 = torch.tensordot(e0, mt2.to(dtype), dims=1)
            if mt1.ndim == 3:
                e0 = torch.tensordot(e0, mt1.to(dtype), dims=([2, 3], [0, 1]))
            elif mt1.ndim == 4:
                e0 = torch.tensordot(e0, mt1.to(dtype), dims=([2, 3, 4], [0, 1, 2]))
            else:
                raise AssertionError
            e0 = e0.permute(0, 1, 3, 2)
        return e0

    def angle(self, other):
        return abs(self.conj().dot(other))

    def scale(self, val, inplace=False):
        new_mp = self if inplace else self.copy()
        if np.iscomplex(val):
            new_mp.to_complex(inplace=True)
        else:
            val = val.real
        new_mp[self.qnidx] = new_mp[self.qnidx] * val
        return new_mp

    def conj(self):
        new_mp = self.metacopy()
        for idx, mt in enumerate(self):
            new_mp[idx] = mt.conj()
        return new_mp

    def to_complex(self, inplace=False):
        new_mp = self if inplace else self.metacopy()
        new_mp.dtype = backend.complex_dtype
        for i, mt in enumerate(self):
            if mt is None:
                continue
            new_mp[i] = mt.to(backend.complex_dtype)
        return new_mp

    def distance(self, other) -> float:
        """||self - other|| from three overlaps, taken in double precision:
        l1 + l2 - 2 Re l12 cancels, and in single precision its rounding
        (~eps l1) is a distance of ~sqrt(eps) = 3e-4 of the norm, the size
        of the errors that the adaptive steppers read from it (P&C's
        order-(n-1) against order-n sum, TDVP's step doubling): on an H100
        the adaptive P&C of ``chip_smoke.py`` phase 8(d) then took steps
        with 3e-4 of error against its 5e-4 tolerance."""
        a = [_double(mt) for mt in self]
        b = [_double(mt) for mt in other]
        l1 = chain_overlap(a, a, conj_first=True)
        l2 = chain_overlap(b, b, conj_first=True)
        l1dotl2 = chain_overlap(a, b, conj_first=True)
        d2 = (l1 + l2 - l1dotl2 - l1dotl2.conjugate()).real
        if d2 < 0:
            assert d2 / l1.real < 1e-8
            return 0.0
        return float(np.sqrt(d2))

    def copy(self):
        new = self.metacopy()
        for i in range(self.site_num):
            new[i] = self[i]
        new._mt_hashes = list(self._mt_hashes)
        return new

    def metacopy(self) -> "MatrixProduct":
        new = self.__class__.__new__(self.__class__)
        new._mp = [None] * len(self)
        new.dtype = self.dtype
        new.model = self.model.copy()
        new.compress_config = self.compress_config.copy()
        new.qn = [np.asarray(q).copy() for q in self.qn]
        new.qnidx = self.qnidx
        new.qntot = None if self.qntot is None else np.asarray(self.qntot).copy()
        new.to_right = self.to_right
        new._mt_hashes = [None] * len(self)
        new._cold_sites = set()
        new._trunc_plans = {}
        return new

    def build_empty_mp(self, num):
        self._mp = [None] * num
        self._mt_hashes = [None] * num

    # --- container protocol -------------------------------------------------------
    def _as_site(self, array) -> torch.Tensor:
        if isinstance(array, np.ndarray):
            # host tensors are converted at the working precision first, as
            # the JAX package uploads them
            array = array.astype(np_dtype(self.dtype), copy=False)
        return backend.tensor(array, dtype=self.dtype)

    def append(self, array):
        mt = self._as_site(array)
        if len(self._mp) != 0:
            assert mt.shape[0] == self._mp[-1].shape[-1]
        self._mp.append(mt)
        self._mt_hashes.append(_content_digest(array))

    def __getitem__(self, item):
        if isinstance(item, slice):
            return [self[i] for i in range(*item.indices(len(self._mp)))]
        if self._cold_sites:
            idx = item if item >= 0 else item + len(self._mp)
            if idx in self._cold_sites:
                self._mp[idx] = offload.to_device(self._mp[idx])
                self._cold_sites.discard(idx)
        return self._mp[item]

    def _offload_cold_sites(self, center: int):
        """Move the site tensors farther than ``offload.hot_window()`` sites
        from the sweep center to host memory (RENO_HOST_OFFLOAD; the
        reference offloads to disk, ``mp.py:1047-1080``).  Only tensors of at
        least ``compress_config.dump_matrix_size`` bytes move (4 MiB when
        that knob is left at inf); :meth:`__getitem__` and :meth:`__iter__`
        bring them back."""
        window = offload.hot_window()
        if not window:
            return
        threshold = self.compress_config.dump_matrix_size
        if not np.isfinite(threshold):
            threshold = 4 << 20
        for i, mt in enumerate(self._mp):
            if mt is None or abs(i - center) <= window or i in self._cold_sites:
                continue
            if mt.numel() * mt.element_size() >= threshold:
                self._mp[i] = offload.to_host(mt)
                self._cold_sites.add(i)

    def __setitem__(self, key, array):
        mt = self._as_site(array)
        if mt.shape[1] != self.pbond_list[key if key >= 0 else key + self.site_num]:
            raise ValueError(
                "Matrix physical bond dimension does not match system information"
            )
        self._mp[key] = mt
        idx = key if key >= 0 else key + self.site_num
        self._cold_sites.discard(idx)
        if len(self._mt_hashes) <= idx:
            self._mt_hashes.extend([None] * (idx + 1 - len(self._mt_hashes)))
        self._mt_hashes[idx] = _content_digest(array)

    def __iter__(self):
        # cold sites are restored, as by __getitem__, never handed out
        if not self._cold_sites:
            return iter(self._mp)
        return (self[i] for i in range(len(self._mp)))

    def __len__(self):
        return len(self._mp)

    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other):
        return self.add(other.scale(-1))

    def __mul__(self, other):
        assert isinstance(other, (float, complex))
        return self.scale(other)

    __rmul__ = __mul__

    def __eq__(self, other):
        """Site by site: the same shapes and ``allclose`` entries (rtol
        1e-5, atol 1e-8, numpy's defaults), compared on the first operand's
        device in the wider dtype.  Unlike the JAX package, whose ``zip``
        stops at the shorter one, states of different lengths differ.
        Defining ``__eq__`` makes the class unhashable, as in the JAX
        package."""
        if not isinstance(other, MatrixProduct):
            return NotImplemented
        if len(self) != len(other):
            return False
        for m1, m2 in zip(self, other):
            if m1.shape != m2.shape:
                return False
            dtype = torch.promote_types(m1.dtype, m2.dtype)
            if not torch.allclose(m1.to(dtype), m2.to(device=m1.device, dtype=dtype),
                                  rtol=1e-5, atol=1e-8):
                return False
        return True

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self):
        return "%s with %d sites" % (self.__class__, len(self))

    def __str__(self):
        kind = "mps" if self.is_mps else "mpo" if self.is_mpo else "mpdm"
        return "{} current size: {}, Matrix product bond dim:{}".format(
            kind, sizeof_fmt(self.total_bytes), self.bond_dims)
