r"""MatrixProduct: the shared container for MPS and MPO.

Port of the core of ``renormalizer_tpu/mps/mp.py``.  Site tensors are
tensors on the backend device; quantum-number bookkeeping (``qn`` per bond
with shape (dim, qn_size), the moving ``qnidx`` boundary, ``qntot`` and the
sweep direction ``to_right``) is host numpy since it only determines shapes
and masks.  Sweep decompositions run on the device
(``trunc_device.py``): a blockwise QR to move the canonical center and the
randomized sector-pure truncation in DMRG site updates, with the retained
basis selected on the host from the candidate spectrum of the current
update (one small fetch per update).
"""

import hashlib
import logging
from typing import List

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps import svd_qn, trunc_device
from renormalizer_tpu_torch.mps.lib import select_basis, select_indices
from renormalizer_tpu_torch.mps.trunc_device import _double
from renormalizer_tpu_torch.mps.svd_qn import add_outer
from renormalizer_tpu_torch.ops.contract import chain_overlap, tensordot1
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria
from renormalizer_tpu_torch.utils.utils import sizeof_fmt

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

    def move_qnidx(self, dstidx: int):
        """Move the L/R quantum-number boundary (reference ``mp.py:159-172``)."""
        for idx in range(self.qnidx + 1, self.site_num + 1):
            self.qn[idx] = self.qntot - self.qn[idx]
        for idx in range(self.site_num, dstidx, -1):
            self.qn[idx] = self.qntot - self.qn[idx]
        self.qnidx = dstidx

    def _get_big_qn(self, cidx: List[int]):
        """Super-L/R-block quantum numbers around the active site(s)
        (reference ``mp.py:308-352``)."""
        if len(cidx) == 2:
            cidx = sorted(cidx)
            assert cidx[0] + 1 == cidx[1]
        elif len(cidx) > 2:
            raise AssertionError
        assert self.qnidx in cidx

        sigmaqn = [np.array(self._get_sigmaqn(idx)) for idx in cidx]
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
        (:func:`trunc_device.compress_factors`, exact at every size, with
        the small singular values resolved and the exact zeros completed by
        seeded random directions); only the singular values travel to the
        host, where the cut is chosen."""
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
        """Randomized sector-pure candidates on the device, selection on the
        host from the current update's candidate spectrum (one small
        synchronous fetch), then the device gather and rotation."""
        m = int(np.prod(qnbigl.shape[:-1]))
        n = int(np.prod(qnbigr.shape[:-1]))
        bond_idx = cidx[0] if self.to_right else cidx[-1]
        if self.compress_config.criteria is CompressCriteria.fixed:
            cap = self.compress_config.compute_m_trunc(
                np.full(min(m, n), np.inf), bond_idx, self.to_right)
        else:
            # threshold criteria read the spectrum down to the cut: exact
            # (full-rank) candidates
            cap = min(m, n)
        parts, sigma, qn_list = trunc_device.candidates(
            cstruct, qnbigl, qnbigr, self.qntot, system, cap,
            want_complement=(percent != 0))
        # sentinel slots (sigma = -1) count toward neither the bond
        # dimension target nor the selection
        m_trunc = self.compress_config.compute_m_trunc(
            sigma[sigma >= 0], bond_idx, self.to_right)
        # canonical slot order: sector-major, lambda-descending per sector
        sidx = sorted(select_indices(sigma, qn_list, m_trunc, percent))
        msqn = np.array([qn_list[i] for i in sidx])
        ms, compms = trunc_device.apply_selection(
            cstruct, parts, sidx, m, n, system,
            lshape=qnbigl.shape[:-1], rshape=qnbigr.shape[:-1],
        )
        return ms, len(sidx), msqn, compms

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
        return averaged

    @staticmethod
    def _merge_roots(averaged, rotated, merge):
        if rotated is not None:
            averaged.extend(merge(c) for c in rotated)

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
        return self._mp[item]

    def __setitem__(self, key, array):
        mt = self._as_site(array)
        if mt.shape[1] != self.pbond_list[key if key >= 0 else key + self.site_num]:
            raise ValueError(
                "Matrix physical bond dimension does not match system information"
            )
        self._mp[key] = mt
        idx = key if key >= 0 else key + self.site_num
        if len(self._mt_hashes) <= idx:
            self._mt_hashes.extend([None] * (idx + 1 - len(self._mt_hashes)))
        self._mt_hashes[idx] = _content_digest(array)

    def __iter__(self):
        return iter(self._mp)

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

    def __repr__(self):
        return "%s with %d sites" % (self.__class__, len(self))

    def __str__(self):
        kind = "mps" if self.is_mps else "mpo" if self.is_mpo else "mpdm"
        return "{} current size: {}, Matrix product bond dim:{}".format(
            kind, sizeof_fmt(self.total_bytes), self.bond_dims)
