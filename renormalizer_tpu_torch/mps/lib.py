r"""MPS sweep machinery: environments and renormalized-basis selection.

Port of ``renormalizer_tpu/mps/lib.py``.  Environments are a dict of device
tensors.  Basis selection works on host copies of the singular values (a
few KB) and returns index lists for device gathers.  The JAX package rounds
per-sector kept counts to multiples of 8 on accelerators to bound XLA
recompiles; PyTorch compiles nothing per shape, so the port keeps the
reference's exact selection everywhere.
"""

import logging
from collections import deque
from functools import reduce
from typing import List

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.ops.contract import (
    contract_one_site,
    contract_one_site_multi_mpo,
)

logger = logging.getLogger(__name__)


class Environ:
    """Cache of left/right environment tensors
    (reference ``renormalizer/mps/lib.py:12-118``).

    ``(domain, siteidx)`` keys map to the environment covering sites
    ``0..siteidx`` (L) or ``siteidx..N-1`` (R):

    S-     -S     mps conj
    O- or  -O     mpo (or a list of stacked mpos, one leg each)
    S-     -S     mps
    """

    def __init__(self, mps, mpo, domain=None, mps_conj=None):
        self._store = {}
        # the boundary carries the dtype of the contraction, so no
        # environment is promoted again when it meets a complex state
        mpos = mpo if isinstance(mpo, list) else [mpo]
        dtype = mps[0].dtype
        for m in mpos:
            dtype = torch.promote_types(dtype, m[0].dtype)
        self.sentinel = torch.ones((1,) * (len(mpos) + 2), dtype=dtype,
                                   device=backend.device)
        self._build(mps, mpo, domain, mps_conj)

    @staticmethod
    def _contract(tensor, mps, mpo, idx, domain, ms_conj=None):
        if isinstance(mpo, list):
            return contract_one_site_multi_mpo(
                tensor, mps[idx], [m[idx] for m in mpo], domain, ms_conj=ms_conj)
        return contract_one_site(tensor, mps[idx], mpo[idx], domain,
                                 ms_conj=ms_conj)

    def _build(self, mps, mpo, domain, mps_conj):
        assert domain in ("L", "R", None)
        if mps_conj is None:
            mps_conj = [None] * len(mps)
        if domain is None:
            self._build(mps, mpo, "L", mps_conj)
            self._build(mps, mpo, "R", mps_conj)
            return
        self.write("L", -1, self.sentinel)
        self.write("R", len(mps), self.sentinel)
        if domain == "L":
            indices = range(0, len(mps) - 1)
        else:
            indices = range(len(mps) - 1, 0, -1)
        tensor = self.sentinel
        for idx in indices:
            tensor = self._contract(tensor, mps, mpo, idx, domain, mps_conj[idx])
            self.write(domain, idx, tensor)

    def GetLR(self, domain, siteidx, mps, mpo, itensor=None, *, method,
              mps_conj=None):
        """Fetch/update the environment at ``siteidx``: ``method="Enviro"``
        reads the cache, ``"System"`` extends ``itensor`` (default: the
        cached neighbor environment) by one site and caches it.  ``mps_conj``
        is a bra other than the ket's conjugate (TDA's tangent sandwich)."""
        assert domain in ("L", "R") and method in ("Enviro", "System")
        if siteidx not in range(len(mps)):
            return self.sentinel
        if method == "Enviro":
            return self.read(domain, siteidx)
        if itensor is None:
            offset = -1 if domain == "L" else 1
            itensor = self.read(domain, siteidx + offset)
        ms_conj = None if mps_conj is None else mps_conj[siteidx]
        itensor = self._contract(itensor, mps, mpo, siteidx, domain, ms_conj)
        self.write(domain, siteidx, itensor)
        return itensor

    def write(self, domain, siteidx, tensor):
        self._store[(domain, siteidx)] = tensor

    def read(self, domain, siteidx):
        return self._store[(domain, siteidx)]


def select_indices(sset, qnlist, Mmax, percent=0) -> List[int]:
    """Pick the retained candidate indices by singular value and qn block
    (the index-selection half of :func:`select_basis`)."""
    sset = np.asarray(sset)
    qnlist = [tuple(qn) for qn in qnlist]
    # device kernels mark pad slots with the sentinel sigma = -1:
    # unselectable.  The cut must NOT catch roundoff-negative weights.
    available = {i: (qnlist[i], sset[i]) for i in range(len(qnlist))
                 if sset[i] > -0.5}
    qnset = {qnlist[i] for i in available}

    def take_from_block(qn, n):
        block = [(i, s) for i, (q, s) in available.items() if q == qn]
        block.sort(key=lambda t: t[1], reverse=True)
        chosen = [i for i, _ in block[:n]]
        for i in chosen:
            del available[i]
        return chosen

    nbasis = min(len(available), Mmax)
    sidx: List[int] = []
    if percent != 0:
        per_block = int(nbasis * percent / len(qnset))
        for qn in qnset:
            sidx += take_from_block(qn, per_block)
    remaining = sorted(available.items(), key=lambda t: t[1][1], reverse=True)
    sidx += [i for i, _ in remaining[: nbasis - len(sidx)]]
    assert len(sidx) == len(set(sidx))
    return sidx


def select_basis(vset, sset, qnlist, compset, Mmax, percent=0):
    """Renormalized-basis selection of J. Chem. Phys. 120, 3172 (2004)
    (reference ``mps/lib.py:253-322``).

    A ``percent`` fraction of the retained basis is distributed equally over
    quantum-number blocks (by descending singular value within each block) to
    avoid local minima; the rest is taken globally by singular value.

    ``vset``/``compset`` are numpy matrices with basis vectors as columns
    (``Mps.random`` builds its start state on the host); ``sset`` are the
    weights.  Returns ``(ms, mpsdim, mpsqn, compms)`` where ``compms``
    columns are scaled by their singular values.
    """
    sset = np.asarray(sset)
    qnlist = [tuple(qn) for qn in qnlist]
    sidx = select_indices(sset, qnlist, Mmax, percent)
    mpsdim = len(sidx)
    ms = vset[:, np.array(sidx, dtype=int)]
    mpsqn = np.array([qnlist[i] for i in sidx])
    if compset is not None:
        # columns beyond compset's width correspond to zero singular values
        scale = np.where(np.array(sidx) < compset.shape[1], sset[sidx], 0.0)
        safe_np = np.minimum(np.array(sidx), compset.shape[1] - 1)
        compms = compset[:, safe_np] * scale[None, :]
    else:
        compms = None
    return ms, mpsdim, mpsqn, compms


def compressed_sum(mps_list, batchsize=5, temp_m_trunc=None):
    """Sum many MPS with intermediate compression in batches
    (reference ``mps/lib.py:417-439``)."""
    assert len(mps_list) != 0
    queue = deque(mps_list)
    if len(queue) == 1:
        new_mps = mps_list[0].canonicalise()
        new_mps.compress(temp_m_trunc=temp_m_trunc)
        return new_mps
    while len(queue) != 1:
        batch = [queue.popleft() for _ in range(min(batchsize, len(queue)))]
        summed = reduce(lambda a, b: a.add(b), batch)
        summed.canonicalise()
        summed.compress(temp_m_trunc=temp_m_trunc)
        queue.append(summed)
    return queue[0]


def cvec2cmat(c, qn_mask: np.ndarray, nroots: int = 1):
    """Scatter a qn-masked flat vector back into the dense local tensor
    (reference ``mps/lib.py:442-457``); several roots: a list of vectors
    (or the columns of a matrix) to a list of tensors."""
    def one(vec):
        mask = torch.as_tensor(qn_mask.ravel(), device=vec.device)
        full = torch.zeros(qn_mask.size, dtype=vec.dtype, device=vec.device)
        full[mask] = vec
        return full.reshape(qn_mask.shape)

    if nroots == 1:
        return one(c)
    if not isinstance(c, list):
        c = [c[:, i] for i in range(c.shape[1])]
    return [one(ci) for ci in c]
