r"""Matrix product density operator via the MPS-ancilla trick.

Port of ``renormalizer_tpu/mps/mpdm.py`` (reference
``renormalizer/mps/mpdm.py:15-161``).  ``MpDm`` represents rho as a 4-index
matrix product evolved like an MPS with an extra (traced) ancilla physical
index; quantum numbers live only on the bra index.
"""

import logging

import numpy as np
import torch

from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.mps import Mps
from renormalizer_tpu_torch.mps.svd_qn import add_outer

logger = logging.getLogger(__name__)


class MpDm(Mps, Mpo):
    @classmethod
    def random(cls, mpo, qntot, m_max, percent=0):
        raise ValueError("MpDm doesn't have to produce random state")

    @classmethod
    def ground_state(cls, model, max_entangled):
        raise ValueError(
            "Use max_entangled_ex or max_entangled_gs for matrix product density matrix"
        )

    @classmethod
    def from_mps(cls, mps: Mps) -> "MpDm":
        """Diagonal-embed an MPS into a density operator
        (reference ``mpdm.py:28-47``)."""
        mpdm = cls()
        mpdm.model = mps.model
        mpdm.dtype = mps.dtype
        for ms in mps:
            ms = to_numpy(ms)
            # |psi><a| diagonal embed: mo[v, p, p', w] = ms[v, p, w] delta_pp'
            mpdm.append(np.einsum("vpw,pq->vpqw", ms, np.eye(ms.shape[1])))
        for attr in ("coeff", "optimize_config", "evolve_config",
                     "qntot", "qnidx", "to_right"):
            setattr(mpdm, attr, getattr(mps, attr))
        mpdm.qn = [np.asarray(qn).copy() for qn in mps.qn]
        mpdm.compress_config = mps.compress_config.copy()
        return mpdm

    @classmethod
    def from_dense(cls, model, wfn):
        raise NotImplementedError

    @classmethod
    def max_entangled_ex(cls, model, normalize=True) -> "MpDm":
        r"""T=inf maximally entangled one-exciton state
        (reference ``mpdm.py:53-65``)."""
        mps = Mps.ground_state(model, max_entangled=True)
        ex_mps = Mpo.onsite(model, r"a^\dagger") @ mps
        if normalize:
            ex_mps.normalize("mps_and_coeff")
        return cls.from_mps(ex_mps)

    @classmethod
    def max_entangled_gs(cls, model) -> "MpDm":
        return cls.from_mps(Mps.ground_state(model, max_entangled=True))

    def _get_sigmaqn(self, idx):
        """qn only on the bra physical index (reference ``mpdm.py:71-74``)."""
        array_up = self.model.basis[idx].sigmaqn
        return add_outer(array_up, np.zeros_like(array_up))

    def evolve_exact(self, h_mpo, evolve_dt, space, shift=0.0):
        MPOprop = Mpo.exact_propagator(
            self.model, -1.0j * evolve_dt, space=space, shift=shift - h_mpo.offset
        )
        # the propagator acts on the ancilla side
        new_mpdm = self.apply(MPOprop, canonicalise=True)
        new_mpdm.coeff = self.coeff * np.exp(-1.0j * h_mpo.offset * evolve_dt)
        return new_mpdm

    def todense(self):
        return Mpo.todense(self)

    @property
    def is_mps(self):
        return False

    @property
    def is_mpo(self):
        return False

    @property
    def is_mpdm(self):
        return True

    def _expectation_path(self):
        # environments are (bra, mpo, ket)-ordered; operands are
        # (l, ket_site, mpo_site, bra_site, r); ancilla index e traced
        #       e                e
        # S*-a--S--f--S*   (bra)
        # O--b--O--h--O
        # S--c--S--j--S    (ket)
        return "abc,cgej,bdgh,adef,fhj->"

    def conj_trans(self):
        raise NotImplementedError

    def apply(self, mp, canonicalise=False) -> "MpDm":
        """rho @ mpo with dummy quantum numbers on the mpo side
        (reference ``mpdm.py:130-161``)."""
        assert not mp.is_mps
        new_mpdm = self.metacopy()
        if mp.is_complex:
            new_mpdm.to_complex(inplace=True)
        dtype = new_mpdm.dtype
        for i, (mt_self, mt_other) in enumerate(zip(self, mp)):
            assert mt_self.shape[2] == mt_other.shape[1]
            mt = torch.movedim(
                torch.tensordot(mt_self.to(dtype), mt_other.to(dtype), dims=([2], [1])),
                (-3, -2), (1, 3))
            new_mpdm[i] = mt.reshape(
                (mt_self.shape[0] * mt_other.shape[0], mt_self.shape[1],
                 mt_other.shape[2], mt_self.shape[-1] * mt_other.shape[-1]))
        qn = mp.dummy_qn
        new_mpdm.qn = [
            add_outer(np.asarray(qn_o), np.asarray(qn_m)).reshape(-1, np.asarray(qn_o).shape[1])
            for qn_o, qn_m in zip(self.qn, qn)
        ]
        if canonicalise:
            new_mpdm.canonicalise()
        return new_mpdm
