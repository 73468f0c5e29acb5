r"""Matrix product states: construction and measurement.

Port of the DMRG slice of ``renormalizer_tpu/mps/mps.py`` (reference
``renormalizer/mps/mps.py:118-2169``): ``Mps.random``, normalization and
``expectation``.  Time evolution is not ported yet.
"""

import logging
from typing import Union

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.model import Model, Op, OpSum
from renormalizer_tpu_torch.mps.lib import Environ, select_basis
from renormalizer_tpu_torch.mps.mp import MatrixProduct
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.svd_qn import add_outer, get_qn_mask
from renormalizer_tpu_torch.ops.contract import einsum, normalize_chain_device
from renormalizer_tpu_torch.utils import OptimizeConfig

logger = logging.getLogger(__name__)


class Mps(MatrixProduct):
    @classmethod
    def random(cls, model: Model, qntot, m_max, percent=1.0) -> "Mps":
        """Random MPS with conserved quantum number built sector-by-sector
        (reference ``mps.py:119-185``).  The draws come from numpy's
        generator seeded with the backend seed, exactly as in the JAX
        package, so one seed gives one start state in both."""
        mps = cls()
        mps.model = model
        if isinstance(qntot, int):
            qntot = np.array([qntot])
        qntot = np.atleast_1d(np.array(qntot))
        qn_size = len(qntot)
        assert qn_size == model.qn_size
        mps.qn = [np.zeros((1, qn_size), dtype=int)]
        dim_list = [1]
        rng = np.random.default_rng(backend.seed)

        for imps in range(model.nsite - 1):
            qnbig = add_outer(mps.qn[imps], mps._get_sigmaqn(imps)).reshape(-1, qn_size)
            m_cap = m_max[imps + 1] if isinstance(m_max, (list, tuple, np.ndarray)) else m_max
            u_set, s_set, qnset = [], [], []
            for sector in set(tuple(t) for t in qnbig):
                if np.all(np.array(qntot) < np.array(sector)):
                    continue
                indices = [i for i, x in enumerate(qnbig) if tuple(x) == sector]
                # random orthonormal columns per sector: thin QR of a random
                # gaussian block
                ncols = min(len(indices), int(m_cap) + 8)
                a = rng.standard_normal((len(indices), ncols))
                u, _ = np.linalg.qr(a)
                full = np.zeros((len(qnbig), ncols))
                full[indices, :] = u
                u_set.append(full)
                s_set.append(rng.random(ncols))
                qnset += [sector] * ncols
            u_set = np.concatenate(u_set, axis=1)
            s_set = np.concatenate(s_set)
            mt, mpsdim, mpsqn, _ = select_basis(
                u_set, s_set, qnset, u_set, m_cap, percent=percent
            )
            dim_list.append(mpsdim)
            mps.append(np.asarray(mt).reshape(dim_list[imps], -1, dim_list[imps + 1]))
            mps.qn.append(mpsqn)

        # last site: random, qn-masked, normalized
        mps.qn.append(np.zeros((1, qn_size), dtype=int))
        dim_list.append(1)
        last = rng.random((dim_list[-2], mps.pbond_list[-1], dim_list[-1])) - 0.5
        qnmat = add_outer(add_outer(mps.qn[-2], model.basis[-1].sigmaqn),
                          mps.qn[-1])
        mask = get_qn_mask(qnmat, qntot)
        last[~mask] = 0
        last /= np.linalg.norm(last.ravel())
        mps.append(last)

        mps.qnidx = len(mps) - 1
        mps.to_right = False
        mps.qntot = qntot
        return mps

    def __init__(self):
        super().__init__()
        self.optimize_config: OptimizeConfig = OptimizeConfig()

    def _get_sigmaqn(self, idx):
        return self.model.basis[idx].sigmaqn

    @property
    def is_mps(self):
        return True

    @property
    def is_mpo(self):
        return False

    def metacopy(self) -> "Mps":
        new = super().metacopy()
        new.optimize_config = self.optimize_config.copy()
        return new

    def normalize(self, kind: str = "mps_only") -> "Mps":
        """Scale the canonical-center tensor to a unit-norm state
        (``kind="mps_only"``, what ``optimize_mps`` uses; the norm stays on the
        device)."""
        if kind != "mps_only":
            raise NotImplementedError(f"normalize kind={kind!r}")
        self[self.qnidx] = normalize_chain_device(list(self), self.qnidx)
        return self

    def expectation(self, mpo, self_conj: "Mps" = None) -> Union[float, complex]:
        r"""<self_conj| mpo |self> (reference ``mps.py:471-525``)."""
        if isinstance(mpo, (Op, OpSum)):
            mpo = Mpo(self.model, mpo)
        if self_conj is None:
            self_conj = self.conj()
        environ = Environ(self, mpo, "R", mps_conj=self_conj)
        l = torch.ones((1, 1, 1), dtype=backend.real_dtype, device=backend.device)
        r = environ.read("R", 1)
        # operands are (l, ket_site, mpo_site, bra_site, r)
        val = complex(einsum("abc,cfh,bdfg,ade,egh->", l, self[0], mpo[0],
                             self_conj[0], r).item())
        if np.isclose(val.imag, 0):
            return val.real
        return val
