r"""Matrix product operators.

Port of ``renormalizer_tpu/mps/mpo.py`` (reference
``renormalizer/mps/mpo.py:28-494``): the constructor, ``exact_propagator``,
``onsite``, ``ph_onsite``, ``intersite``, ``identity``, ``finiteT_cv``,
``apply``/``contract`` (SVD or variational), the OFS site swap
``try_swap_site``, ``digest``, ``todense`` and :class:`StackedMpo`.  The
symbolic compilation
runs on the host (``symbolic_mpo.py``); the numeric site tensors live on the
backend device.
"""

import itertools
import logging
from copy import deepcopy
from typing import List, Union

import numpy as np
import scipy.linalg
import torch

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.model import HolsteinModel, Model, Op
from renormalizer_tpu_torch.mps.mp import MatrixProduct, to_numpy
from renormalizer_tpu_torch.mps.svd_qn import add_outer
from renormalizer_tpu_torch.mps.symbolic_mpo import (
    _terms_to_table,
    construct_symbolic_mpo,
    swap_site,
    symbolic_mo_to_numeric_mo,
)
from renormalizer_tpu_torch.utils import Quantity

logger = logging.getLogger(__name__)


class Mpo(MatrixProduct):
    """Matrix product operator, automatically compiled from symbolic terms."""

    def __init__(
        self,
        model: Model = None,
        terms: Union[Op, List[Op]] = None,
        offset: Quantity = Quantity(0),
        algo: str = "qr",
    ):
        super().__init__()
        if model is None:
            # allow manual construction
            return
        if not isinstance(offset, Quantity):
            raise ValueError(
                f"offset must be Quantity object. Got {offset} of {type(offset)}."
            )
        self.offset = offset.as_au()
        if terms is None:
            terms = model.ham_terms
        elif isinstance(terms, Op):
            terms = [terms]
        if len(terms) == 0:
            raise ValueError("Terms contain nothing.")
        terms = model.check_operator_terms(terms)
        if len(terms) == 0:
            raise ValueError("Terms all have factor 0.")

        table, primary_ops, factor = _terms_to_table(model, terms, -self.offset)
        self.dtype = (
            backend.complex_dtype if np.iscomplexobj(factor) else backend.real_dtype
        )

        (
            self.symbolic_mpo,
            self.qn,
            self.qntot,
            self.qnidx,
            self.symbolic_out_ops_list,
            self.primary_ops,
        ) = construct_symbolic_mpo(table, primary_ops, factor, algo=algo)
        self.model = model
        self.to_right = False

        for impo, mo in enumerate(self.symbolic_mpo):
            self.append(symbolic_mo_to_numeric_mo(model.basis[impo], mo,
                                                  np_dtype(self.dtype)))

    # --- constructors ------------------------------------------------------
    @classmethod
    def exact_propagator(cls, model: HolsteinModel, x, space="GS", shift=0.0):
        r"""Bond-1 exact propagator e^{xH} of the local (phonon-only)
        Hamiltonian of a Holstein model (reference ``mpo.py:33-101``).  In
        the EX space each phonon's displaced pbond x pbond Hamiltonian is
        diagonalized on the host."""
        assert space in ("GS", "EX")
        mpo = cls()
        mpo.model = model
        if np.iscomplex(x):
            mpo.dtype = backend.complex_dtype
        for mol in model:
            if model.scheme < 4:
                mpo.append(np.eye(2).reshape(1, 2, 2, 1))
            elif model.scheme == 4:
                if len(mpo) == model.order[0]:
                    n = model.mol_num
                    mpo.append(np.eye(n + 1).reshape(1, n + 1, n + 1, 1))
            else:
                raise AssertionError
            for ph in mol.ph_list:
                pbond = ph.pbond
                if space == "GS":
                    d = np.exp(x * ph.omega[0] * np.arange(pbond))
                    mo = np.diag(d).reshape(1, pbond, pbond, 1)
                else:
                    h_mo = (
                        np.diag(np.arange(pbond, dtype=float)) * ph.omega[0]
                        + (np.diag(np.sqrt(np.arange(1, pbond)), -1)
                           + np.diag(np.sqrt(np.arange(1, pbond)), 1)) * ph.term10
                    )
                    w, v = scipy.linalg.eigh(h_mo)
                    mo = (v @ np.diag(np.exp(x * w)) @ v.T).reshape(1, pbond, pbond, 1)
                mpo.append(mo)
        mpo.qn = [np.zeros((1, model.qn_size), dtype=int)] * (len(mpo) + 1)
        mpo.qnidx = len(mpo) - 1
        mpo.qntot = np.zeros(model.qn_size, dtype=int)
        # exp(shift * x) can be enormous; fold it into the chain
        return mpo.scale(np.exp(shift * x), inplace=True)

    @classmethod
    def onsite(cls, model: Model, opera, dipole=False, dof_set=None):
        """Sum of the one-site operator ``opera`` over ``dof_set`` (default:
        the electronic DoFs), optionally weighted by the dipoles."""
        if dof_set is None:
            if model.n_edofs == 0:
                raise ValueError("No electronic DoF present in the model.")
            dof_set = model.e_dofs
        ops = [
            Op(opera, dof, model.dipole[dof] if dipole else 1.0) for dof in dof_set
        ]
        return cls(model, ops)

    @classmethod
    def ph_onsite(cls, model: HolsteinModel, opera: str, mol_idx: int, ph_idx=0):
        assert opera in ("b", r"b^\dagger", r"b^\dagger b")
        if not isinstance(model, HolsteinModel):
            raise TypeError("ph_onsite only supports HolsteinModel")
        return cls(model, Op(opera, (mol_idx, ph_idx)))

    @classmethod
    def intersite(cls, model: HolsteinModel, e_opera: dict, ph_opera: dict,
                  scale: Quantity = Quantity(1.0)):
        """Inter-site operator product, e.g. ``{1: "a", 3: r"a^\\dagger"}``
        with phonon parts ``{(0, 5): "b"}`` (reference ``mpo.py:127-154``)."""
        ops = [Op(o, k) for k, o in e_opera.items()]
        ops += [Op(o, k) for k, o in ph_opera.items()]
        return cls(model, scale.as_au() * Op.product(ops))

    @classmethod
    def identity(cls, model: Model):
        mpo = cls()
        mpo.model = model
        for p in model.pbond_list:
            mpo.append(np.eye(p).reshape(1, p, p, 1))
        mpo.build_empty_qn()
        return mpo

    @classmethod
    def finiteT_cv(cls, model, nexciton, m_max, spectratype, percent=1.0):
        """Random initial CV-MPO with 2-component (bra, ket) quantum numbers
        for finite-temperature correction-vector DDMRG
        (reference ``mpo.py:156-239``).  Drawn from
        ``np.random.default_rng(0)`` and diagonalized by scipy, as the JAX
        package does, so both packages start from the same tensors."""
        from renormalizer_tpu_torch.mps.lib import select_basis

        assert spectratype in ("abs", "emi")
        tag = 0 if spectratype == "abs" else 1
        x_mpo = cls()
        x_mpo.model = model
        x_mpo.qn = ([np.zeros((1, 2), dtype=int)] + [None] * (model.nsite - 1)
                    + [np.zeros((1, 2), dtype=int)])
        dim_list = [1]
        rng = np.random.default_rng(0)
        for ix in range(model.nsite - 1):
            sigmaqn = np.array(list(itertools.product(
                model.basis[ix].sigmaqn.ravel(), repeat=2)))
            prev_qn = np.asarray(x_mpo.qn[ix]).reshape(-1, 2)
            qn1 = np.add.outer(prev_qn[:, 0], sigmaqn[:, 0]).ravel()
            qn2 = np.add.outer(prev_qn[:, 1], sigmaqn[:, 1]).ravel()
            qnbig = np.stack([qn1, qn2], axis=1)
            u_set, s_set, qnset = [], [], []
            for iblock in range(int(qnbig[:, tag].min()), nexciton + 1):
                indices = np.nonzero(
                    (qnbig[:, tag] == iblock) & (qnbig[:, 1 - tag] == 0))[0]
                if len(indices) == 0:
                    continue
                a = rng.random((len(indices), len(indices))) - 0.5
                a = a + a.T
                s, u = scipy.linalg.eigh(a)
                full = np.zeros((len(qnbig), len(indices)))
                full[indices, :] = u
                u_set.append(full)
                s_set.append(s)
                block_qn = [0, 0]
                block_qn[tag] = iblock
                qnset += [tuple(block_qn)] * len(indices)
            u_set = np.concatenate(u_set, axis=1)
            s_set = np.concatenate(s_set)
            x, xdim, xqn, _ = select_basis(u_set, s_set, qnset, None, m_max,
                                           percent=percent)
            dim_list.append(xdim)
            x_mpo.qn[ix + 1] = np.array(xqn)
            x_mpo.append(np.asarray(x).reshape(
                dim_list[-2], model.pbond_list[ix], model.pbond_list[ix], xdim))
        dim_list.append(1)
        x_mpo.append(rng.random(
            (dim_list[-2], model.pbond_list[-1], model.pbond_list[-1], 1)))
        x_mpo.qnidx = len(x_mpo) - 1
        x_mpo.to_right = False
        x_mpo.qntot = np.array([0, 0])
        x_mpo.qntot[tag] = nexciton
        return x_mpo

    # --- structure ----------------------------------------------------------
    def _get_sigmaqn(self, idx):
        qn = self.model.basis[idx].sigmaqn
        return add_outer(qn, -qn)

    @property
    def is_mps(self):
        return False

    @property
    def is_mpo(self):
        return True

    @property
    def is_mpdm(self):
        return False

    def metacopy(self) -> "Mpo":
        new = super().metacopy()
        for attr in ("offset", "symbolic_out_ops_list", "primary_ops"):
            if hasattr(self, attr):
                setattr(new, attr, deepcopy(getattr(self, attr)))
        return new

    @property
    def dummy_qn(self):
        return [np.zeros((dim, self.model.qn_size), dtype=int) for dim in self.bond_dims]

    def promote_mt_type(self, mp):
        if self.is_complex and not mp.is_complex:
            mp.to_complex(inplace=True)
        return mp

    # --- application ----------------------------------------------------------
    def apply(self, mp: MatrixProduct, canonicalise: bool = False) -> MatrixProduct:
        """Exact ``mpo @ mps`` / ``mpo @ mpo`` / ``mpo @ mpdm`` with
        quantum-number outer sums (reference ``mpo.py:331-389``)."""
        assert self.site_num == mp.site_num
        new_mps = self.promote_mt_type(mp.copy())
        dtype = new_mps.dtype
        for i, (mt_o, mt_s) in enumerate(zip(self, mp)):
            assert mt_o.shape[2] == mt_s.shape[1]
            mt = torch.tensordot(mt_o.to(dtype), mt_s.to(dtype), dims=([2], [1]))
            if mp.is_mps:
                # (ol, up, or, sl, sr) -> (ol, sl, up, or, sr)
                mt = torch.movedim(mt, 3, 1)
                new_mps[i] = mt.reshape(
                    (mt_o.shape[0] * mt_s.shape[0], mt_o.shape[1],
                     mt_o.shape[-1] * mt_s.shape[-1]))
            else:
                # an MPO or an MpDm (whose ancilla leg is the "down" one):
                # (ol, up, or, sl, down, sr) -> (ol, sl, up, down, or, sr)
                mt = torch.movedim(mt, (-3, -2), (1, 3))
                new_mps[i] = mt.reshape(
                    (mt_o.shape[0] * mt_s.shape[0], mt_o.shape[1],
                     mt_s.shape[2], mt_o.shape[-1] * mt_s.shape[-1]))
        orig_idx = new_mps.qnidx
        new_mps.move_qnidx(self.qnidx)
        new_mps.qn = [
            add_outer(np.asarray(qo), np.asarray(qm)).reshape(-1, np.asarray(qo).shape[1])
            for qo, qm in zip(self.qn, new_mps.qn)
        ]
        new_mps.qntot = new_mps.qntot + self.qntot
        new_mps.move_qnidx(orig_idx)
        if canonicalise:
            new_mps.canonicalise()
        return new_mps

    def contract(self, mps, algo="svd"):
        """Compressed ``mpo @ mps`` (reference ``mpo.py:391-425``): the
        exact product compressed by SVD, or fitted by
        :meth:`MatrixProduct.variational_compress`."""
        if algo == "svd":
            new_mps = self.apply(mps)
            new_mps.canonicalise()
            new_mps.compress()
        elif algo == "variational":
            new_mps = mps.variational_compress(self)
        else:
            raise AssertionError
        return new_mps

    def try_swap_site(self, new_model: Model, swap_jw: bool, algo="Hopcroft-Karp"):
        """In-place symbolic swap of the two adjacent sites whose DoFs
        ``new_model`` holds in the other order (OFS; reference
        ``mpo.py:427-454``): the three bonds around them are recompiled on
        the host and the two site tensors rebuilt."""
        diffs = [
            i for i, (b1, b2) in enumerate(zip(self.model.basis, new_model.basis))
            if b1.dofs != b2.dofs
        ]
        if not diffs:
            logger.debug("MPO: No need to swap")
            return
        assert len(diffs) == 2
        i, j = min(diffs), max(diffs)
        assert j - i == 1
        logger.debug(f"MPO: swapping {i} and {j}")
        new_model.mpos.clear()
        out_ops2, out_ops3, mo1, mo2, qn = swap_site(
            self.symbolic_out_ops_list[i:i + 3], self.primary_ops, swap_jw, algo=algo
        )
        self.symbolic_out_ops_list[i + 1] = out_ops2
        self.symbolic_out_ops_list[i + 2] = out_ops3
        self.model = new_model
        self.qn[i + 1] = np.array(qn)
        for impo, mo in zip([i, j], [mo1, mo2]):
            self[impo] = symbolic_mo_to_numeric_mo(new_model.basis[impo], mo,
                                                   np_dtype(self.dtype))

    def conj_trans(self):
        new_mpo = self.metacopy()
        for i in range(new_mpo.site_num):
            new_mpo[i] = torch.movedim(self[i], (1, 2), (2, 1)).conj()
        new_mpo.qn = [np.array([-q for q in mt_qn]) for mt_qn in new_mpo.qn]
        return new_mpo

    def is_hermitian(self):
        full = self.todense()
        return np.allclose(full.conj().T, full, atol=1e-7)

    @property
    def digest(self):
        """A scalar fingerprint of the site tensors: the variance of their
        variances (as ``renormalizer_tpu/mps/mpo.py:364``)."""
        return np.array([to_numpy(mt).var() for mt in self]).var()

    def __matmul__(self, other):
        return self.apply(other)

    def todense(self) -> np.ndarray:
        """The operator as a dense host matrix (small systems only)."""
        dim = np.prod(self.pbond_list)
        if 20000 < dim:
            raise ValueError("operator too large")
        res = np.ones((1, 1, 1, 1))
        for mt in self:
            mt = to_numpy(mt)
            d1 = res.shape[1] * mt.shape[1]
            d2 = res.shape[2] * mt.shape[2]
            res = (
                np.tensordot(res, mt, axes=1)
                .transpose((0, 1, 3, 2, 4, 5))
                .reshape(1, d1, d2, mt.shape[-1])
            )
        return res[0, :, :, 0]


class StackedMpo:
    """A sum of MPOs kept apart: each term has its own environments and the
    eigensolver sums their hops (reference ``mpo.py:483-494``)."""

    def __init__(self, mpos: List[Mpo]):
        self.mpos = mpos
