r"""Matrix product states: construction, measurement and time evolution.

Port of ``renormalizer_tpu/mps/mps.py`` (reference
``renormalizer/mps/mps.py:118-2169``): the constructors, normalization,
measurements, bond-dimension expansion, the one-site projector-splitting
TDVP (``EvolveMethod.tdvp_ps``, PhysRevB.94.165116), the propagate-and-compress
family (Taylor, RK4 and Butcher-tableau RK, fixed or adaptive), the exact
local propagation and ``BraKetPair``.  TDVP-PS2, VMF and CMF are not ported
yet; :meth:`Mps.evolve` names them and raises.
"""

import logging
from functools import reduce, wraps
from typing import Dict, Union

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib import solvers
from renormalizer_tpu_torch.model import Model, Op, OpSum
from renormalizer_tpu_torch.model import basis as ba
from renormalizer_tpu_torch.mps import trunc_device
from renormalizer_tpu_torch.mps.lib import Environ, compressed_sum, select_basis
from renormalizer_tpu_torch.mps.mp import MatrixProduct, to_numpy
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.svd_qn import add_outer, get_qn_mask
from renormalizer_tpu_torch.ops.contract import (
    einsum,
    hop_spec,
    normalize_chain_device,
    tensordot1,
)
from renormalizer_tpu_torch.utils import (
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    OptimizeConfig,
    calc_vn_entropy,
)

logger = logging.getLogger(__name__)

# Site visits of ``_evolve_tdvp_ps`` by branch, counted since import: the
# fused visit (:func:`solvers.tdvp_ps_site_fused`) and the unfused one (the
# last site of each half-sweep, and every site the fused visit declines).
TDVP_PS_VISITS = {"fused": 0, "unfused": 0}


def _complex_mpo_twin(mpo):
    """Cached complex-dtype twin of a (real) Hamiltonian MPO.

    Complex evolution contracts the real MPO cores against complex states
    thousands of times per run (every Lanczos matvec); ``torch.einsum`` does
    not promote, so each contraction would convert them anew.  Convert
    once, keep the twin on the object, reuse it in every later step."""
    if mpo.is_complex:
        return mpo
    twin = getattr(mpo, "_complex_twin", None)
    if twin is None:
        twin = mpo.to_complex()
        mpo._complex_twin = twin
    return twin


def _trivial_sector(qnbigl, qnbigr, qntot):
    """The single quantum number covering the WHOLE local coefficient
    matrix, or None when real sector structure exists.  Models without
    conserved charges (e.g. spin-boson) always qualify."""
    qntot = np.atleast_1d(np.asarray(qntot))
    ql = np.asarray(qnbigl).reshape(-1, len(qntot))
    nl = ql[0]
    if not (ql == nl).all():
        return None
    qr_ = np.asarray(qnbigr).reshape(-1, len(qntot))
    if not (qr_ == qntot - nl).all():
        return None
    return tuple(nl)


def adaptive_tdvp(fun):
    """Adaptive-dt wrapper: evolve dt/2 twice vs dt once, step-doubling
    p-controller (J. Chem. Phys. 146, 174107 (2017); reference
    ``mps.py:46-115``)."""

    @wraps(fun)
    def adaptive_fun(self: "Mps", mpo, evolve_target_t):
        if not self.evolve_config.adaptive:
            return fun(self, mpo, evolve_target_t)
        config: EvolveConfig = self.evolve_config.copy()
        config.check_valid_dt(evolve_target_t)

        p_restart, p_min, p_max = 0.5, 0.1, 2.0
        cur_mps = self
        evolved_t = 0
        while True:
            dt = min_abs(config.guess_dt, evolve_target_t - evolved_t)
            logger.debug(f"guess_dt: {config.guess_dt}, try time step size: {dt}")
            mps_half2 = fun(fun(cur_mps, mpo, dt / 2), mpo, dt / 2)
            mps_full = fun(cur_mps, mpo, dt)
            dis = mps_full.distance(mps_half2)
            p = (0.75 * config.adaptive_rtol / (dis / mps_half2.mp_norm + 1e-30)) ** (1 / 3)
            logger.debug(f"distance: {dis}, enlarge p parameter: {p}")
            p = min(max(p, p_min), p_max)
            if p < p_restart:
                config.guess_dt = dt * p
                logger.debug(f"evolution not converged, new guess_dt: {config.guess_dt}")
                continue
            evolved_t += dt
            if np.allclose(evolved_t, evolve_target_t):
                mps_half2.evolve_config.guess_dt = config.guess_dt
                return mps_half2
            config.guess_dt *= p
            logger.debug(f"sub-step {dt} done, evolved: {evolved_t}")
            cur_mps = mps_half2

    return adaptive_fun


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

    @classmethod
    def hartree_product_state(cls, model: Model, condition: Dict = None, qn_idx: int = None):
        """Hartree product state with per-DoF local states
        (reference ``mps.py:187-256``)."""
        if condition is None:
            condition = {}
        mps = cls()
        mps.model = model
        mps.build_empty_mp(model.nsite)
        qn_size = model.qn_size
        mps.qn = [np.zeros((1, qn_size), dtype=int)]

        site_condition = {}
        for key, value in condition.items():
            idx = model.dof_to_siteidx[key]
            assert idx not in site_condition, "duplicate condition on one site"
            site_condition[idx] = value

        for isite, local_basis in enumerate(model.basis):
            pdim = local_basis.nbas
            ms = np.zeros((1, pdim, 1))
            local_state = site_condition.pop(isite, 0)
            if isinstance(local_state, int):
                ms[0, local_state, 0] = 1.0
                qn = local_basis.sigmaqn[local_state]
            else:
                ms[0, :, 0] = local_state
                occupied_qn = np.array(local_basis.sigmaqn)[np.nonzero(local_state)]
                if not np.allclose(occupied_qn.std(axis=0), 0):
                    raise ValueError("Quantum numbers are mixed in the condition.")
                qn = occupied_qn[0]
            mps[isite] = ms
            mps.qn.append(mps.qn[-1] + qn.reshape(1, qn_size))

        if site_condition:
            raise ValueError(f"Condition not completely used: {site_condition}")
        mps.qntot = mps.qn[-1][0]
        mps.qnidx = model.nsite
        if qn_idx is None:
            qn_idx = model.nsite - 1
        mps.move_qnidx(qn_idx)
        mps.to_right = False
        return mps

    @classmethod
    def ground_state(cls, model: Model, max_entangled: bool, normalize: bool = True):
        r"""T=0 or T=inf (max-entangled) product state
        (reference ``mps.py:258-350``) for the bases the port carries."""
        mps = cls()
        mps.model = model
        mps.qn = [np.zeros((1, model.qn_size), dtype=int)] * (model.nsite + 1)
        mps.qnidx = model.nsite - 1
        mps.to_right = False
        mps.qntot = np.zeros(model.qn_size, dtype=int)
        mps.build_empty_mp(model.nsite)

        for isite, local_basis in enumerate(model.basis):
            pdim = local_basis.nbas
            ms = np.zeros((1, pdim, 1))
            if local_basis.is_phonon or isinstance(local_basis, ba.BasisHalfSpin):
                if max_entangled:
                    ms[0, :, 0] = (1.0 / np.sqrt(pdim)) if normalize else 1.0
                else:
                    ms[0, 0, 0] = 1.0
            elif isinstance(local_basis, (ba.BasisSimpleElectron,
                                          ba.BasisMultiElectronVac)):
                ms[0, 0, 0] = 1.0
            else:
                raise NotImplementedError
            mps[isite] = ms
        return mps

    @classmethod
    def load(cls, model: Model, fname: str):
        mp = super().load(model, fname)
        mp.coeff = np.load(fname)["coeff"].item(0)
        return mp

    @classmethod
    def from_dense(cls, model, wfn: np.ndarray):
        """Exact (untruncated) MPS from a dense wavefunction, for debugging
        (reference ``mps.py:388-406``)."""
        mp = cls()
        mp.model = model
        mp.dtype = backend.complex_dtype if np.iscomplexobj(wfn) else backend.real_dtype
        residual = wfn.reshape([1] + [b.nbas for b in model.basis] + [1])
        for i in range(len(model.basis) - 1):
            mat = residual.reshape(residual.shape[0] * residual.shape[1], -1)
            q, r = np.linalg.qr(mat)
            mp.append(q.reshape(residual.shape[0], residual.shape[1], q.shape[1]))
            residual = r.reshape([r.shape[0]] + list(residual.shape[2:]))
        assert residual.ndim == 3
        mp.append(residual)
        mp.build_empty_qn()
        return mp

    def __init__(self):
        super().__init__()
        # scalar prefactor carried outside the tensor network
        self.coeff: Union[float, complex] = 1
        self.optimize_config: OptimizeConfig = OptimizeConfig()
        self.evolve_config: EvolveConfig = EvolveConfig()

    # --- structure -----------------------------------------------------------
    def conj(self) -> "Mps":
        new_mps = super().conj()
        new_mps.coeff = np.conjugate(new_mps.coeff)
        return new_mps

    def to_complex(self, inplace=False) -> "Mps":
        new_mp = super().to_complex(inplace=inplace)
        new_mp.coeff = complex(new_mp.coeff)
        return new_mp

    def _get_sigmaqn(self, idx):
        return self.model.basis[idx].sigmaqn

    @property
    def is_mps(self):
        return True

    @property
    def is_mpo(self):
        return False

    @property
    def is_mpdm(self):
        return False

    @property
    def norm(self):
        """Norm of the total wavefunction including ``coeff``."""
        return np.linalg.norm(self.coeff) * self.mp_norm

    def metacopy(self) -> "Mps":
        new = super().metacopy()
        new.coeff = self.coeff
        new.optimize_config = self.optimize_config.copy()
        new.evolve_config = self.evolve_config.copy()
        return new

    def _fold_coeff(self, other):
        """Before a sum or a difference: bring both states to ``coeff = 1``
        unless their prefactors already agree."""
        if not np.allclose(self.coeff, other.coeff):
            self.scale(self.coeff, inplace=True)
            other.scale(other.coeff, inplace=True)
            self.coeff = 1
            other.coeff = 1

    def add(self, other):
        self._fold_coeff(other)
        return super().add(other)

    def distance(self, other) -> float:
        self._fold_coeff(other)
        return super().distance(other)

    def dump(self, fname):
        super().dump(fname, other_attrs=["coeff"])

    def normalize(self, kind: str = "mps_only") -> "Mps":
        """kind: "mps_only" | "mps_norm_to_coeff" | "mps_and_coeff"
        (reference ``mps.py:619-634``)."""
        return normalize(self, kind)

    def expand_bond_dimension(self, hint_mpo=None, coef=1e-10, include_ex=True):
        return expand_bond_dimension(self, hint_mpo, coef, include_ex)

    # --- measurement -----------------------------------------------------------
    def _expectation_path(self):
        # environments are (bra, mpo, ket)-ordered; operands are
        # (l, ket_site, mpo_site, bra_site, r)
        return "abc,cfh,bdfg,ade,egh->"

    def expectation(self, mpo, self_conj: "Mps" = None) -> Union[float, complex]:
        r"""<self_conj| mpo |self> (reference ``mps.py:471-525``)."""
        if isinstance(mpo, (Op, OpSum)):
            mpo = Mpo(self.model, mpo)
        if self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        if self_conj is None:
            self_conj = self.conj()
        environ = Environ(self, mpo, "R", mps_conj=self_conj)
        r = environ.read("R", 1)
        val = complex(einsum(self._expectation_path(), environ.sentinel, self[0],
                             mpo[0], self_conj[0], r).item())
        if np.isclose(val.imag, 0):
            return val.real
        return val

    def expectations(self, mpos, self_conj: "Mps" = None) -> np.ndarray:
        """Many expectations of one state, one environment sweep each
        (reference ``mps.py:527-575`` without the shared-environment cache)."""
        if self_conj is None:
            self_conj = self.conj()
        results = np.array([complex(self.expectation(mpo, self_conj))
                            for mpo in mpos])
        if np.allclose(results.imag, 0):
            return results.real
        return results

    @property
    def ph_occupations(self):
        """Phonon occupations n for each vibrational DoF
        (reference ``mps.py:577-593``)."""
        key = "ph_occupations"
        if key not in self.model.mpos:
            self.model.mpos[key] = [
                Mpo(self.model, Op("n", dof)) for dof in self.model.v_dofs
            ]
        return self.expectations(self.model.mpos[key])

    @property
    def e_occupations(self):
        r"""Electronic occupations a^dagger a (reference ``mps.py:595-609``)."""
        key = "e_occupations"
        if key not in self.model.mpos:
            self.model.mpos[key] = [
                Mpo(self.model, Op(r"a^\dagger a", dof)) for dof in self.model.e_dofs
            ]
        return self.expectations(self.model.mpos[key])

    def calc_1site_rdm(self, idx=None) -> Dict[int, np.ndarray]:
        r"""1-site reduced density matrices (reference ``mps.py:1547-1598``)."""
        identity = Mpo.identity(self.model)
        if self.is_complex:
            identity = identity.to_complex()
        environ = Environ(self, identity, "R")
        if idx is None:
            idx = list(range(self.site_num))
        elif isinstance(idx, int):
            idx = [idx]
        else:
            idx = list(idx)
        rdm = {}
        for ims, ms in enumerate(self):
            ltensor = environ.GetLR("L", ims - 1, self, identity, method="System")
            rtensor = environ.GetLR("R", ims + 1, self, identity, method="Enviro")
            if ims not in idx:
                continue
            lmat = ltensor.reshape(ltensor.shape[0], ltensor.shape[-1])
            rmat = rtensor.reshape(rtensor.shape[0], rtensor.shape[-1])
            t = torch.tensordot(lmat, ms.conj(), dims=([0], [0]))
            t = torch.tensordot(t, rmat, dims=([-1], [0]))
            t = to_numpy(torch.tensordot(t, ms, dims=([0, -1], [0, -1])))
            assert np.allclose(t, t.conj().T, atol=1e-6)
            rdm[ims] = t
        return rdm

    def calc_entropy(self, entropy_type):
        """Von Neumann entropy; the port carries the bond entropy
        (reference ``mps.py:1689-1732``)."""
        if entropy_type == "bond":
            return self.calc_bond_entropy()
        raise NotImplementedError(f"entropy type {entropy_type!r} is not ported")

    def calc_bond_singular_values(self) -> np.ndarray:
        mps = self.copy()
        mps.ensure_right_canonical()
        _, s_array = mps.compress(temp_m_trunc=np.inf, ret_s=True)
        return s_array

    def calc_bond_entropy(self, s_array=None) -> np.ndarray:
        if s_array is None:
            s_array = self.calc_bond_singular_values()
        return np.array([calc_vn_entropy(s ** 2) for s in s_array])

    def todense(self) -> np.ndarray:
        dim = np.prod(self.pbond_list)
        if 20000 < dim:
            raise ValueError("wavefunction too large")
        res = np.ones((1, 1, 1))
        for mt in self:
            mt = to_numpy(mt)
            dim1 = res.shape[1] * mt.shape[1]
            res = np.tensordot(res, mt, axes=1).reshape(1, dim1, mt.shape[-1])
        return res[0, :, 0]

    # --- evolution ------------------------------------------------------------
    def evolve(self, mpo, evolve_dt, normalize=True) -> "Mps":
        method = self.evolve_config.method
        evolve = {
            EvolveMethod.prop_and_compress: self._evolve_prop_and_compress,
            EvolveMethod.prop_and_compress_tdrk4: self._evolve_prop_and_compress_tdrk4,
            EvolveMethod.prop_and_compress_tdrk: self._evolve_prop_and_compress_tdrk,
            EvolveMethod.tdvp_ps: self._evolve_tdvp_ps,
        }.get(method)
        if evolve is None:
            raise NotImplementedError(
                f"evolution method {method} ({method.value}) is not ported yet")
        new_mps = evolve(mpo, evolve_dt)
        if normalize:
            if np.iscomplex(evolve_dt):
                new_mps.normalize("mps_and_coeff")
            else:
                new_mps.normalize("mps_only")
        return new_mps

    def _evolve_prop_and_compress(self, mpo, evolve_dt) -> "Mps":
        """Taylor propagator with compressed sums, fixed or adaptive step
        (reference ``mps.py:794-885``)."""
        if self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        config = self.evolve_config
        assert evolve_dt is not None
        propagation_c = config.taylor_config.coeff
        order = len(propagation_c) - 1
        termlist = [self]
        # don't let the bond dimension grow during the H^n |psi> ladder
        orig_compress_config = self.compress_config
        contract_compress_config = self.compress_config.copy()
        if contract_compress_config.criteria is CompressCriteria.threshold:
            contract_compress_config.criteria = CompressCriteria.both
        self.compress_config = contract_compress_config
        while len(termlist) < len(propagation_c):
            termlist.append(mpo.contract(termlist[-1]))
        for t in termlist:
            t.compress_config = orig_compress_config

        if config.adaptive:
            config.check_valid_dt(evolve_dt)
            p_restart, p_min, p_max = 0.5, 0.1, 2.0
            while True:
                dt = min_abs(config.guess_dt, evolve_dt)
                logger.debug(f"guess_dt: {config.guess_dt}, try time step size: {dt}")
                scaled = [
                    term.scale((-1.0j * dt) ** idx * propagation_c[idx])
                    for idx, term in enumerate(termlist)
                ]
                new_mps1 = compressed_sum(scaled[:-1])
                new_mps2 = compressed_sum([new_mps1, scaled[-1]])
                dis = new_mps1.distance(new_mps2)
                p = (config.adaptive_rtol / (dis / new_mps2.mp_norm + 1e-30)) ** (1 / order)
                logger.debug(f"Taylor error distance: {dis}, enlarge p parameter: {p}")
                if np.allclose(dt, evolve_dt):
                    if p < p_restart:
                        config.guess_dt = dt * max(p_min, p)
                        continue
                    new_mps2.evolve_config.guess_dt = min_abs(dt * p, config.guess_dt)
                    return new_mps2
                if p < p_restart:
                    config.guess_dt *= max(p_min, p)
                    continue
                new_dt = evolve_dt - dt
                config.guess_dt *= min(p, p_max)
                new_mps2.evolve_config.guess_dt = config.guess_dt
                logger.debug(f"sub-step {dt} further, remaining: {new_dt}")
                return new_mps2._evolve_prop_and_compress(mpo, new_dt)

        for idx, term in enumerate(termlist):
            term.scale((-1.0j * evolve_dt) ** idx * propagation_c[idx], inplace=True)
        return compressed_sum(termlist)

    def _evolve_prop_and_compress_tdrk4(self, mpo, evolve_dt) -> "Mps":
        """Classical RK4 for a (possibly) time-dependent H
        (reference ``mps.py:664-699``)."""
        if self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        mpo_t = _normalize_mpo_t(mpo)
        k1 = mpo_t(0).contract(self).scale(-1j)
        tmp = self + k1.scale(0.5 * evolve_dt)
        tmp.canonicalise().compress()
        k2 = mpo_t(0.5 * evolve_dt).contract(tmp).scale(-1j)
        tmp = self + k2.scale(0.5 * evolve_dt)
        tmp.canonicalise().compress()
        k3 = mpo_t(0.5 * evolve_dt).contract(tmp).scale(-1j)
        tmp = self + k3.scale(evolve_dt)
        tmp.canonicalise().compress()
        k4 = mpo_t(evolve_dt).contract(tmp).scale(-1j)
        return compressed_sum([
            self,
            k1.scale(evolve_dt / 6), k2.scale(evolve_dt / 3),
            k3.scale(evolve_dt / 3), k4.scale(evolve_dt / 6),
        ])

    def _evolve_prop_and_compress_tdrk(self, mpo, evolve_dt) -> "Mps":
        """General explicit RK with a Butcher tableau, adaptive (embedded
        pair) or fixed step (reference ``mps.py:701-792``)."""
        if self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        mpo_t = _normalize_mpo_t(mpo)
        rk = self.evolve_config.rk_config
        a, b, c = rk.tableau

        def sub_step(y, tau, t0):
            k_list = []
            for istage in range(rk.stage):
                k = compressed_sum(
                    [y] + [k_list[i].scale(a[istage, i] * tau)
                           for i in range(istage) if a[istage, i] != 0],
                    batchsize=6)
                k = mpo_t(c[istage] * tau + t0, mps=k).contract(k).scale(-1j)
                k_list.append(k)
            new_mps = compressed_sum(
                [y] + [k_list[i].scale(b[0, i] * tau)
                       for i in range(rk.stage) if b[0, i] != 0],
                batchsize=6)
            if self.evolve_config.adaptive:
                assert len(rk.order) == 2 and rk.order[0] - rk.order[1] == 1
                err_mps = reduce(
                    lambda m1, m2: m1.add(m2),
                    [k_list[i].scale((b[0, i] - b[1, i]) * tau)
                     for i in range(rk.stage) if not np.allclose(b[0, i], b[1, i])])
                error = err_mps.norm / new_mps.norm
            else:
                assert len(rk.order) == 1
                error = 0
            return new_mps, error

        self.evolve_config.check_valid_dt(evolve_dt)
        if not self.evolve_config.adaptive:
            new_mps, _ = sub_step(self, evolve_dt, 0)
            return new_mps

        p_restart, p_min, p_max = 0.5, 0.1, 2.0
        evolved = 0
        new_mps = self
        while True:
            dt = min_abs(new_mps.evolve_config.guess_dt, evolve_dt - evolved)
            new_mps2, error = sub_step(new_mps, dt, evolved)
            p = (new_mps.evolve_config.adaptive_rtol / (error + 1e-30)) ** (1 / rk.order[0])
            logger.debug(f"RK {rk.method} error: {error}, p: {p}")
            if p < p_restart:
                new_mps.evolve_config.guess_dt = dt * max(p_min, p)
                continue
            new_mps = new_mps2
            if np.allclose(dt + evolved, evolve_dt):
                new_mps.evolve_config.guess_dt = min_abs(
                    dt * p, new_mps.evolve_config.guess_dt)
                return new_mps
            new_mps.evolve_config.guess_dt = new_mps.evolve_config.guess_dt * min(p, p_max)
            evolved += dt

    def evolve_exact(self, h_mpo, evolve_dt, space, shift=0.0):
        """Exact local propagation within the GS/EX space
        (reference ``mps.py:1519-1523``); ``shift`` adds a constant to the
        local Hamiltonian, i.e. propagates with ``exp(-i (H + shift) t)``."""
        MPOprop = Mpo.exact_propagator(
            self.model, -1j * evolve_dt, space, shift - h_mpo.offset)
        new_mps = MPOprop.apply(self, canonicalise=True)
        new_mps.coeff = self.coeff * np.exp(-1j * h_mpo.offset * evolve_dt)
        return new_mps

    @adaptive_tdvp
    def _evolve_tdvp_ps(self, mpo, evolve_dt) -> "Mps":
        """One-site TDVP with projector splitting (PhysRevB.94.165116;
        reference ``mps.py:1267-1404``): two half-sweeps of site visits, each
        a forward Lanczos expm of the site, a QR split, and a backward
        Lanczos expm of the bond.  Real time makes the state complex;
        imaginary time (complex ``evolve_dt``) keeps a real state real.  An
        MpDm's 4-leg sites take the unfused visit (the fused one contracts
        3-leg sites), as in the JAX package."""
        if np.iscomplex(evolve_dt):
            mps = self.copy()
        else:
            mps = self.to_complex()
        if mps.is_complex:
            mpo = _complex_mpo_twin(mpo)
        environ = Environ(mps, mpo)
        for _ in range(2):
            for imps in mps.iter_idx_list(full=True):
                system = "L" if mps.to_right else "R"
                l_array = environ.read("L", imps - 1)
                r_array = environ.read("R", imps + 1)
                shape = list(mps[imps].shape)
                qnbigl, qnbigr, _ = mps._get_big_qn([imps])
                has_backward = (imps != len(mps) - 1) if mps.to_right else (imps != 0)
                m = int(np.prod(qnbigl.shape[:-1]))
                n = int(np.prod(qnbigr.shape[:-1]))
                k = min(m, n)
                use_fused = has_backward and mps[imps].ndim == 3
                sec = _trivial_sector(qnbigl, qnbigr, mps.qntot) if use_fused else None
                if use_fused and sec is None:
                    # qn-structured sites go fused as long as the kept axis
                    # is full rank (canonical MPS invariant: a bond never
                    # exceeds the product of its free legs); the 1-site QR
                    # then preserves the bond's qn assignment
                    use_fused = (n if mps.to_right else m) == k
                fused_out = None
                if use_fused:
                    nbr = imps + 1 if mps.to_right else imps - 1
                    fused_out = solvers.tdvp_ps_site_fused(
                        -1j * evolve_dt / 2, mps[imps], l_array, mpo[imps],
                        r_array, mps[nbr], tuple(shape), m, n,
                        mps.to_right,
                        qnbigl=None if sec is not None else qnbigl,
                        qnbigr=None if sec is not None else qnbigr,
                        qntot=mps.qntot,
                    )
                if fused_out is not None:
                    TDVP_PS_VISITS["fused"] += 1
                    site, new_env, new_nbr = fused_out
                    mps[imps] = site
                    mps[nbr] = new_nbr
                    qntot = np.atleast_1d(mps.qntot)
                    if mps.to_right:
                        if sec is not None:
                            mps.qn[imps + 1] = np.array([sec] * k)
                        else:
                            # the split preserves each bond state's quantum
                            # number, but the crossed bond's STORAGE flips
                            # convention (left-accumulated left of qnidx,
                            # complement right of it; see ``move_qnidx``)
                            mps.qn[imps + 1] = qntot[None, :] - np.asarray(mps.qn[imps + 1])
                        mps.qnidx = imps + 1
                        environ.write("L", imps, new_env)
                    else:
                        if sec is not None:
                            mps.qn[imps] = np.array([tuple(qntot - np.asarray(sec))] * k)
                        else:
                            mps.qn[imps] = qntot[None, :] - np.asarray(mps.qn[imps])
                        mps.qnidx = imps - 1
                        environ.write("R", imps, new_env)
                    continue
                TDVP_PS_VISITS["unfused"] += 1
                formula, operands = hop_spec(l_array, r_array, [mpo[imps]], shape)
                mps_t = solvers.expm_krylov_fused(
                    formula, operands, -1j * evolve_dt / 2, mps[imps])
                if not has_backward:
                    mps[imps] = mps_t
                    continue
                u, qnlset, v, qnrset = trunc_device.qr_qn_device(
                    mps_t, qnbigl, qnbigr, mps.qntot, system)
                vt = v.T  # a plain transpose
                if mps.to_right:
                    mps[imps] = u.reshape(shape[:-1] + [-1])
                    mps.qn[imps + 1] = np.array(qnlset)
                    mps.qnidx = imps + 1
                    l_array = environ.GetLR("L", imps, mps, mpo, itensor=l_array,
                                            method="System")
                    # backward evolution of the bond tensor
                    formula, operands = hop_spec(l_array, r_array, [], vt.shape)
                    mps_t = solvers.expm_krylov_fused(formula, operands, 1j * evolve_dt / 2, vt)
                    mps[imps + 1] = tensordot1(mps_t, mps[imps + 1])
                else:
                    mps[imps] = vt.reshape([-1] + shape[1:])
                    mps.qn[imps] = np.array(qnrset)
                    mps.qnidx = imps - 1
                    r_array = environ.GetLR("R", imps, mps, mpo, itensor=r_array,
                                            method="System")
                    formula, operands = hop_spec(l_array, r_array, [], u.shape)
                    mps_t = solvers.expm_krylov_fused(formula, operands, 1j * evolve_dt / 2, u)
                    mps[imps - 1] = tensordot1(mps[imps - 1], mps_t)
            mps._switch_direction()
        return mps


def normalize(tn, kind):
    """Normalization of an MPS (reference ``mps.py:2025-2059``)."""
    if kind == "mps_only":
        # the norm only rescales the state, so it stays on the device
        tn[tn.qnidx] = normalize_chain_device(list(tn), tn.qnidx)
        return tn
    tn_norm = tn.mp_norm
    if kind == "mps_and_coeff":
        new_coeff = tn.coeff / np.linalg.norm(tn.coeff)
    elif kind == "mps_norm_to_coeff":
        new_coeff = tn.coeff * tn_norm
    else:
        raise ValueError(f"kind={kind} is not valid.")
    tn.scale(1.0 / tn_norm, inplace=True)
    tn.coeff = new_coeff
    return tn


def expand_bond_dimension(mps, hint_mpo=None, coef=1e-10, include_ex=True):
    """Expand bond dimension up to the compress config, optionally steered by
    powers of a hint MPO (reference ``mps.py:1934-1960``)."""
    if hint_mpo is not None and include_ex:
        logger.debug(f"average bond dimension of hint mpo: {hint_mpo.bond_dims_mean}")
        if mps.is_mpdm:
            assert mps.qntot == 1
            ex_state = mps.max_entangled_ex(mps.model)
        else:
            ex_state = mps.ground_state(mps.model, False)
            assert mps.model.qn_size == 1
            for _ in range(int(mps.qntot[0])):
                ex_state = Mpo.onsite(mps.model, r"a^\dagger") @ ex_state
        ex_state.compress_config = mps.compress_config
        ex_state.move_qnidx(mps.qnidx)
        ex_state.to_right = mps.to_right
    else:
        ex_state = None
    return expand_bond_dimension_general(mps, hint_mpo, coef, ex_state)


def expand_bond_dimension_general(mps, hint_mpo=None, coef=1e-10, ex_mps=None):
    """Bond-dimension expander (reference ``mps.py:1963-2023``): add a small
    multiple of a state that spans the wanted bond dimensions (random, or
    the compressed powers of ``hint_mpo`` applied to the state), then
    compress back to the configured maximum."""
    mps.compress_config.set_bonddim(len(mps.bond_dims))
    m_target = np.minimum(
        np.array(mps.compress_config.max_dims) - np.array(mps.bond_dims),
        mps.bond_dims_exact,
    ).astype(int)
    logger.debug(f"target for expander: {m_target.tolist()}")

    if hint_mpo is None:
        expander = mps.__class__.random(mps.model, mps.qntot, m_target)
    else:
        lastone = mps if ex_mps is None else mps + ex_mps
        expander_list = []
        expander_dims = np.zeros_like(m_target)
        while True:
            lastone = (hint_mpo @ lastone).normalize("mps_and_coeff")
            lastone = lastone.canonicalise().compress(int(np.max(m_target)))
            expander_list.append(lastone)
            expander = compressed_sum(expander_list, temp_m_trunc=m_target)
            logger.debug(f"expander bond dimension: {expander.bond_dims}")
            if np.all(np.array(expander.bond_dims) >= m_target):
                break
            if np.all(np.array(expander.bond_dims) == expander_dims):
                logger.warning("Expander does not increase anymore.")
                m2 = int(np.max(m_target - expander_dims))
                expander2 = (hint_mpo @ lastone).canonicalise().compress(max(m2, 1))
                expander = expander + expander2
                break
            expander_dims = np.array(expander.bond_dims)
            trunc = int(np.max(m_target) / np.max(hint_mpo.bond_dims)) + 1
            lastone = lastone.canonicalise().compress(trunc)
    return (
        (mps + expander.scale(coef * mps.norm, inplace=True))
        .canonicalise()
        .compress(mps.compress_config.max_dims)
        .normalize("mps_norm_to_coeff")
    )


def _normalize_mpo_t(mpo):
    """Uniform interface for time-dependent Hamiltonians: ``mpo_t(t)``."""
    if isinstance(mpo, Mpo):
        return lambda t, *args, **kwargs: mpo
    if callable(mpo):
        return mpo
    raise TypeError(f"unsupported mpo type: {mpo}")


class BraKetPair:
    """A bra/ket pair with its transition amplitude ``ft``
    (reference ``mps.py:2061-2088``)."""

    def __init__(self, bra_mps, ket_mps, mpo=None):
        self.bra_mps = bra_mps
        self.ket_mps = ket_mps
        self.mpo = mpo
        self.ft = self.calc_ft()

    def calc_ft(self):
        if self.mpo is None:
            dot = self.bra_mps.conj().dot(self.ket_mps)
        else:
            dot = self.ket_mps.expectation(self.mpo, self.bra_mps.conj())
        return complex(dot * np.conjugate(self.bra_mps.coeff) * self.ket_mps.coeff)

    def __str__(self):
        sign = "+" if 0 <= self.ft.imag else ""
        ft_str = "%g%s%gj" % (self.ft.real, sign, self.ft.imag)
        return "bra: %s, ket: %s, ft: %s" % (self.bra_mps, self.ket_mps, ft_str)

    def __iter__(self):
        return iter((self.bra_mps, self.ket_mps))


def min_abs(t1, t2):
    """The argument with smaller magnitude (signs preserved)."""
    assert np.iscomplex(t1) == np.iscomplex(t2)
    return t1 if np.absolute(t1) < np.absolute(t2) else t2
