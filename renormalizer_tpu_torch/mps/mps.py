r"""Matrix product states: construction, measurement and time evolution.

Port of ``renormalizer_tpu/mps/mps.py`` (reference
``renormalizer/mps/mps.py:118-2169``): the constructors, normalization,
measurements (expectations with the shared-environment cache, reduced
density matrices, entropies), bond-dimension expansion, all eight
evolution methods — one- and two-site projector-splitting TDVP
(PhysRevB.94.165116), the variable and constant mean-field TDVP with the
matrix-unfolding regularization (arXiv:1907.12044), the propagate-and-
compress family (Taylor, RK4 and Butcher-tableau RK, fixed or adaptive) —
the exact local propagation and ``BraKetPair``.
"""

import itertools
import logging
from collections import Counter, deque
from functools import reduce, wraps
from typing import Dict, List, Union

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
from renormalizer_tpu_torch.mps.trunc_device import _double
from renormalizer_tpu_torch.ops.contract import (
    contract_one_site,
    einsum,
    hop_expr,
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
    calc_vn_entropy_dm,
)
from renormalizer_tpu_torch.utils.profiling import COUNTERS, maybe_profile, span

logger = logging.getLogger(__name__)

# Site visits of ``_evolve_tdvp_ps`` by branch are counted in
# ``utils.profiling.COUNTERS``: ``tdvp.visits.fused`` (the fused visit,
# :func:`solvers.tdvp_ps_site_fused`) and ``tdvp.visits.unfused`` (the last
# site of each half-sweep, and every site the fused visit declines).


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
    def ground_state(cls, model: Model, max_entangled: bool, normalize: bool = True,
                     condition: Dict = None):
        r"""T=0 or T=inf (max-entangled) product state
        (reference ``mps.py:258-350``).  A ``BasisMultiElectron`` site takes
        its local state from ``condition`` (DoF -> state index or
        amplitudes), which must carry quantum number 0."""
        mps = cls()
        mps.model = model
        mps.qn = [np.zeros((1, model.qn_size), dtype=int)] * (model.nsite + 1)
        mps.qnidx = model.nsite - 1
        mps.to_right = False
        mps.qntot = np.zeros(model.qn_size, dtype=int)
        mps.build_empty_mp(model.nsite)

        site_condition = {}
        if condition is not None:
            for key, value in condition.items():
                idx = model.dof_to_siteidx[key]
                assert idx not in site_condition
                site_condition[idx] = value

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
            elif isinstance(local_basis, ba.BasisMultiElectron):
                assert condition is not None
                local_state = site_condition.pop(isite)
                if isinstance(local_state, int):
                    ms[0, local_state, 0] = 1.0
                    qn = local_basis.sigmaqn[local_state]
                else:
                    ms[0, :, 0] = local_state
                    qn = local_basis.sigmaqn[np.nonzero(local_state)]
                assert np.allclose(qn, 0)
                if max_entangled and normalize:
                    ms /= np.linalg.norm(ms)
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
    def nexciton(self):
        return self.qntot

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

    def _expectation_conj(self):
        return self.conj()

    def expectation(self, mpo, self_conj: "Mps" = None) -> Union[float, complex]:
        r"""<self_conj| mpo |self> (reference ``mps.py:471-525``)."""
        if isinstance(mpo, (Op, OpSum)):
            mpo = Mpo(self.model, mpo)
        if self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        if self_conj is None:
            self_conj = self._expectation_conj()
        environ = Environ(self, mpo, "R", mps_conj=self_conj)
        r = environ.read("R", 1)
        val = complex(einsum(self._expectation_path(), environ.sentinel, self[0],
                             mpo[0], self_conj[0], r).item())
        if np.isclose(val.imag, 0):
            return val.real
        return val

    def expectations(self, mpos, self_conj: "Mps" = None, opt: bool = True) -> np.ndarray:
        """Many expectations of one state (reference ``mps.py:527-575``,
        cache ``mps.py:2103-2169``).  Environments of the MPO site prefixes
        (from the left) and suffixes (from the right) that more than one MPO
        shares are contracted once, keyed by the sites' content digests (so
        independently built identical MPOs share them; a site written from
        a device tensor is keyed by identity).  All values are read back
        together.  ``opt=False`` is the plain loop of ``expectation``."""
        mpos = [Mpo(self.model, mpo) if isinstance(mpo, (Op, OpSum)) else mpo
                for mpo in mpos]
        if self_conj is None:
            self_conj = self._expectation_conj()
        if not opt:
            results = np.array([complex(self.expectation(mpo, self_conj))
                                for mpo in mpos])
        else:
            hash_to_obj = {}
            mpos_hash: List[List] = []
            for mpo in mpos:
                mpo_hash = []
                hashes = mpo._mt_hashes
                for i, m in enumerate(mpo):
                    key = hashes[i] if i < len(hashes) and hashes[i] is not None else id(m)
                    hash_to_obj[key] = m
                    mpo_hash.append(key)
                mpos_hash.append(mpo_hash)
            l_envs = _construct_freq_environ(mpos_hash, hash_to_obj, self, "L", self_conj)
            r_envs = _construct_freq_environ(mpos_hash, hash_to_obj, self, "R", self_conj)
            values = []
            for mpo, mpo_hash in zip(mpos, mpos_hash):
                l_env, l_idx = _get_freq_environ(l_envs, mpo_hash, "L", np.inf)
                r_env, r_idx = _get_freq_environ(r_envs, mpo_hash, "R",
                                                 len(mpo) - l_idx - 1)
                for i in range(l_idx + 1, r_idx):
                    l_env = contract_one_site(l_env, self[i], mpo[i], "L", self_conj[i])
                values.append(torch.sum(l_env.reshape(-1) * r_env.reshape(-1))
                              .to(torch.complex128))
            results = torch.stack(values).cpu().numpy() if values else np.zeros(0)
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
            if ms.ndim == 3:
                t = torch.tensordot(t, ms, dims=([0, -1], [0, -1]))
            else:
                t = torch.tensordot(t, ms, dims=([0, -1, -2], [0, -1, -2]))
            t = to_numpy(t)
            assert np.allclose(t, t.conj().T, atol=1e-6)
            rdm[ims] = t
        return rdm

    def calc_2site_rdm(self) -> Dict:
        r"""2-site reduced density matrices, keyed by ``(i, j)``, i < j
        (reference ``mps.py:1600-1655``)."""
        identity = Mpo.identity(self.model)
        environ_R = Environ(self, identity, "R")
        environ_L = Environ(self, identity, "L")
        L_comp, R_comp = [], []
        for ims, ms in enumerate(self):
            lt = environ_L.GetLR("L", ims - 1, self, identity, method="Enviro")
            lt = lt.reshape(lt.shape[0], lt.shape[-1]).to(ms.dtype)
            t = torch.tensordot(lt, ms.conj(), dims=([0], [0]))
            if ms.ndim == 3:
                t = torch.tensordot(t, ms, dims=([0], [0]))
            else:
                t = torch.tensordot(t, ms, dims=([0, 2], [0, 2]))
            L_comp.append(t.permute(0, 2, 1, 3))
            rt = environ_R.GetLR("R", ims + 1, self, identity, method="Enviro")
            rt = rt.reshape(rt.shape[0], rt.shape[-1]).to(ms.dtype)
            t = torch.tensordot(ms.conj(), rt, dims=([ms.ndim - 1], [0]))
            if ms.ndim == 3:
                t = torch.tensordot(t, ms, dims=([2], [2]))
            else:
                t = torch.tensordot(t, ms, dims=([2, 3], [2, 3]))
            R_comp.append(t.permute(0, 2, 1, 3))

        rdm = {}
        for ims in range(self.site_num):
            tensor = L_comp[ims]
            for jms in range(ims + 1, self.site_num):
                if jms != ims + 1:
                    kms = jms - 1
                    tensor = torch.tensordot(tensor, self[kms].conj(), dims=([2], [0]))
                    if self[kms].ndim == 3:
                        tensor = torch.tensordot(tensor, self[kms], dims=([2, 3], [0, 1]))
                    else:
                        tensor = torch.tensordot(tensor, self[kms],
                                                 dims=([2, 3, 4], [0, 1, 2]))
                res = torch.tensordot(tensor, R_comp[jms],
                                      dims=([2, 3], [0, 1])).permute(0, 2, 1, 3)
                rdm[(ims, jms)] = to_numpy(res.reshape(res.shape[0] * res.shape[1], -1))
        return rdm

    def calc_edof_rdm(self) -> np.ndarray:
        r"""<a_i^dagger a_j> over the electronic DoFs
        (reference ``mps.py:1657-1687``)."""
        key = "edof_reduced_density_matrix"
        n_e = self.model.n_edofs
        e_dofs = self.model.e_dofs
        if key not in self.model.mpos:
            mpos = []
            for idx, dof1 in enumerate(e_dofs):
                for dof2 in e_dofs[idx:]:
                    mpos.append(Mpo(self.model, terms=Op(r"a^\dagger a", [dof1, dof2])))
            self.model.mpos[key] = mpos
        expectations = deque(self.expectations(self.model.mpos[key]))
        rdm = np.zeros((n_e, n_e), dtype=np.complex128)
        for i in range(n_e):
            for j in range(i, n_e):
                rdm[i, j] = expectations.popleft()
                rdm[j, i] = np.conj(rdm[i, j])
        return rdm

    def calc_entropy(self, entropy_type):
        """``"1site"``, ``"2site"``, ``"mutual"`` or ``"bond"`` Von Neumann
        entropy (reference ``mps.py:1689-1732``)."""
        if entropy_type in ("1site", "2site"):
            rdm = self.calc_1site_rdm() if entropy_type == "1site" else self.calc_2site_rdm()
            return {key: calc_vn_entropy_dm(dm) for key, dm in rdm.items()}
        if entropy_type == "mutual":
            return self.calc_2site_mutual_entropy()
        if entropy_type == "bond":
            return self.calc_bond_entropy()
        raise ValueError(f"unsupported entropy type {entropy_type}")

    def calc_2site_mutual_entropy(self) -> np.ndarray:
        """Mutual information m_ij = (s_i + s_j - s_ij) / 2
        (Chemical Physics 323 (2006) 519; reference ``mps.py:1734-1757``)."""
        e1 = self.calc_entropy("1site")
        e2 = self.calc_entropy("2site")
        n = self.site_num
        mut = np.zeros((n, n))
        for i, j in itertools.combinations(range(n), 2):
            mut[i, j] = (e1[i] + e1[j] - e2[(i, j)]) / 2
        return mut + mut.T

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
        with maybe_profile("evolve"), span("tdvp.step"):
            out = self._evolve(mpo, evolve_dt, normalize)
            solvers.end_graph_step()
        return out

    def _evolve(self, mpo, evolve_dt, normalize):
        method = self.evolve_config.method
        evolve = {
            EvolveMethod.prop_and_compress: self._evolve_prop_and_compress,
            EvolveMethod.prop_and_compress_tdrk4: self._evolve_prop_and_compress_tdrk4,
            EvolveMethod.prop_and_compress_tdrk: self._evolve_prop_and_compress_tdrk,
            EvolveMethod.tdvp_mu_vmf: self._evolve_tdvp_mu_vmf,
            EvolveMethod.tdvp_vmf: self._evolve_tdvp_mu_vmf,
            EvolveMethod.tdvp_mu_cmf: self._evolve_tdvp_mu_cmf,
            EvolveMethod.tdvp_ps: self._evolve_tdvp_ps,
            EvolveMethod.tdvp_ps2: self._evolve_tdvp_ps2,
        }[method]
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
                with span("tdvp.visit"):
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
                        COUNTERS["tdvp.visits.fused"] += 1
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
                    COUNTERS["tdvp.visits.unfused"] += 1
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

    @adaptive_tdvp
    def _evolve_tdvp_ps2(self, mpo, evolve_dt) -> "Mps":
        """Two-site TDVP with projector splitting and bond-adaptive
        truncation (reference ``mps.py:1406-1517``): each visit evolves the
        two-site tensor forward by a Lanczos expm, truncates it by the
        compress config (``_update_mps``: a real Gram goes to the Jacobi
        kernel, a complex one to ``torch.linalg.eigh``, counted in
        ``trunc.linalg_eigh_grams``) and evolves the kept site
        backward.  With ``compress_config.ofs`` the update may swap the two
        DoFs (``_ofs_select``), and the MPO follows (``try_swap_site``)."""
        if np.iscomplex(evolve_dt):
            mps = self.copy()
        else:
            mps = self.to_complex()
        if mps.is_complex:
            mpo = _complex_mpo_twin(mpo)
        environ = Environ(mps, mpo)
        for _ in range(2):
            for imps in mps.iter_idx_list(full=False):
                if mps.to_right:
                    lidx, cidx0, cidx1, ridx = imps - 1, imps, imps + 1, imps + 2
                    cidx2 = cidx1
                    last_idx = len(mps) - 2
                else:
                    lidx, cidx0, cidx1, ridx = imps - 2, imps - 1, imps, imps + 1
                    cidx2 = cidx0
                    last_idx = 1
                l_array = environ.read("L", lidx)
                r_array = environ.read("R", ridx)
                ms2 = tensordot1(mps[cidx0], mps[cidx1])
                formula, operands = hop_spec(l_array, r_array,
                                             [mpo[cidx0], mpo[cidx1]], ms2.shape)
                mps_t = solvers.expm_krylov_fused(formula, operands,
                                                  -1j * evolve_dt / 2, ms2)
                qnbigl, qnbigr, _ = mps._get_big_qn([cidx0, cidx1])
                mps._update_mps(mps_t, [cidx0, cidx1], qnbigl, qnbigr)
                if mps.compress_config.ofs is not None:
                    mpo.try_swap_site(mps.model, mps.compress_config.ofs_swap_jw)
                if imps == last_idx:
                    continue
                if mps.to_right:
                    l_array = environ.GetLR("L", lidx + 1, mps, mpo, itensor=l_array,
                                            method="System")
                else:
                    r_array = environ.GetLR("R", ridx - 1, mps, mpo, itensor=r_array,
                                            method="System")
                ms1 = mps[cidx2]
                formula, operands = hop_spec(l_array, r_array, [mpo[cidx2]], ms1.shape)
                mps[cidx2] = solvers.expm_krylov_fused(formula, operands,
                                                       1j * evolve_dt / 2, ms1)
                mps._push_cano(cidx2)
            mps._switch_direction()
        return mps

    def _evolve_tdvp_mu_vmf(self, mpo, evolve_dt) -> "Mps":
        """TDVP variable mean field, for ``tdvp_mu_vmf`` and ``tdvp_vmf``
        (arXiv:1907.12044; reference ``mps.py:887-1094``): one adaptive
        RKF45 (``solvers.solve_ivp``) over the qn-masked coefficients of
        all sites, whose right-hand side projects each site's H|psi> on the
        tangent space and applies a regularized inverse of the reduced
        density matrix of the sites to its right.

        ``tdvp_mu_vmf`` takes that inverse from the matrix unfolding: each
        right unfolding of a copy of the state is factorized by
        ``trunc_device.compress_factors`` (real Grams on the Jacobi kernel,
        on every right-hand side) and ``u diag(s)`` is carried to the left
        neighbour.  ``tdvp_vmf`` eigen-decomposes the right overlap ``S_R``.
        With ``vmf_auto_switch`` the state switches between them by the
        smallest singular value (eigenvalue) of the last right-hand side;
        those minima stay on the device and are read once, after the
        solve.

        The integration runs in double precision whatever the working
        precision, and the result is cast back.  The regularized inverse
        amplifies the right-hand side along the bond's padding directions
        (1/reg(s) ~ 1e5 in MU-VMF, up to 1e10 in VMF), so in single
        precision rounding becomes noise in the right-hand side and the
        RKF45 controller shrinks the step: on the 3-molecule chain of
        ``tests/test_evolve.py`` on the CPU in fp32 one step of 1.0 of VMF
        integrated in single precision does not reach its end in 2000
        right-hand sides, MU-VMF takes 290 (and did not finish in 15
        minutes while the truncation's QRs and complex Gram eigh ran in
        single precision, ``trunc_device._qr``/``gram_eigh``); integrated
        in double precision they take 314 and 212, as in fp64.  Real Grams
        then reach the Jacobi kernel's f64 path,
        complex ones ``torch.linalg.eigh`` in complex128."""
        if not np.iscomplex(evolve_dt) or self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        config = self.evolve_config
        imag_time = np.iscomplex(evolve_dt)
        if imag_time:
            evolve_dt = -evolve_dt.imag
            coef = -1
        else:
            coef = 1j

        if not (config.force_ovlp and not self.to_right):
            self.ensure_left_canonical()
        mps = self.copy() if imag_time else self.to_complex()
        # integrate in double precision (see the docstring)
        narrow = mps.dtype
        _retype(mps, _double(mps[0]).dtype)
        if isinstance(mpo, Mpo):
            mpo = _double_mpo_twin(mpo)
        mpo_t = _normalize_mpo_t(mpo)
        qn_mask_list, mask_idx_list, position = _site_masks(mps)
        mu = config.method == EvolveMethod.tdvp_mu_vmf
        last = mps.site_num - 1
        sw_min_list = []

        def func_vmf(t, y):
            sw_min_list.clear()
            for imps in range(mps.site_num):
                mps[imps] = _masked_to_site(y[position[imps]:position[imps + 1]],
                                            mask_idx_list[imps], qn_mask_list[imps].shape)
            mpo_now = mpo_t(t, mps=mps)
            if mu:
                environ_mps = mps.copy()
            else:
                environ_mps = mps
                S_R = torch.ones((1, 1), dtype=mps[0].dtype, device=mps[0].device)
            environ = Environ(environ_mps, mpo_now, "L")
            S_L_list, S_L_inv_list = _left_overlaps(mps, config.force_ovlp)

            hop_y = [None] * mps.site_num
            for imps in mps.iter_idx_list(full=True):
                shape = list(mps[imps].shape)
                ltensor = environ.read("L", imps - 1)
                if imps == last:
                    # coefficient site: no projector
                    rtensor = torch.ones((1, 1, 1), dtype=mps[0].dtype, device=mps[0].device)
                    S_inv = torch.eye(1, dtype=mps[0].dtype, device=mps[0].device)
                    islast = True
                else:
                    islast = False
                    if mu:
                        rtensor, S_inv, s_min = _mu_gauge_step(
                            environ, environ_mps, mpo_now, imps, config.reg_epsilon)
                    else:
                        rtensor = environ.GetLR("R", imps + 1, environ_mps, mpo_now,
                                                method="System")
                        S_R = transferMat(environ_mps, None, "R", imps + 1, S_R)
                        w, u = torch.linalg.eigh(S_R)
                        w = torch.clamp(w, min=0)
                        s_min = w.min()
                        epsilon = config.reg_epsilon
                        w = w + epsilon * torch.exp(-w / epsilon)
                        S_inv = ((u * (1.0 / w)[None, :]) @ u.mH).T
                    sw_min_list.append(s_min)
                hop = hop_expr(ltensor, rtensor, [mpo_now[imps]], shape)
                func = integrand_func_factory(
                    shape, hop, islast, S_inv, True, coef,
                    ovlp_inv1=S_L_inv_list[imps + 1],
                    ovlp_inv0=S_L_inv_list[imps], ovlp0=S_L_list[imps])
                hop_y[imps] = func(0, mps[imps].reshape(-1))[mask_idx_list[imps]]
            return torch.cat(hop_y)

        init_y = torch.cat([mps[i].reshape(-1)[mask_idx_list[i]]
                            for i in range(mps.site_num)])
        sol = solvers.solve_ivp(func_vmf, (0, evolve_dt), init_y,
                                rtol=config.ivp_rtol, atol=config.ivp_atol)
        for imps in range(mps.site_num):
            mps[imps] = _masked_to_site(sol.y[position[imps]:position[imps + 1]],
                                        mask_idx_list[imps], qn_mask_list[imps].shape)
        _retype(mps, narrow)
        logger.info(f"{config.method} VMF func called: {sol.nfev}. "
                    f"RKF steps: {sol.nsteps}")

        if config.vmf_auto_switch and sw_min_list:
            sw_min = _smallest(sw_min_list)
            if (sw_min > np.sqrt(config.reg_epsilon * 10.0)
                    and mps.evolve_config.method == EvolveMethod.tdvp_mu_vmf):
                logger.debug(f"sw.min={sw_min}, switch to tdvp_vmf")
                mps.evolve_config.method = EvolveMethod.tdvp_vmf
            elif (sw_min < config.reg_epsilon
                    and mps.evolve_config.method == EvolveMethod.tdvp_vmf):
                logger.debug(f"sw.min={sw_min}, switch to tdvp_mu_vmf")
                mps.evolve_config.method = EvolveMethod.tdvp_mu_vmf
        return mps.canonicalise()

    @adaptive_tdvp
    def _evolve_tdvp_mu_cmf(self, mpo, evolve_dt) -> "Mps":
        """TDVP constant mean field with the matrix-unfolding
        regularization, second order through midpoint environments
        (reference ``mps.py:1096-1265``).  Each site but the last integrates
        its own equation of motion by RKF45 in the environments of the
        midpoint state; the last site (no projector) by Lanczos
        (``ivp_solver="krylov"``) or RKF45.

        The JAX package factorizes each right unfolding with the host
        ``svd_qn``; the port takes ``trunc_device.compress_factors``, as
        MU-VMF does, with no host round trip per site beyond the spectrum.
        The factors enter only through ``u diag(s)`` and ``diag(1/reg(s))
        u^H``, and ``u diag(s) diag(1/reg(s)) u^H`` does not change under
        the unitary freedom of the SVD (a phase or rotation within a block
        of equal singular values), so the evolved state is the JAX
        package's; real Grams then reach the Jacobi kernel."""
        if not np.iscomplex(evolve_dt) or self.is_complex:
            mpo = _complex_mpo_twin(mpo)
        config = self.evolve_config
        if config.tdvp_cmf_c_trapz:
            assert config.tdvp_cmf_midpoint
        imag_time = np.iscomplex(evolve_dt)
        if imag_time:
            evolve_dt = -evolve_dt.imag
            coef = -1
        else:
            coef = 1j

        self.ensure_left_canonical()
        mps = self.copy() if imag_time else self.to_complex()

        if config.tdvp_cmf_midpoint:
            orig_config = config.copy()
            self.evolve_config.tdvp_cmf_midpoint = False
            self.evolve_config.tdvp_cmf_c_trapz = False
            self.evolve_config.adaptive = False
            environ_mps = self.evolve(mpo, evolve_dt / 2)
            # the half step ran on the mutated config; read the flags below
            # from the restored one
            self.evolve_config = config = orig_config
        else:
            environ_mps = mps.copy()

        if config.tdvp_cmf_c_trapz:
            loop = 2
            mps[-1] = environ_mps[-1]
        else:
            loop = 1

        last = mps.site_num - 1
        while loop > 0:
            environ = Environ(environ_mps, mpo, "L")
            cmf_rk_steps = []
            S_L_list, S_L_inv_list = _left_overlaps(environ_mps, config.force_ovlp)
            for imps in mps.iter_idx_list(full=True):
                shape = list(mps[imps].shape)
                ltensor = environ.read("L", imps - 1)
                if imps == last:
                    if loop == 1:
                        rtensor = torch.ones((1, 1, 1), dtype=mps[0].dtype,
                                             device=mps[0].device)
                        hop = hop_expr(ltensor, rtensor, [mpo[imps]], shape)
                        S_inv = torch.eye(1, dtype=mps[0].dtype, device=mps[0].device)
                        func = integrand_func_factory(
                            shape, hop, True, S_inv, True, coef,
                            ovlp_inv1=S_L_inv_list[imps + 1],
                            ovlp_inv0=S_L_inv_list[imps], ovlp0=S_L_list[imps])
                        if config.ivp_solver == "krylov":
                            # func = (hermitian action) / coef; fold coef into
                            # dt so the Lanczos operator stays hermitian
                            ms, j = solvers.expm_krylov(
                                lambda y: coef * func(0, y), evolve_dt / coef,
                                mps[imps].reshape(-1))
                            cmf_rk_steps.append(int(j))
                        else:
                            sol = solvers.solve_ivp(
                                func, (0, evolve_dt), mps[imps].reshape(-1),
                                rtol=config.ivp_rtol, atol=config.ivp_atol)
                            ms = sol.y
                            cmf_rk_steps.append(sol.nfev)
                        mps[imps] = ms.reshape(shape)
                    if loop == 1 and config.tdvp_cmf_c_trapz:
                        break
                    continue

                rtensor, S_inv, _ = _mu_gauge_step(environ, environ_mps, mpo, imps,
                                                   config.reg_epsilon)
                hop = hop_expr(ltensor, rtensor, [mpo[imps]], shape)
                func = integrand_func_factory(
                    shape, hop, False, S_inv, True, coef,
                    ovlp_inv1=S_L_inv_list[imps + 1],
                    ovlp_inv0=S_L_inv_list[imps], ovlp0=S_L_list[imps])
                # SciPy's default tolerances, as the reference
                sol = solvers.solve_ivp(func, (0, evolve_dt), mps[imps].reshape(-1))
                cmf_rk_steps.append(sol.nsteps)
                mps[imps] = sol.y.reshape(shape)

            if cmf_rk_steps:
                logger.debug(f"{config.method} CMF steps: max {max(cmf_rk_steps)}")
            if loop == 2:
                environ_mps = mps
                evolve_dt /= 2.0
            loop -= 1
        return mps


def normalize(tn, kind):
    """Normalization of an MPS or a TTNS (reference ``mps.py:2025-2059``);
    a TTNS (no ``mp_norm``) takes its norm from ``ttns_norm``, and the
    ``ttns_*`` kinds mean the same as the ``mps_*`` ones."""
    if kind == "mps_only" and hasattr(tn, "mp_norm"):
        # the norm only rescales the state, so it stays on the device
        tn[tn.qnidx] = normalize_chain_device(list(tn), tn.qnidx)
        return tn
    tn_norm = tn.mp_norm if hasattr(tn, "mp_norm") else tn.ttns_norm
    if kind in ("mps_only", "ttns_only"):
        new_coeff = tn.coeff
    elif kind in ("mps_and_coeff", "ttns_and_coeff"):
        new_coeff = tn.coeff / np.linalg.norm(tn.coeff)
    elif kind in ("mps_norm_to_coeff", "ttns_norm_to_coeff"):
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
    compress back to the configured maximum.  Shared with the tree engine:
    a TTNS (``tn.tree.TTNS``, no ``model``) draws its random expander on its
    ``basis`` tree."""
    mps.compress_config.set_bonddim(len(mps.bond_dims))
    m_target = np.minimum(
        np.array(mps.compress_config.max_dims) - np.array(mps.bond_dims),
        mps.bond_dims_exact,
    ).astype(int)
    logger.debug(f"target for expander: {m_target.tolist()}")

    if hint_mpo is None:
        expander = mps.__class__.random(
            mps.model if hasattr(mps, "model") else mps.basis, mps.qntot, m_target)
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


# --- VMF/CMF helpers ---------------------------------------------------------

def _retype(mp, dtype):
    """Cast every site of ``mp`` to ``dtype``, in place."""
    mp.dtype = dtype
    for i in range(mp.site_num):
        mp[i] = mp[i]


def _double_mpo_twin(mpo):
    """Cached double-precision twin of an MPO (itself in double precision)."""
    wide = _double(mpo[0]).dtype
    if mpo[0].dtype == wide:
        return mpo
    twin = getattr(mpo, "_double_twin", None)
    if twin is None:
        twin = mpo.copy()
        _retype(twin, wide)
        mpo._double_twin = twin
    return twin


def _site_masks(mps):
    """Static quantum-number masks of every site (host), the flat indices
    they keep (device, uploaded once per step) and the sites' offsets in
    the flat coefficient vector.  Leaves ``mps.qnidx`` at the last site."""
    qn_mask_list, mask_idx_list, position = [], [], [0]
    for imps in range(mps.site_num):
        mps.move_qnidx(imps)
        _, _, qnmat = mps._get_big_qn([imps])
        qn_mask = get_qn_mask(qnmat, mps.qntot)
        qn_mask_list.append(qn_mask)
        mask_idx_list.append(backend.tensor(np.nonzero(qn_mask.ravel())[0]))
        position.append(position[-1] + int(np.sum(qn_mask)))
    return qn_mask_list, mask_idx_list, position


def _masked_to_site(c: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """Scatter a qn-masked flat vector back into the dense site tensor
    (``cvec2cmat`` with the kept indices already on the device: a boolean
    mask, or an upload, would make every right-hand side wait for it)."""
    full = torch.zeros(int(np.prod(shape)), dtype=c.dtype, device=c.device)
    full[idx] = c
    return full.reshape(shape)


def _left_overlaps(mps, force_ovlp: bool):
    """With ``force_ovlp``: the left overlaps ``S_L`` of every bond (unity
    for a left-canonical state) and their inverses, by ``torch.linalg.eigh``;
    otherwise lists of ``None``."""
    if not force_ovlp:
        return [None] * (mps.site_num + 1), [None] * (mps.site_num + 1)
    S_L_list = [torch.ones((1, 1), dtype=mps[0].dtype, device=mps[0].device)]
    for imps in range(mps.site_num):
        S_L_list.append(transferMat(mps, None, "L", imps, S_L_list[imps]))
    S_L_inv_list = []
    for S_L in S_L_list:
        w, u = torch.linalg.eigh(S_L)
        S_L_inv_list.append((u * (1.0 / w)[None, :]) @ u.mH)
    return S_L_list, S_L_inv_list


def _mu_gauge_step(environ, environ_mps, mpo, imps, reg_epsilon):
    """One step of the matrix-unfolding gauge sweep (right to left): factor
    the right unfolding of site ``imps + 1`` of ``environ_mps`` as
    ``u diag(s) v^T`` (``trunc_device.compress_factors``, exact), keep
    ``v^T`` there and its right environment, and carry ``u diag(s)`` into
    site ``imps``.  Returns that environment with ``u diag(s)`` on its ket
    leg, the regularized inverse ``(u^* diag(1/reg(s)))^T`` and ``min(s)``
    (a host float: the singular values are on the host already)."""
    qnbigl, qnbigr, _ = environ_mps._get_big_qn([imps + 1])
    u, s, _, v, _, qnrset = trunc_device.compress_factors(
        environ_mps[imps + 1], qnbigl, qnbigr, environ_mps.qntot, "R")
    environ_mps[imps + 1] = v.T.reshape(environ_mps[imps + 1].shape)
    rtensor = environ.GetLR("R", imps + 1, environ_mps, mpo, method="System")
    s_dev = backend.tensor(s, dtype=u.real.dtype)
    us = u * s_dev[None, :].to(u.dtype)
    rtensor = torch.tensordot(rtensor, us, dims=([2], [1]))
    environ_mps[imps] = torch.tensordot(environ_mps[imps], us,
                                        dims=([environ_mps[imps].ndim - 1], [0]))
    environ_mps.qn[imps + 1] = np.array(qnrset)
    environ_mps.qnidx = imps
    regular_s = _mu_regularize(s_dev, epsilon=reg_epsilon)
    S_inv = (u.conj() * (1.0 / regular_s)[None, :].to(u.dtype)).T
    return rtensor, S_inv, float(np.min(s))


def _smallest(values) -> float:
    """The least of host floats and 0-d device tensors, with one read of
    the device ones."""
    host = [v for v in values if not isinstance(v, torch.Tensor)]
    dev = [v for v in values if isinstance(v, torch.Tensor)]
    res = min(host, default=np.inf)
    if dev:
        res = min(res, float(torch.stack(dev).min()))
    return res


def projector(ms, left: bool, Ovlp_inv1=None, Ovlp0=None):
    """Tangent-space projector ``1 - |ms><ms|``, optionally in a
    non-orthogonal metric (reference ``mps.py:1819-1846``)."""
    last = ms.ndim - 1
    if Ovlp_inv1 is None:
        dims = ([last], [last]) if left else ([0], [0])
        proj = torch.tensordot(ms, ms.conj(), dims=dims)
    elif left:
        proj = torch.tensordot(Ovlp0, ms, dims=([1], [0]))
        proj = torch.tensordot(proj, Ovlp_inv1, dims=([last], [0]))
        proj = torch.tensordot(proj, ms.conj(), dims=([last], [last]))
    else:
        proj = torch.tensordot(ms, Ovlp0, dims=([last], [0]))
        proj = torch.tensordot(Ovlp_inv1, proj, dims=([1], [0]))
        proj = torch.tensordot(proj, ms.conj(), dims=([0], [0]))
    sz = int(np.prod(ms.shape[:-1])) if left else int(np.prod(ms.shape[1:]))
    eye = torch.eye(sz, dtype=proj.dtype, device=proj.device).reshape(proj.shape)
    return eye - proj


def integrand_func_factory(shape, hop, islast, S_inv, left: bool, coef,
                           ovlp_inv1=None, ovlp_inv0=None, ovlp0=None):
    """Equation-of-motion right-hand side of one site in VMF/CMF evolution
    (reference ``mps.py:1849-1889``), for 3-leg (MPS) and 4-leg (MpDm)
    sites.  The JAX package's ``jit_compile`` has no counterpart: PyTorch
    runs it eagerly."""

    def func(t, y):
        y0 = y.reshape(shape)
        HC = hop(y0)
        if not islast:
            proj = projector(y0, left, ovlp_inv1, ovlp0)
            if y0.ndim == 3:
                if left:
                    HC = torch.tensordot(proj, HC, dims=([2, 3], [0, 1]))
                else:
                    HC = torch.tensordot(HC, proj, dims=([1, 2], [2, 3]))
            elif y0.ndim == 4:
                if left:
                    HC = torch.tensordot(proj, HC, dims=([3, 4, 5], [0, 1, 2]))
                else:
                    HC = torch.tensordot(HC, proj, dims=([1, 2, 3], [3, 4, 5]))
        last = HC.ndim - 1
        if left:
            if ovlp_inv0 is not None:
                HC = torch.tensordot(ovlp_inv0, HC, dims=([1], [0]))
            return torch.tensordot(HC, S_inv.to(HC.dtype), dims=([last], [0])).reshape(-1) / coef
        if ovlp_inv0 is not None:
            HC = torch.tensordot(HC, ovlp_inv0, dims=([last], [1]))
        return torch.tensordot(S_inv.to(HC.dtype), HC, dims=([0], [0])).reshape(-1) / coef

    return func


def transferMat(mps, mpsconj, domain, imps, val):
    """One-site transfer-matrix update (reference ``mps.py:1892-1923``)."""
    ms = mps[imps]
    ms_conj = mpsconj[imps] if mpsconj is not None else ms.conj()
    if ms.ndim == 3:
        if domain == "R":
            val = torch.tensordot(ms_conj, val, dims=([2], [0]))
            val = torch.tensordot(val, ms, dims=([1, 2], [1, 2]))
        elif domain == "L":
            val = torch.tensordot(ms_conj, val, dims=([0], [0]))
            val = torch.tensordot(val, ms, dims=([0, 2], [1, 0]))
        else:
            raise AssertionError
    elif ms.ndim == 4:
        if domain == "R":
            val = torch.tensordot(ms_conj, val, dims=([3], [0]))
            val = torch.tensordot(val, ms, dims=([1, 2, 3], [1, 2, 3]))
        elif domain == "L":
            val = torch.tensordot(ms_conj, val, dims=([0], [0]))
            val = torch.tensordot(val, ms, dims=([0, 3, 1], [1, 0, 2]))
        else:
            raise AssertionError
    else:
        raise ValueError(f"local mps ndim incorrect: {ms.ndim}")
    return val


def _mu_regularize(s, epsilon=1e-10):
    """Regularized singular values of the reduced density matrix,
    ``s + sqrt(eps) exp(-s / sqrt(eps))`` (reference ``mps.py:1926-1931``)."""
    epsilon = np.sqrt(epsilon)
    return s + epsilon * torch.exp(-s / epsilon)


# --- shared environments of ``Mps.expectations`` ----------------------------

def _construct_freq_environ(mpos_hash, hash_to_obj, mps, domain: str, mps_conj):
    """Environments of the MPO site prefixes (``"L"``) or suffixes (``"R"``)
    that appear more than once (reference ``mps.py:2103-2146``)."""
    assert domain in ("L", "R")
    counter = Counter()
    for mpo_hash in mpos_hash:
        for i in range(1, len(mpo_hash) + 1):
            seq = mpo_hash[:i] if domain == "L" else tuple(reversed(mpo_hash[-i:]))
            counter.update([tuple(seq)])

    most_common = sorted(counter.items(), key=lambda x: (-x[1], len(x[0])))
    hash_list, matrices_list = [], []
    for hashes, n in most_common:
        if n == 1:
            break
        if len(mps) < len(matrices_list):
            break
        hash_list.append(hashes)
        matrices_list.append([hash_to_obj[h] for h in hashes])

    result = {(): torch.ones((1, 1, 1), dtype=mps[0].dtype, device=mps[0].device)}
    for m_hashes, matrices in zip(hash_list, matrices_list):
        environ = result[tuple(m_hashes[:-1])]
        idx = len(matrices) - 1 if domain == "L" else -len(matrices)
        result[tuple(m_hashes)] = contract_one_site(
            environ, mps[idx], matrices[-1], domain=domain, ms_conj=mps_conj[idx])
    return result


def _get_freq_environ(environ_dict, mpo_hash, domain, max_length):
    """The longest cached environment of this MPO's prefixes or suffixes,
    and the site it ends at (reference ``mps.py:2149-2169``)."""
    assert domain in ("L", "R")
    it = mpo_hash if domain == "L" else list(reversed(mpo_hash))
    hashes = []
    for key in it:
        hashes.append(key)
        if tuple(hashes) not in environ_dict or max_length < len(hashes):
            hashes.pop()
            break
    i = len(hashes) - 1 if domain == "L" else len(mpo_hash) - len(hashes)
    return environ_dict[tuple(hashes)], i


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
