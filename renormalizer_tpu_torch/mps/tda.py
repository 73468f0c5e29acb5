r"""Tamm-Dancoff (CIS) excited states in the first-order MPS tangent space.

Port of ``renormalizer_tpu/mps/tda.py`` (J. Chem. Phys. 140, 024108 (2014);
reference ``renormalizer/mps/tda.py:18-516``).  The excitation ansatz is

    |Psi_1> = sum_i  A_L[1..i-1] (u_perp[i] c[i]) A_R[i+1..N]

with ``u_perp`` the orthogonal complement of the left-canonical site tensors
and ``c[i]`` the variational coefficients.  The tangent space is built per
quantum number on the host (numpy SVD of small site matrices); the
tangent-space Hamiltonian is applied by sweeping device environments, and
the roots come from the host Davidson ``lib.solvers.davidson_host``.
"""

import logging
from collections import defaultdict

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib.solvers import davidson_host
from renormalizer_tpu_torch.mps.lib import Environ, compressed_sum
from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.mps.mps import Mps
from renormalizer_tpu_torch.ops.contract import einsum

logger = logging.getLogger(__name__)


def merge(mpsl, mpsr, idx):
    """Mixed-canonical merge: sites < idx from ``mpsl``, the rest from
    ``mpsr``."""
    mps = mpsl.copy()
    for imps in range(idx, mpsr.site_num):
        mps[imps] = mpsr[imps]
    return mps


class TDA:
    r"""Tangent-space CIS excited states on top of an optimized MPS.

    ``mps`` is the optimized ground state (overwritten in place); ``algo``:
    only "davidson".  Quantum numbers label the tangent vectors, and the
    coefficients outside the target sector are masked out.
    """

    def __init__(self, model, hmpo, mps, nroots=1, algo="davidson"):
        self.model = model
        self.hmpo = hmpo
        self.mps = mps
        self.nroots = nroots
        self.algo = algo
        self.e = None
        # wavefunction: [mps_l_cano, mps_r_cano, tangent_u, tda_coeff_list]
        self.wfn = None
        self.configs = defaultdict(list)

    def kernel(self, restart=False, include_psi0=False):
        r"""Solve for the roots.  ``restart=True`` reuses the previously
        converged coefficients as the guess; with ``include_psi0`` the
        variational space holds the ground state too and the first energy is
        the ground-state energy."""
        mpo = self.hmpo
        nroots = self.nroots
        site_num = mpo.site_num

        if not restart:
            mps = (self.mps.ensure_right_canonical().canonicalise()
                   .normalize("mps_and_coeff").canonicalise())
            mps_r_cano = mps.copy()
            assert mps.to_right
            # the tangent space block-wise per quantum number, so every
            # tangent vector has a definite qn (a plain null-space basis mixes
            # sectors and lets Davidson collapse onto other sectors' states)
            qn_size = np.asarray(mps.qntot).size
            qntot = np.asarray(mps.qntot).reshape(qn_size)

            def _cum_labels(mp, bond):
                q = np.asarray(mp.qn[bond]).reshape(-1, qn_size)
                if bond > mp.qnidx:
                    q = qntot[None, :] - q
                return q

            tangent_u, tangent_q = [], []
            cum_left = np.zeros((1, qn_size), dtype=int)
            for ims in range(len(mps)):
                shape = list(mps[ims].shape)
                mat = to_numpy(mps[ims]).reshape(-1, shape[-1])
                nrow, ncol = mat.shape
                sigq = np.asarray(self.model.basis[ims].sigmaqn).reshape(-1, qn_size)
                q_row = (cum_left[:, None, :] + sigq[None, :, :]).reshape(nrow, qn_size)
                if ims == site_num - 1:
                    q_col = np.broadcast_to(qntot[None, :], (ncol, qn_size))
                else:
                    q_col = _cum_labels(mps_r_cano, ims + 1)
                u_occ = np.zeros((nrow, ncol), dtype=mat.dtype)
                tang_cols, tang_labels = [], []
                for q in np.unique(np.concatenate([q_row, q_col]), axis=0):
                    rows = np.nonzero((q_row == q).all(axis=-1))[0]
                    cols = np.nonzero((q_col == q).all(axis=-1))[0]
                    assert len(rows) >= len(cols), "bond sector larger than row sector"
                    if len(rows) == 0:
                        continue
                    uq = np.linalg.svd(mat[np.ix_(rows, cols)], full_matrices=True)[0]
                    if len(cols):
                        u_occ[np.ix_(rows, cols)] = uq[:, :len(cols)]
                    if len(rows) > len(cols):
                        t = np.zeros((nrow, len(rows) - len(cols)), dtype=mat.dtype)
                        t[rows] = uq[:, len(cols):]
                        tang_cols.append(t)
                        tang_labels.extend([q] * (len(rows) - len(cols)))
                vt = u_occ.T.conj() @ mat
                if ims == site_num - 1:
                    assert vt.size == 1
                    if vt.reshape(-1)[0].real < 0:
                        u_occ, vt = -u_occ, -vt
                    assert np.allclose(vt, 1)
                    if include_psi0:
                        tang_cols = [u_occ] + tang_cols
                        tang_labels = list(q_col) + tang_labels
                if tang_cols:
                    tangent_u.append(
                        np.concatenate(tang_cols, axis=1).reshape(shape[:-1] + [-1]))
                    tangent_q.append(np.array(tang_labels).reshape(-1, qn_size))
                else:
                    tangent_u.append(None)  # no tangent space at this site
                    tangent_q.append(None)
                mps[ims] = u_occ.reshape(shape[:-1] + [-1])
                if ims != site_num - 1:
                    mps[ims + 1] = np.tensordot(vt, to_numpy(mps[ims + 1]), axes=(-1, 0))
                cum_left = q_col
            mps_l_cano = mps.copy()
            mps_l_cano.to_right = False
            mps_l_cano.qnidx = site_num - 1
            self.tangent_q = tangent_q
            cguess = None
        else:
            mps_l_cano, mps_r_cano, tangent_u, tda_coeff_list = self.wfn
            qn_size = np.asarray(mps_r_cano.qntot).size
            qntot = np.asarray(mps_r_cano.qntot).reshape(qn_size)
            tangent_q = getattr(self, "tangent_q", [None] * site_num)

            def _cum_labels(mp, bond):
                q = np.asarray(mp.qn[bond]).reshape(-1, qn_size)
                if bond > mp.qnidx:
                    q = qntot[None, :] - q
                return q

            cguess = [np.concatenate([c.flatten() for c in coeff if c is not None],
                                     axis=None) for coeff in tda_coeff_list]

        # coefficient layout
        xshape = []
        xsize = 0
        for ims in range(site_num):
            if tangent_u[ims] is None:
                xshape.append((0, 0))
            else:
                right = 1 if ims == site_num - 1 else mps_r_cano[ims + 1].shape[0]
                xshape.append((tangent_u[ims].shape[-1], right))
                xsize += int(np.prod(xshape[-1]))
        logger.debug(f"DMRG-TDA H dimension: {xsize}")

        # qn mask over the coefficients: a tangent column with cumulative qn q
        # joined to the right-canonical tail at bond r' stays in the target
        # sector only when q == cum[r']
        cmask_parts = []
        for ims in range(site_num):
            if tangent_u[ims] is None:
                continue
            if tangent_q[ims] is None:
                cmask_parts.append(np.ones(xshape[ims], dtype=bool))
                continue
            q_r = qntot[None, :] if ims == site_num - 1 else _cum_labels(mps_r_cano, ims + 1)
            cmask_parts.append((tangent_q[ims][:, None, :] == q_r[None, :, :]).all(axis=-1))
        cmask = np.concatenate([m.ravel() for m in cmask_parts])
        assert cmask.size == xsize

        tangent_dev = [None if u is None else backend.tensor(u) for u in tangent_u]
        # hdiag from the sandwich contraction per site
        mps_tangent = mps_r_cano.copy()
        environ = Environ(mps_tangent, mpo, "R")
        hdiag = []
        for ims in range(site_num):
            ltensor = environ.GetLR("L", ims - 1, mps_tangent, mpo, method="System")
            rtensor = environ.GetLR("R", ims + 1, mps_tangent, mpo, method="Enviro")
            if tangent_u[ims] is not None:
                u = tangent_dev[ims]
                hdiag.append(to_numpy(einsum(
                    "abc,ded,bghe,agl,chl->ld", ltensor, rtensor, mpo[ims], u, u)))
            mps_tangent[ims] = mps_l_cano[ims]
        hdiag = np.concatenate([h.ravel() for h in hdiag])

        count = 0

        def reshape_x(x):
            tda_coeff = []
            offset = 0
            for shape in xshape:
                if shape == (0, 0):
                    tda_coeff.append(None)
                else:
                    size = int(np.prod(shape))
                    tda_coeff.append(x[offset:offset + size].reshape(shape))
                    offset += size
            assert offset == xsize
            return tda_coeff

        def hop(x):
            nonlocal count
            count += 1
            assert len(x) == xsize
            tda_coeff = reshape_x(np.where(cmask, x, 0.0))
            res = [None if c is None else 0 for c in tda_coeff]
            # fix the ket tangent site, sweep the bra tangent site
            for ims in range(site_num):
                if tda_coeff[ims] is None:
                    continue
                mps_tangent = merge(mps_l_cano, mps_r_cano, ims + 1)
                mps_tangent[ims] = torch.tensordot(
                    tangent_dev[ims], backend.tensor(tda_coeff[ims]).to(tangent_dev[ims].dtype),
                    dims=1)
                mps_tangent_conj = mps_r_cano.copy()
                environ2 = Environ(mps_tangent, mpo, "R", mps_conj=mps_tangent_conj)
                for ims_conj in range(site_num):
                    ltensor = environ2.GetLR("L", ims_conj - 1, mps_tangent, mpo,
                                             mps_conj=mps_tangent_conj, method="System")
                    rtensor = environ2.GetLR("R", ims_conj + 1, mps_tangent, mpo,
                                             mps_conj=mps_tangent_conj, method="Enviro")
                    if tda_coeff[ims_conj] is not None:
                        out = einsum("abc,cek,bdef,lfk->adl", ltensor,
                                     mps_tangent[ims_conj], mpo[ims_conj], rtensor)
                        res[ims_conj] = res[ims_conj] + torch.tensordot(
                            tangent_dev[ims_conj], out, dims=([0, 1], [0, 1]))
                    mps_tangent_conj[ims_conj] = mps_l_cano[ims_conj]
            # ONE host read per matvec
            flat = torch.cat([r.reshape(-1) for r in res if r is not None])
            return flat.cpu().numpy() * cmask

        if self.algo != "davidson":
            raise NotImplementedError(f"TDA algo {self.algo} not available")
        hdiag = np.where(cmask, hdiag, 1e10)
        if cguess is None:
            # unit vectors on the lowest diagonal entries: a random guess
            # cannot reach an (almost) decoupled eigenvector such as psi0
            rng = np.random.default_rng(2021)
            order = np.argsort(hdiag)
            cguess = []
            for k in range(min(nroots, int(cmask.sum()))):
                g = 1e-4 * (rng.random(xsize) - 0.5) * cmask
                g[order[k]] = 1.0
                cguess.append(g)
        e, c = davidson_host(hop, cguess, lambda r, e_val: r / (hdiag - e_val + 1e-4),
                             nroots=nroots, max_cycle=100)
        if nroots == 1:
            c = [c]
        c = np.stack(c, axis=1)
        logger.debug(f"H*C times: {count}")

        tda_coeff_list = [reshape_x(c[:, i]) for i in range(nroots)]
        self.e = np.atleast_1d(np.array(e))
        self.wfn = [mps_l_cano, mps_r_cano, tangent_u, tda_coeff_list]
        return self.e

    # --- persistence ------------------------------------------------------
    def dump_wfn(self):
        """Dump wavefunction pieces for restart and analysis."""
        mps_l_cano, mps_r_cano, tangent_u, tda_coeff_list = self.wfn
        mps_l_cano.dump("mps_l_cano.npz")
        mps_r_cano.dump("mps_r_cano.npz")
        np.savez("tangent_u.npz",
                 **{f"{i}": m for i, m in enumerate(tangent_u) if m is not None})
        for iroot, tda_coeff in enumerate(tda_coeff_list):
            np.savez(f"tda_coeff_{iroot}.npz",
                     **{f"{i}": m for i, m in enumerate(tda_coeff) if m is not None})

    def load_wfn(self, model):
        mps_l_cano = Mps.load(model, "mps_l_cano.npz")
        mps_r_cano = Mps.load(model, "mps_r_cano.npz")
        tangent_u_dict = np.load("tangent_u.npz")
        tangent_u = [tangent_u_dict[str(i)] if str(i) in tangent_u_dict else None
                     for i in range(mps_l_cano.site_num)]
        tda_coeff_list = []
        for iroot in range(self.nroots):
            d = np.load(f"tda_coeff_{iroot}.npz")
            tda_coeff_list.append([d[str(i)] if str(i) in d else None
                                   for i in range(mps_l_cano.site_num)])
        self.wfn = [mps_l_cano, mps_r_cano, tangent_u, tda_coeff_list]

    # --- analysis ----------------------------------------------------------
    def _tangent_states(self, iroot):
        mps_l_cano, mps_r_cano, tangent_u, tda_coeff_list = self.wfn
        tda_coeff = tda_coeff_list[iroot]
        out = []
        for ims in range(mps_l_cano.site_num):
            if tangent_u[ims] is None:
                continue
            mps_tangent = merge(mps_l_cano, mps_r_cano, ims + 1)
            mps_tangent[ims] = np.tensordot(tangent_u[ims], tda_coeff[ims], axes=(-1, 0))
            out.append((ims, mps_tangent))
        return out

    def analysis_1ordm(self):
        """One-site reduced density matrix of each root."""
        for iroot in range(self.nroots):
            rdm = None
            for _, mps_tangent in self._tangent_states(iroot):
                increment = mps_tangent.calc_1site_rdm()
                rdm = increment if rdm is None else {
                    k: rdm[k] + v for k, v in increment.items()}
            dominant = {}
            for isite, mat in rdm.items():
                quanta = int(np.argmax(np.diag(mat).real))
                dominant[isite] = (quanta, np.diag(mat).real[quanta])
            logger.info(f"root: {iroot}, config: {dominant}")

    def analysis_dominant_config(self, thresh=0.8, alias=None, tda_m_trunc=20,
                                 return_compressed_mps=False):
        """Iteratively extract dominant Hartree configurations of each root
        by rank-1 compression and deflation (reference ``tda.py:384-507``)."""
        mps_l_cano, _, _, tda_coeff_list = self.wfn
        if alias is not None:
            assert len(alias) == mps_l_cano.site_num
        compressed_mps = []
        for iroot in range(self.nroots):
            logger.info(f"iroot: {iroot}")
            tda_coeff = tda_coeff_list[iroot]
            states = self._tangent_states(iroot)
            weight = [float(np.sum(np.asarray(tda_coeff[ims]) ** 2)) for ims, _ in states]
            assert np.allclose(np.sum(weight), 1)
            order = np.argsort(weight, axis=None)[::-1]
            mps_tangent_list = [states[i][1] for i in order]

            coeff_square_sum = 0
            mps_delete = None
            config_visited = []
            while coeff_square_sum < thresh:
                batch = mps_tangent_list if mps_delete is None else [mps_delete] + mps_tangent_list
                mps_rank1 = compressed_sum(batch, batchsize=5, temp_m_trunc=tda_m_trunc)
                if coeff_square_sum == 0 and return_compressed_mps:
                    compressed_mps.append(mps_rank1.copy())
                mps_rank1 = mps_rank1.canonicalise().compress(temp_m_trunc=1)
                config = [int(np.argmax(to_numpy(ms).flatten() ** 2)) for ms in mps_rank1]
                if config in config_visited:
                    break
                config_visited.append(config)

                ci_coeff_list = []
                for mps_tangent in mps_tangent_list:
                    sentinel = np.ones((1, 1))
                    for ims, ms in enumerate(mps_tangent):
                        sentinel = sentinel.dot(to_numpy(ms)[:, config[ims], :])
                    ci_coeff_list.append(float(sentinel[0, 0]))
                ci_coeff = np.sum(ci_coeff_list)
                coeff_square_sum += ci_coeff ** 2

                if alias is not None:
                    config_name = " ".join(f"{q}{alias[isite]}"
                                           for isite, q in enumerate(config) if q != 0)
                    self.configs[iroot].append((config, config_name, ci_coeff))
                else:
                    self.configs[iroot].append((config, ci_coeff))
                logger.info(f"ci_coeff: {ci_coeff}, weight:{ci_coeff ** 2}")

                condition = {dof: config[idof] for idof, dof in enumerate(self.model.dofs)}
                increment = Mps.hartree_product_state(self.model, condition).scale(-ci_coeff)
                mps_delete = increment if mps_delete is None else mps_delete + increment
            logger.info(f"coeff_square_sum: {coeff_square_sum}")
        return self.configs, compressed_mps
