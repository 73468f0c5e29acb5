r"""Charge-diffusion dynamics of a Holstein polaron by TD-DMRG.

Port of ``renormalizer_tpu/transport/dynamics.py`` (reference
``renormalizer/transport/dynamics.py:24-295``, same observables and npz
dump keys): state preparation is factored into free functions, the rdm and
non-rdm observable paths are separate recorder methods, and the chain edge
criterion reads the last recorded snapshot.  The tensor numerics run in the
device engine layers; the electronic RDM's ``logm`` runs on the host, as in
the JAX package.
"""

import logging
import os
from collections import OrderedDict
from enum import Enum

import numpy as np
from scipy.linalg import logm

from renormalizer_tpu_torch.model import HolsteinModel
from renormalizer_tpu_torch.mps import MpDm, Mpo, Mps, ThermalProp, load_thermal_state
from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.utils import CompressConfig, EvolveConfig, Quantity, TdMpsJob

logger = logging.getLogger(__name__)

# occupation at site 0 above which the wavepacket has hit the chain edge
EDGE_THRESHOLD = 1e-4


class InitElectron(Enum):
    """Initial-charge preparation recipe."""

    fc = "franck-condon excitation"
    relaxed = "analytically relaxed phonon(s)"


def calc_r_square(e_occupations):
    """Variance of the charge position: <r^2> - <r>^2 over site indices
    weighted by electron occupation (0 for an empty chain)."""
    occ = np.asarray(e_occupations, dtype=float)
    total = occ.sum()
    if total <= 0 or np.allclose(occ, 0):
        return 0
    sites = np.arange(len(occ), dtype=float)
    mean_r = sites @ occ / total
    mean_r2 = (sites * sites) @ occ / total
    return float(mean_r2 - mean_r * mean_r)


def _k_space_transform(n: int) -> np.ndarray:
    """Plane-wave matrix mapping site occupations to k occupations,
    k on the 2*pi*m/n grid folded into (-pi, pi]."""
    k = (np.arange(-n, n, 2) / n * np.pi)[:, None]
    j = np.arange(n)[None, :]
    return np.exp(-1j * k * j) / np.sqrt(n)


def _prepare_charge_fc(model, gs_mp):
    """Franck-Condon: create the electron on the center site as-is."""
    center = model.mol_num // 2
    a_dag = Mpo.onsite(model, r"a^\dagger", dof_set=[center])
    return a_dag.apply(gs_mp)


def _prepare_charge_relaxed(model, gs_mp):
    """Displace the center molecule's phonon modes to their relaxed
    equilibria, then create the electron there (reference semantics,
    ``dynamics.py:146-163``)."""
    if not np.allclose(gs_mp.bond_dims, np.ones_like(gs_mp.bond_dims)):
        raise ValueError("relaxed preparation requires a product state")
    center = model.mol_num // 2
    for i, ph in enumerate(model[center].ph_list):
        site = model.order[(center, i)]
        local = to_numpy(gs_mp[site])[0, ..., 0]
        displaced = ph.get_displacement_evecs() @ local
        gs_mp[site] = displaced.reshape((1,) + displaced.shape + (1,))
    a_dag = Mpo.onsite(model, r"a^\dagger", dof_set=[center])
    return a_dag.apply(gs_mp)


_CHARGE_PREP = {
    InitElectron.fc: _prepare_charge_fc,
    InitElectron.relaxed: _prepare_charge_relaxed,
}


class ChargeDiffusionDynamics(TdMpsJob):
    r"""Propagate a single charge on a Holstein chain and record transport
    observables: mean-square displacement, site/k-space electron
    occupations, phonon occupations, coherence length, e-ph and bond
    entropies.  Optionally stops when the wavepacket reaches the chain edge.
    Reference attribute semantics: ``transport/dynamics.py:33-86``.
    """

    def __init__(
        self,
        model: HolsteinModel,
        temperature: Quantity = Quantity(0, "K"),
        compress_config: CompressConfig = None,
        evolve_config: EvolveConfig = None,
        stop_at_edge: bool = True,
        init_electron=InitElectron.relaxed,
        rdm: bool = False,
        dump_dir: str = None,
        job_name: str = None,
    ):
        self.model = model
        self.temperature = temperature
        self.init_electron = init_electron
        self.compress_config = (
            CompressConfig() if compress_config is None else compress_config
        )
        self.mpo = None
        self.energies = []
        self.r_square_array = []
        self.e_occupations_array = []
        self.ph_occupations_array = []
        self.k_occupations_array = []
        self.eph_vn_entropy_array = []
        self.bond_vn_entropy_array = []
        self.coherent_length_array = []
        self.reduced_density_matrices = [] if rdm else None
        if dump_dir is not None and job_name is not None:
            self.thermal_dump_path = os.path.join(dump_dir, job_name + "_impdm.npz")
        else:
            self.thermal_dump_path = None
        super().__init__(
            evolve_config=evolve_config, dump_dir=dump_dir, job_name=job_name
        )
        if self.mpo is None:
            raise RuntimeError("init_mps did not build the propagation MPO")
        self.elocalex_arrays = []
        self.j_arrays = []
        self.custom_dump_info = OrderedDict()
        self.stop_at_edge = stop_at_edge

    @property
    def mol_num(self):
        return self.model.mol_num

    def create_electron(self, gs_mp):
        logger.info(f"initial charge recipe: {self.init_electron}")
        return _CHARGE_PREP[self.init_electron](self.model, gs_mp)

    # --- state preparation ---------------------------------------------

    def _neutral_background(self):
        """Zero-charge background at the requested temperature: a pure
        ground state at T=0, otherwise an imaginary-time-propagated MpDm
        (cached at ``thermal_dump_path`` when one is configured)."""
        if self.temperature == 0:
            return Mps.ground_state(self.model, max_entangled=False)
        if self.thermal_dump_path is not None:
            cached = load_thermal_state(self.model, self.thermal_dump_path)
            if cached is not None:
                return cached
        mpdm = MpDm.max_entangled_gs(self.model)
        cooler = ThermalProp(mpdm, exact=True, space="GS")
        cooler.evolve(None, max(20, len(mpdm)), self.temperature.to_beta() / 2j)
        state = cooler.latest_mps
        if self.thermal_dump_path is not None:
            state.dump(self.thermal_dump_path)
        return state

    def init_mps(self):
        probe_mpo = Mpo(self.model)
        init_mp = self.create_electron(self._neutral_background())
        # re-center H around the initial energy so phases stay tame
        e0 = Quantity(init_mp.expectation(probe_mpo))
        self.mpo = Mpo(self.model, offset=e0)
        logger.info(f"propagation MPO bond dims: {self.mpo.bond_dims}")
        init_mp.evolve_config = self.evolve_config
        init_mp.compress_config = self.compress_config
        if self.evolve_config.is_tdvp:
            init_mp = init_mp.expand_bond_dimension(self.mpo)
        init_mp.canonicalise()
        return init_mp

    # --- per-step observables --------------------------------------------

    def _record_rdm_observables(self, mps):
        """Observables derived from the electronic reduced density matrix;
        returns the site occupations (its diagonal)."""
        rdm = mps.calc_edof_rdm()
        n = len(self.model)
        if rdm.shape != (n, n):
            raise ValueError(f"unexpected rdm shape {rdm.shape}")
        self.reduced_density_matrices.append(rdm)
        pw = _k_space_transform(n)
        self.k_occupations_array.append(np.diag(pw @ rdm @ pw.conj().T).real)
        self.eph_vn_entropy_array.append(-np.trace(rdm @ logm(rdm)))
        off_diag_weight = np.abs(rdm).sum() - np.trace(rdm).real
        self.coherent_length_array.append(off_diag_weight)
        return np.diag(rdm).real

    def process_mps(self, mps):
        self.energies.append(mps.expectation(self.mpo))
        if self.reduced_density_matrices is not None:
            e_occ = self._record_rdm_observables(mps)
        else:
            e_occ = mps.e_occupations
        self.e_occupations_array.append(e_occ)
        self.r_square_array.append(calc_r_square(e_occ))
        self.ph_occupations_array.append(mps.ph_occupations)
        logger.info(f"charge distribution: {e_occ}")
        self.bond_vn_entropy_array.append(mps.calc_bond_entropy())

    def evolve_single_step(self, evolve_dt):
        return self.latest_mps.evolve(self.mpo, evolve_dt)

    def stop_evolve_criteria(self):
        if not self.stop_at_edge or not self.e_occupations_array:
            return False
        return self.e_occupations_array[-1][0] > EDGE_THRESHOLD

    # --- persistence -------------------------------------------------------

    def get_dump_dict(self):
        # key names are the cross-implementation npz contract (SURVEY A.5);
        # "tempearture" reproduces the reference's historical typo so dumps
        # stay interchangeable
        out = OrderedDict()
        out["mol list"] = self.model.to_dict()
        out["tempearture"] = self.temperature.as_au()
        out["total time"] = self.evolve_times[-1]
        out["other info"] = self.custom_dump_info
        out["r square array"] = self.r_square_array
        out["electron occupations array"] = self.e_occupations_array
        out["phonon occupations array"] = self.ph_occupations_array
        out["k occupations array"] = self.k_occupations_array
        out["eph entropy"] = self.eph_vn_entropy_array
        out["bond entropy"] = self.bond_vn_entropy_array
        out["coherent length array"] = self.coherent_length_array
        if self.reduced_density_matrices:
            out["reduced density matrices"] = self.reduced_density_matrices
        out["time series"] = list(self.evolve_times)
        return out

    def is_similar(self, other: "ChargeDiffusionDynamics", rtol=1e-3):
        if len(self.evolve_times) != len(other.evolve_times):
            return False
        compared = (
            "evolve_times", "r_square_array", "energies",
            "e_occupations_array", "ph_occupations_array",
            "coherent_length_array",
        )
        return all(
            np.allclose(getattr(self, name), getattr(other, name),
                        rtol=rtol, atol=1e-3)
            for name in compared
        )
