r"""Zero-temperature one-particle Green's function on a translational
invariant 1D lattice:

.. math::
    iG_{ij}(t) = \langle 0| c_i(t) c^\dagger_j |0\rangle

Translational invariance means :math:`G` depends only on :math:`|i-j|`, so
one evolved ket serves every row, and the lattice Fourier transform gives
the k-resolved spectral function.  Finite temperature is reached by running
the same job on a thermofield-transformed Hamiltonian (J. Chem. Phys. 145,
224101 (2016)).  Port of ``renormalizer_tpu/transport/spectral_function.py``
(reference ``renormalizer/transport/spectral_function.py:15-137``).
"""

import logging

import numpy as np

from renormalizer_tpu_torch.model import TI1DModel
from renormalizer_tpu_torch.mps import Mpo, Mps
from renormalizer_tpu_torch.utils import CompressConfig, EvolveConfig, Quantity, TdMpsJob

logger = logging.getLogger(__name__)


def _lattice_fourier(g_rt: np.ndarray, n_sites: int) -> np.ndarray:
    """G(|i-j|, t) -> G(k, t) on the first Brillouin zone's ``n//2 + 1``
    non-negative momenta."""
    k = np.arange(n_sites // 2 + 1) * (2 * np.pi / n_sites)
    phase = np.exp(1j * np.outer(np.arange(n_sites), k))  # (dr, k)
    return g_rt @ phase


class SpectralFunctionZT(TdMpsJob):
    r"""Propagate :math:`c^\dagger_0 |0\rangle` and project onto
    :math:`c_i` for every site each step."""

    def __init__(self, model: TI1DModel, compress_config: CompressConfig = None,
                 evolve_config: EvolveConfig = None, dump_dir: str = None,
                 job_name: str = None):
        self.model = model
        self.compress_config = (
            CompressConfig() if compress_config is None else compress_config)
        self._G_array = []
        self.e_occupations_array = []
        self.temperature = Quantity(0)
        super().__init__(evolve_config=evolve_config, dump_dir=dump_dir,
                         job_name=job_name)

    @property
    def G_array(self):
        """G_{ij}(t): first axis t, second axis |i-j|."""
        return np.array(self._G_array)

    def _annihilators(self):
        """Per-site c_i MPOs, cached on the model across process_mps calls."""
        return self.model.get_mpos(
            "a", lambda m: [Mpo.onsite(m, "a", dof_set=[dof])
                            for dof in m.e_dofs])

    def init_mps(self):
        vacuum = Mps.ground_state(self.model, False)
        e_vac = vacuum.expectation(Mpo(self.model))
        self.h_mpo = Mpo(self.model, offset=Quantity(e_vac))
        ket = Mpo.onsite(
            self.model, r"a^\dagger", dof_set=[self.model.e_dofs[0]]
        ).apply(vacuum, canonicalise=True)
        ket.compress_config = self.compress_config
        ket.evolve_config = self.evolve_config
        ket.normalize("mps_norm_to_coeff")
        if self.evolve_config.is_tdvp:
            ket = ket.expand_bond_dimension(self.h_mpo)
        return (vacuum, ket)

    def evolve_single_step(self, evolve_dt):
        bra, ket = self.latest_mps
        return (bra, ket.evolve(self.h_mpo, evolve_dt))

    def process_mps(self, mps):
        bra, ket = mps
        row = ket.expectations(self._annihilators(), bra.conj()) / 1j
        self._G_array.append(row)
        self.e_occupations_array.append(ket.e_occupations)

    def get_dump_dict(self):
        g = self.G_array
        return {
            "temperature": self.temperature.as_au(),
            "time series": self.evolve_times,
            "G array": g,
            "Gk array": _lattice_fourier(g, self.model.n_edofs),
            "electron occupations array": self.e_occupations_array,
        }
