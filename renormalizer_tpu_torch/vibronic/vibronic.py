r"""Vibronic Hamiltonian dynamics (pyrazine-type models).

Port of ``renormalizer_tpu/vibronic/vibronic.py`` (reference
``renormalizer/vibronic/vibronic.py:11-123``).  Collects the
autocorrelation <psi*|psi>, electronic occupations, energies and
electron-DoF RDMs along ``Mps.evolve``.  A real initial state uses the t/2
trick, so the autocorrelation is sampled at 2t.
"""

import logging

import numpy as np

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps import Mpo, Mps
from renormalizer_tpu_torch.utils import CompressConfig, EvolveConfig, TdMpsJob

logger = logging.getLogger(__name__)


class VibronicModelDynamics(TdMpsJob):
    def __init__(self, model: Model, compress_config: CompressConfig = None,
                 evolve_config: EvolveConfig = None, h_mpo=None, mps0=None,
                 init_condition=None, dump_mps: str = None, dump_dir: str = None,
                 job_name: str = None, auto_expand: bool = False):
        self.model = model
        self.compress_config = (compress_config if compress_config is not None
                                else CompressConfig())
        self.h_mpo = h_mpo if h_mpo is not None else Mpo(model)
        self.mps0 = mps0
        self.init_condition = init_condition
        self.auto_expand = auto_expand

        self.e_occupations_array = []
        self.autocorr_array = []
        self.energies = []
        self.autocorr_time = []
        self.edof_rdm = []
        super().__init__(evolve_config=evolve_config, dump_mps=dump_mps,
                         dump_dir=dump_dir, job_name=job_name)

    def init_mps(self):
        if self.mps0 is None:
            assert self.init_condition is not None
            init_mp = Mps.hartree_product_state(self.model, self.init_condition)
            self.mps0 = init_mp.copy()
        else:
            init_mp = self.mps0.copy()
        init_mp.compress_config = self.compress_config
        init_mp.evolve_config = self.evolve_config
        init_mp.model = self.model
        if self.evolve_config.is_tdvp and self.auto_expand:
            init_mp = init_mp.expand_bond_dimension(self.h_mpo, include_ex=False)
        return init_mp

    def evolve_single_step(self, evolve_dt):
        return self.latest_mps.evolve(self.h_mpo, evolve_dt)

    def process_mps(self, mps):
        self.energies.append(mps.expectation(self.h_mpo))
        e_occupations = mps.e_occupations
        self.e_occupations_array.append(e_occupations)
        logger.debug(f"e occupations: {e_occupations}")
        self.edof_rdm.append(mps.calc_edof_rdm())
        if self.mps0.is_complex:
            self.autocorr_array.append(self.mps0.conj().dot(mps))
            self.autocorr_time.append(self.evolve_times[-1])
        else:
            # real initial state: <psi(0)|psi(2t)> = <psi*(t)|psi(t)>
            if not np.allclose(self.evolve_times[-1], 0):
                self.autocorr_array.append(mps.dot(self.latest_mps))
                self.autocorr_time.append(self.evolve_times[-1] + self.evolve_times[-2])
            self.autocorr_array.append(mps.dot(mps))
            self.autocorr_time.append(2 * self.evolve_times[-1])

    def get_dump_dict(self):
        return {
            "time series": list(self.evolve_times),
            "electron occupations array": self.e_occupations_array,
            "autocorrelation function": self.autocorr_array,
            "autocorrelation time": self.autocorr_time,
            "energy": self.energies,
            "edof_rdm": self.edof_rdm,
        }
