"""Common machinery for time-domain spectra jobs.

A spectra job propagates a bra/ket pair and records the dipole-dipole
autocorrelation :math:`C(t)` each step; the lineshape is its Fourier
transform, taken by the caller.  Port of ``renormalizer_tpu/spectra/base.py``
(reference ``renormalizer/spectra/base.py:12-45``).
"""

import numpy as np

from renormalizer_tpu_torch.mps import Mpo
from renormalizer_tpu_torch.utils import CompressConfig, Quantity, TdMpsJob

# absorption adds an exciton to the 0-exciton space; emission removes one
# from the 1-exciton space
_INITIAL_EXCITONS = {"abs": 0, "emi": 1}


class SpectraTdMpsJobBase(TdMpsJob):
    """Base job: subclasses provide ``init_mps`` (the initial bra/ket
    pair) and ``evolve_single_step``; the base records ``pair.ft`` per step
    and dumps the (time, autocorrelation) series."""

    def __init__(self, model, spectratype, temperature,
                 evolve_config=None, compress_config=None,
                 offset=Quantity(0), dump_dir=None, job_name=None):
        if spectratype not in _INITIAL_EXCITONS:
            raise ValueError(f"spectratype must be abs/emi, got {spectratype}")
        self.model = model
        self.spectratype = spectratype
        self.nexciton = _INITIAL_EXCITONS[spectratype]
        self.temperature = temperature
        self.compress_config = (
            CompressConfig() if compress_config is None else compress_config)
        self.h_mpo: Mpo = Mpo(model, offset=offset)
        self._autocorr = []
        super().__init__(evolve_config=evolve_config, dump_dir=dump_dir,
                         job_name=job_name)

    def process_mps(self, braket_pair):
        self._autocorr.append(braket_pair.ft)

    @property
    def autocorr(self) -> np.ndarray:
        return np.array(self._autocorr)

    def get_dump_dict(self):
        return {"time series": self.evolve_times, "autocorr": self.autocorr}
