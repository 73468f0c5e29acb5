r"""Finite-temperature spectra with thermofield density matrices.

Pipeline: build the T=:math:`\infty` max-entangled MpDm, propagate it
:math:`\beta/2` in imaginary time (cached on disk keyed by job name), apply
the dipole operator, then propagate the bra and ket in real time in
ALTERNATE directions — ket :math:`+dt` on odd steps, bra :math:`-dt` on even
steps — so each state only accumulates half the evolution error at a given
correlation time.  Emission reports the conjugated amplitude.  Port of
``renormalizer_tpu/spectra/finitet.py`` (reference
``renormalizer/spectra/finitet.py:16-150``).
"""

import logging
import os

import numpy as np

from renormalizer_tpu_torch.mps import MpDm, Mpo, ThermalProp
from renormalizer_tpu_torch.mps.mps import BraKetPair
from renormalizer_tpu_torch.spectra.base import SpectraTdMpsJobBase
from renormalizer_tpu_torch.utils import CompressConfig, EvolveConfig

logger = logging.getLogger(__name__)


class BraKetPairEmiFiniteT(BraKetPair):
    """Emission correlation = conj(<bra| mu |ket>)."""

    def calc_ft(self):
        return np.conj(super().calc_ft())


class BraKetPairAbsFiniteT(BraKetPair):
    pass


class SpectraFiniteT(SpectraTdMpsJobBase):
    def __init__(self, model, spectratype, temperature, insteps, offset,
                 evolve_config=None, icompress_config=None,
                 ievolve_config=None, gs_shift=0,
                 dump_dir: str = None, job_name=None):
        self.insteps = insteps
        self.gs_shift = gs_shift
        self.icompress_config = (
            CompressConfig() if icompress_config is None else icompress_config)
        self.ievolve_config = (
            EvolveConfig() if ievolve_config is None else ievolve_config)
        self.dump_dir = dump_dir
        self.job_name = job_name
        super().__init__(model, spectratype, temperature,
                         evolve_config=evolve_config, offset=offset,
                         dump_dir=dump_dir, job_name=job_name)

    # --- thermal state preparation ----------------------------------------

    @property
    def _thermal_dump_path(self):
        assert self._defined_output_path
        return os.path.join(self.dump_dir, self.job_name + "_impo.npz")

    def _equilibrated_ex(self) -> MpDm:
        """beta/2-propagated 1-exciton density matrix, disk-cached so the
        expensive imaginary-time TDVP runs once per (job, temperature)."""
        start = MpDm.max_entangled_ex(self.model)
        start.compress_config = self.icompress_config
        sub_name = None if self.job_name is None else (
            self.job_name + "_thermal_prop")
        tp = ThermalProp(start, evolve_config=self.ievolve_config,
                         dump_dir=self.dump_dir, job_name=sub_name)
        if tp._defined_output_path:
            try:
                logger.info(
                    f"load density matrix from {self._thermal_dump_path}")
                return MpDm.load(self.model, self._thermal_dump_path)
            except FileNotFoundError:
                pass
        tp.evolve(None, self.insteps, self.temperature.to_beta() / 2j)
        rho = tp.latest_mps
        if tp._defined_output_path:
            rho.dump(self._thermal_dump_path)
        return rho

    def _equilibrated_gs(self) -> MpDm:
        """GS-space thermalization is exact (local propagator), one step."""
        start = MpDm.max_entangled_gs(self.model)
        start.compress_config = self.icompress_config
        tp = ThermalProp(start, exact=True, space="GS")
        tp.evolve(None, 1, self.temperature.to_beta() / 2j)
        return tp.latest_mps

    # --- initial pair ------------------------------------------------------

    def init_mps(self):
        if self.spectratype == "emi":
            rho = self._equilibrated_ex()
            rho.evolve_config = self.evolve_config
            mu_dagger = Mpo.onsite(self.model, "a", dipole=True).conj_trans()
            mu_dagger.build_empty_qn()
            excited = rho.apply(mu_dagger, canonicalise=True)
            pair_cls = BraKetPairEmiFiniteT
        else:
            rho = self._equilibrated_gs()
            rho.evolve_config = self.evolve_config
            mu = Mpo.onsite(self.model, r"a^\dagger", dipole=True)
            excited = mu.apply(rho, canonicalise=True)
            if self.evolve_config.is_tdvp:
                excited = excited.expand_bond_dimension(self.h_mpo)
            pair_cls = BraKetPairAbsFiniteT
        excited.normalize("mps_norm_to_coeff")
        return pair_cls(excited.copy(), excited)

    # --- real-time propagation ---------------------------------------------

    def evolve_single_step(self, evolve_dt):
        bra, ket = self.latest_mps
        if len(self.evolve_times) % 2 == 1:
            # odd step: ket forward.  The GS-space part of the propagation
            # is local-exact; do it exactly and let TDVP handle the rest.
            ket = ket.evolve_exact(self.h_mpo, -evolve_dt, "GS")
            ket = ket.evolve(self.h_mpo, evolve_dt)
        else:
            # even step: bra backward
            bra = bra.evolve_exact(self.h_mpo, evolve_dt, "GS")
            bra = bra.evolve(self.h_mpo, -evolve_dt)
        return self.latest_mps.__class__(bra, ket)

    def get_dump_dict(self):
        d = super().get_dump_dict()
        d["temperature"] = self.temperature.as_au()
        return d

    def stop_evolve_criteria(self):
        """Stop once |C(t)| has decayed to 1e-5 of |C(0)| for 10 steps."""
        corr = self.autocorr
        if len(corr) < 10:
            return False
        tail, head = corr[-10:], np.abs(corr[0])
        return np.abs(tail.mean()) < 1e-5 * head and tail.std() < 1e-5 * head
