r"""Zero-temperature absorption/emission spectra via TD-DMRG.

DMRG ground state -> dipole MPO applied -> real-time propagation of the ket
(one-way) or alternating ket(+dt)/bra(-dt) (two-way, halving the effective
evolution error).  Port of ``renormalizer_tpu/spectra/zerot.py`` (reference
``renormalizer/spectra/zerot.py:16-116``): thin host-side orchestration; all
device work happens in the engine layers (mps/, ops/, lib/).
"""

import logging

from renormalizer_tpu_torch.mps import Mpo, Mps, gs
from renormalizer_tpu_torch.mps.mps import BraKetPair
from renormalizer_tpu_torch.spectra.base import SpectraTdMpsJobBase
from renormalizer_tpu_torch.utils import OptimizeConfig, Quantity

logger = logging.getLogger(__name__)


class SpectraZeroT(SpectraTdMpsJobBase):
    """Zero-temperature spectrum base: builds mu|gs> as the initial pair."""

    def __init__(
        self,
        model,
        spectratype,
        optimize_config=None,
        evolve_config=None,
        compress_config=None,
        offset=Quantity(0),
    ):
        self.optimize_config = optimize_config if optimize_config is not None else OptimizeConfig()
        super().__init__(
            model, spectratype, Quantity(0), evolve_config, compress_config, offset
        )

    def get_imps(self):
        mmax = self.optimize_config.procedure[0][0]
        i_mps = Mps.random(self.h_mpo.model, self.nexciton, mmax, 1)
        i_mps.optimize_config = self.optimize_config
        _, i_mps = gs.optimize_mps(i_mps, self.h_mpo)
        return i_mps

    def init_mps(self):
        operator = "a" if self.spectratype == "emi" else r"a^\dagger"
        dipole_mpo = Mpo.onsite(self.model, operator, dipole=True)
        a_ket_mps = dipole_mpo.apply(self.get_imps(), canonicalise=True)
        a_ket_mps.normalize("mps_norm_to_coeff")
        a_ket_mps.evolve_config = self.evolve_config
        a_ket_mps.compress_config = self.compress_config
        a_bra_mps = a_ket_mps.copy()
        a_bra_mps.compress_config = self.compress_config
        return BraKetPair(a_bra_mps, a_ket_mps)


class SpectraOneWayPropZeroT(SpectraZeroT):
    def evolve_single_step(self, evolve_dt):
        bra, ket = self.latest_mps
        return BraKetPair(bra, ket.evolve(self.h_mpo, evolve_dt))


class SpectraTwoWayPropZeroT(SpectraZeroT):
    def evolve_single_step(self, evolve_dt):
        bra, ket = self.latest_mps
        if len(self.evolve_times) % 2 == 1:
            ket = ket.evolve(self.h_mpo, evolve_dt)
        else:
            bra = bra.evolve(self.h_mpo, -evolve_dt)
        return BraKetPair(bra, ket)
