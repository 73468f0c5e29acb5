r"""Spin-boson model dynamics job.

Reference ``renormalizer/sbm/sbm.py:13-100``: initial Hartree product state
(vibrations at |0>, spin up), collects sigma_x/sigma_z expectations, the
spin reduced density matrix and bond entropies.  Works at zero temperature
or at finite temperature via the thermofield transformation.

Counterpart of ``renormalizer_tpu/sbm/sbm.py``: thin host-side
orchestration; all device work happens in the engine layers (mps/, ops/,
lib/).
"""

import logging

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps import Mpo, Mps
from renormalizer_tpu_torch.utils import CompressConfig, TdMpsJob

logger = logging.getLogger(__name__)


class SpinBosonDynamics(TdMpsJob):
    def __init__(
        self,
        model: Model,
        auto_expand: bool = True,
        compress_config=None,
        evolve_config=None,
        dump_dir=None,
        dump_mps=None,
        job_name=None,
    ):
        self.model = model
        self.h_mpo = Mpo(model)
        self.auto_expand = auto_expand
        self.compress_config = compress_config if compress_config is not None else CompressConfig()
        self.sigma_x = []
        self.sigma_z = []
        self.rho = []
        self.bond_entropy = []
        super().__init__(
            evolve_config=evolve_config, dump_dir=dump_dir,
            dump_mps=dump_mps, job_name=job_name,
        )

    def init_mps(self):
        logger.debug(
            f"mpo bond and physical dimension: {self.h_mpo.bond_dims}, "
            f"{self.h_mpo.pbond_list}"
        )
        init_mps = Mps.ground_state(self.model, False)
        init_mps.compress_config = self.compress_config
        init_mps.evolve_config = self.evolve_config
        if self.evolve_config.is_tdvp and self.auto_expand:
            init_mps = init_mps.expand_bond_dimension(
                self.h_mpo, coef=1e-16, include_ex=False
            )
        return init_mps

    def process_mps(self, mps):
        for idx, bas in enumerate(self.model.basis):
            if bas.is_spin:
                break
        rho = mps.calc_1site_rdm(idx=idx)[idx]
        self.rho.append(rho)
        self.sigma_z.append((rho[0, 0] - rho[1, 1]).real)
        self.sigma_x.append((rho[0, 1] + rho[1, 0]).real)
        logger.info(f"sigma_z: {self.sigma_z[-1]}. sigma_x: {self.sigma_x[-1]}")
        self.bond_entropy.append(mps.calc_entropy("bond"))

    def evolve_single_step(self, evolve_dt):
        return self.latest_mps.evolve(self.h_mpo, evolve_dt)

    def get_dump_dict(self):
        return {
            "time series": self.evolve_times,
            "sigma_x": self.sigma_x,
            "sigma_z": self.sigma_z,
            "rho": self.rho,
            "bond_entropy": self.bond_entropy,
        }
