r"""Imaginary-time propagation toward thermal equilibrium density matrices.

Port of ``renormalizer_tpu/mps/thermalprop.py`` (reference
``renormalizer/mps/thermalprop.py``, same job semantics and npz dump keys):
the step propagator is chosen once at construction as a strategy callable,
and per-step observables are recorded through a small declarative table.
All numerics run in the device engine layers (``mps/``, ``ops/``, ``lib/``).
"""

import logging

import numpy as np

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps.mpdm import MpDm
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.utils import EvolveConfig, Quantity, TdMpsJob

logger = logging.getLogger(__name__)

# per-step scalar/array observables pulled off the evolving MpDm:
# (recorder key, attribute on the state)
_TRACKED_ATTRS = (
    ("e_occupations", "e_occupations"),
    ("ph_occupations", "ph_occupations"),
)


class ThermalProp(TdMpsJob):
    r"""Evolve an :class:`MpDm` by :math:`e^{-\tau H/2} \rho e^{-\tau H/2}`
    steps (the beta/2 split is up to the caller), recording energy,
    occupations and bond entropies along the way.

    Args:
        init_mpdm: starting density matrix (an identity-like MpDm for
            :math:`\rho(\beta=0)`).
        h_mpo_model: optional model used to build the Hamiltonian MPO when
            it differs from ``init_mpdm.model``.
        exact: use the analytic local propagator of a non-interacting H
            instead of generic MPO time evolution.
        space: exact-propagator subspace, ``"GS"`` or ``"EX"``.
        properties: optional :class:`~renormalizer_tpu_torch.property.Property`
            evaluated on every accepted step.
        auto_expand: pre-expand bond dimension before TDVP evolution.
    """

    def __init__(
        self,
        init_mpdm: MpDm,
        h_mpo_model: Model = None,
        exact: bool = False,
        space: str = "GS",
        evolve_config: EvolveConfig = None,
        dump_mps: str = None,
        dump_dir: str = None,
        job_name: str = None,
        properties=None,
        auto_expand: bool = True,
    ):
        if space not in ("GS", "EX"):
            raise ValueError(f"unknown exact-propagator space: {space!r}")
        self.init_mpdm: MpDm = init_mpdm.canonicalise()
        model = h_mpo_model if h_mpo_model is not None else self.init_mpdm.model
        self.h_mpo = Mpo(model)
        logger.info(f"thermal propagation H-MPO bond dims: {self.h_mpo.bond_dims}")
        self.exact = exact
        self.space = space
        self.auto_expand = auto_expand
        self.properties = properties
        # one step function chosen up front; both share the signature
        # (state, evolve_dt) -> new state
        self._step = self._step_exact if exact else self._step_mpo
        self.energies = []
        self._records = {key: [] for key, _ in _TRACKED_ATTRS}
        self._records["vn_entropy"] = []
        super().__init__(
            evolve_config=evolve_config, dump_mps=dump_mps,
            dump_dir=dump_dir, job_name=job_name,
        )

    # --- TdMpsJob hooks ----------------------------------------------------

    def init_mps(self):
        self.init_mpdm.evolve_config = self.evolve_config
        if self.evolve_config.is_tdvp and self.auto_expand:
            self.init_mpdm = self.init_mpdm.expand_bond_dimension(self.h_mpo)
        return self.init_mpdm

    def process_mps(self, mps):
        energy = mps.expectation(self.h_mpo)
        self.energies.append(energy)
        if self.exact:
            # analytic propagation tracks only the energy
            return
        for key, attr in _TRACKED_ATTRS:
            value = getattr(mps, attr)
            logger.info(f"{key}: {value}")
            self._records[key].append(value)
        self._records["vn_entropy"].append(mps.calc_bond_entropy())
        n_electron = self._records["e_occupations"][-1].sum()
        logger.info(f"thermal step: E = {energy}, sum(n_e) = {n_electron}")
        if self.properties is not None:
            self.properties.calc_properties(mps)

    def evolve_single_step(self, evolve_dt):
        return self._step(self.latest_mps, evolve_dt)

    # --- step strategies ---------------------------------------------------

    def _step_exact(self, state: MpDm, evolve_dt):
        prop = Mpo.exact_propagator(
            state.model, evolve_dt.imag, space=self.space,
            shift=-self.energies[-1],
        )
        out = prop.apply(state, canonicalise=True)
        # keep the norm at O(1): the raw partition-function weight grows
        # past any float range over a long tau grid
        out.normalize("mps_and_coeff")
        return out

    def _step_mpo(self, state: MpDm, evolve_dt):
        shifted = Mpo(self.h_mpo.model, offset=Quantity(self.energies[-1]))
        return state.evolve(shifted, evolve_dt)

    # --- job surface -------------------------------------------------------

    def evolve(self, evolve_dt=None, nsteps=None, evolve_time=None):
        """Imaginary time: both dt and total time must be purely
        negative-imaginary (reference contract, ``thermalprop.py:117-122``)."""
        for val, what in ((evolve_dt, "evolve_dt"), (evolve_time, "evolve_time")):
            if val is not None and not (np.iscomplex(val) and val.imag < 0):
                raise AssertionError(
                    f"{what} must have negative imaginary part, got {val}")
        super().evolve(evolve_dt, nsteps, evolve_time)

    @property
    def e_occupations_array(self):
        return np.array(self._records["e_occupations"])

    @property
    def ph_occupations_array(self):
        return np.array(self._records["ph_occupations"])

    @property
    def vn_entropy_array(self):
        return np.array(self._records["vn_entropy"])

    def get_dump_dict(self):
        # key names are the cross-implementation npz contract (SURVEY A.5)
        out = {
            "time series": [-t.imag for t in self.evolve_times],
            "energies": self.energies,
            "electron occupations array": self.e_occupations_array.tolist(),
            "phonon occupations array": self.ph_occupations_array.tolist(),
            "vn entropy array": self.vn_entropy_array.tolist(),
        }
        if self.properties is not None:
            out.update(self.properties.prop_res)
        return out


def load_thermal_state(model, path: str):
    """Fetch a previously dumped thermal MpDm, or None when the cache file
    does not exist yet (reference ``thermalprop.py:151-168``)."""
    logger.info(f"looking for a cached thermal state at {path}")
    try:
        state = MpDm.load(model, path)
    except FileNotFoundError:
        logger.info("no cached thermal state; it will be computed from scratch")
        return None
    logger.info(f"cached thermal state found: {state}")
    return state
