"""Configuration objects for compression, ground-state optimization and
time evolution.

Numpy copy of ``renormalizer_tpu/utils/configs.py``: ``CompressCriteria``,
``OFS``, ``CompressConfig``, ``OptimizeConfig``, ``EvolveMethod``,
``EvolveConfig`` and ``parse_memory_limit``.
"""

import logging
from enum import Enum
from typing import Union

import numpy as np

from renormalizer_tpu_torch.utils.rk import RungeKutta, TaylorExpansion

logger = logging.getLogger(__name__)


class CompressCriteria(Enum):
    """Criteria for truncating singular-value spectra."""

    #: discard states with normalized singular value below ``threshold``
    threshold = "threshold"
    #: keep at most a fixed number of states
    fixed = "fixed"
    #: the stricter of ``threshold`` and ``fixed``
    both = "both"


class OFS(Enum):
    """On-the-fly swapping criteria (reference ``configs.py:27-38``)."""

    ofs_s = "OFS-S"        # entanglement entropy
    ofs_ds = "OFS-D/S"     # hybrid
    ofs_d = "OFS-D"        # discarded weight
    ofs_debug = "OFS-Debug"  # dry run without swapping


class CompressConfig:
    """MPS/MPO compression configuration.

    See reference ``renormalizer/utils/configs.py:41-264`` for the field
    contracts this class reproduces.
    """

    def __init__(
        self,
        criteria: Union[CompressCriteria, str] = CompressCriteria.threshold,
        threshold: float = 1e-3,
        max_bonddim: int = 32,
        vmethod: str = "2site",
        vprocedure=None,
        vrtol: float = 1e-5,
        vguess_m=(5, 5),
        dump_matrix_size=np.inf,
        dump_matrix_dir="./",
        ofs: OFS = None,
        ofs_swap_jw: bool = False,
    ):
        if isinstance(criteria, str):
            criteria = CompressCriteria[criteria]
        self.criteria: CompressCriteria = criteria
        self._threshold = None
        self.threshold = threshold
        self.bond_dim_max_value = max_bonddim
        # per-bond maximum dims; length is nsite+1 when set
        self.max_dims: np.ndarray = None

        self.vmethod = vmethod
        if vprocedure is None:
            if vmethod == "1site":
                vprocedure = [
                    [max_bonddim, 1.0], [max_bonddim, 0.7], [max_bonddim, 0.5],
                    [max_bonddim, 0.3], [max_bonddim, 0.1],
                ] + [[max_bonddim, 0]] * 10
            else:
                vprocedure = [
                    [max_bonddim, 0.5], [max_bonddim, 0.3], [max_bonddim, 0.1],
                ] + [[max_bonddim, 0]] * 10
        self.vprocedure = vprocedure
        self.vrtol = vrtol
        self.vguess_m = vguess_m

        # out-of-core thresholds kept for API parity; the port keeps every
        # tensor on its device and has no host offload.
        self.dump_matrix_size = dump_matrix_size
        self.dump_matrix_dir = dump_matrix_dir

        self.ofs: OFS = ofs
        self.ofs_swap_jw: bool = ofs_swap_jw

    @property
    def threshold(self):
        return self._threshold

    @threshold.setter
    def threshold(self, v):
        if v <= 0:
            raise ValueError("non-positive threshold")
        if v == 1:
            raise ValueError("1 is an ambiguous threshold")
        if 1 < v:
            raise ValueError("Can't set threshold to be larger than 1")
        self._threshold = v

    @property
    def bonddim_should_set(self):
        return self.criteria is not CompressCriteria.threshold and self.max_dims is None

    def set_bonddim(self, length: int):
        if self.max_dims is None:
            self.max_dims = np.full(length, self.bond_dim_max_value, dtype=int)

    def _threshold_m_trunc(self, sigma: np.ndarray, total_norm=None) -> int:
        normed = sigma / (np.linalg.norm(sigma) if total_norm is None
                          else total_norm)
        return int(np.sum(normed > self.threshold))

    def _fixed_m_trunc(self, sigma: np.ndarray, idx: int, left: bool) -> int:
        assert self.max_dims is not None
        bond_idx = idx + 1 if left else idx
        return min(int(self.max_dims[bond_idx]), len(sigma))

    def compute_m_trunc(self, sigma: np.ndarray, idx: int, left: bool,
                        total_norm=None) -> int:
        """Number of states to keep.  ``total_norm`` supplies the exact
        Frobenius norm of the local coefficient when ``sigma`` is only the
        top of the spectrum (a sketched device factorization) — the
        threshold criterion then normalizes against the true norm instead
        of the partial one."""
        if self.criteria is CompressCriteria.threshold:
            return self._threshold_m_trunc(sigma, total_norm)
        if self.criteria is CompressCriteria.fixed:
            return self._fixed_m_trunc(sigma, idx, left)
        if self.criteria is CompressCriteria.both:
            return min(
                self._threshold_m_trunc(sigma, total_norm),
                self._fixed_m_trunc(sigma, idx, left),
            )
        raise AssertionError

    def update(self, other: "CompressConfig"):
        """Keep the stricter of two configs (reference ``configs.py:221-233``)."""
        if self.criteria != other.criteria:
            raise ValueError("Can't update configs with different criteria")
        self.threshold = min(self.threshold, other.threshold)
        if self.max_dims is None:
            self.max_dims = other.max_dims
        elif other.max_dims is not None:
            self.max_dims = np.maximum(self.max_dims, other.max_dims)

    def relax(self):
        """Loosen both criteria (reference ``configs.py:235-243``)."""
        self.threshold = min(self.threshold * 3, 0.9)
        if self.max_dims is not None:
            self.max_dims = np.maximum(
                np.int64(self.max_dims * 0.8), np.full_like(self.max_dims, 2)
            )

    def copy(self) -> "CompressConfig":
        new = self.__class__.__new__(self.__class__)
        new.__dict__ = self.__dict__.copy()
        if self.max_dims is not None:
            new.max_dims = self.max_dims.copy()
        return new

    def __str__(self):
        return f"\ncriteria: {self.criteria}\nthreshold: {self.threshold}"


class OptimizeConfig:
    """DMRG ground-state optimization configuration
    (reference ``configs.py:267-300``)."""

    def __init__(self, procedure=None):
        if procedure is None:
            self.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]
        else:
            self.procedure = procedure
        self.method = "2site"
        # "davidson" (device lax.while_loop Davidson) or "direct"
        self.algo = "davidson"
        self.nroots = 1
        self.e_rtol = 1e-6
        self.e_atol = 1e-8
        # -1.0 targets the largest eigenvalue
        self.inverse = 1.0

    def copy(self):
        new = self.__class__.__new__(self.__class__)
        new.__dict__ = self.__dict__.copy()
        new.procedure = self.procedure.copy()
        return new


class EvolveMethod(Enum):
    """Time evolution methods (reference ``configs.py:302-321``)."""

    prop_and_compress = "P&C"
    prop_and_compress_tdrk4 = "P&C TD RK4"
    prop_and_compress_tdrk = "P&C TD RK"
    tdvp_ps = "TDVP PS one-site"
    tdvp_ps2 = "TDVP PS two-site"
    tdvp_vmf = "TDVP Variable Mean Field"
    tdvp_mu_cmf = "TDVP Matrix Unfolding Constant Mean Field"
    tdvp_mu_vmf = "TDVP Matrix Unfolding Variable Mean Field"


class EvolveConfig:
    """Time evolution configuration (reference ``configs.py:342-416``)."""

    def __init__(
        self,
        method: Union[EvolveMethod, str] = EvolveMethod.prop_and_compress,
        adaptive=False,
        guess_dt=1e-1,
        adaptive_rtol=5e-4,
        taylor_order: int = None,
        rk_solver="C_RK4",
        reg_epsilon=1e-10,
        ivp_rtol=1e-5,
        ivp_atol=1e-8,
        ivp_solver="krylov",
        force_ovlp=True,
    ):
        if isinstance(method, str):
            method = EvolveMethod[method]
        self.method = method
        self.adaptive = adaptive
        self.rk_config = RungeKutta(rk_solver)
        if taylor_order is None:
            taylor_order = 5 if adaptive else 4
        self.taylor_config = TaylorExpansion(taylor_order)

        self.guess_dt: complex = guess_dt
        self.adaptive_rtol = adaptive_rtol

        self.tdvp_cmf_midpoint = True
        self.tdvp_cmf_c_trapz = False
        self.reg_epsilon: float = reg_epsilon
        self.ivp_rtol: float = ivp_rtol
        self.ivp_atol: float = ivp_atol
        self.ivp_solver: str = ivp_solver
        self.force_ovlp: bool = force_ovlp
        self.vmf_auto_switch: bool = True

    @property
    def is_tdvp(self):
        return self.method not in [
            EvolveMethod.prop_and_compress,
            EvolveMethod.prop_and_compress_tdrk4,
            EvolveMethod.prop_and_compress_tdrk,
        ]

    def check_valid_dt(self, evolve_dt: complex):
        """Forbid real/imag mismatch and direction flips
        (reference ``configs.py:394-402``)."""
        info = f"in config: {self.guess_dt}, in arg: {evolve_dt}"
        if np.iscomplex(evolve_dt) ^ np.iscomplex(self.guess_dt):
            raise ValueError("real and imag not compatible. " + info)
        if np.iscomplex(evolve_dt):
            if evolve_dt.imag * self.guess_dt.imag < 0:
                raise ValueError("evolve into wrong direction. " + info)
        else:
            if evolve_dt * self.guess_dt < 0:
                raise ValueError("evolve into wrong direction. " + info)

    def copy(self):
        new = self.__class__.__new__(self.__class__)
        new.__dict__ = self.__dict__.copy()
        return new

    def __str__(self):
        return "".join(f"\n{k}: {v}" for k, v in self.__dict__.items())


def parse_memory_limit(x) -> float:
    """Parse a memory limit given as a number of bytes or a string like
    '1 GB' (reference ``configs.py:324-339``)."""
    if x is None:
        return float("inf")
    try:
        return float(x)
    except (TypeError, ValueError):
        pass
    try:
        num, unit = str(x).split()
        return float(num) * {"kb": 2 ** 10, "mb": 2 ** 20, "gb": 2 ** 30}[unit.lower()]
    except Exception:
        raise ValueError(f"invalid input for memory: {x}")
