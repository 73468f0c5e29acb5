"""renormalizer_tpu_torch — the PyTorch + CUDA port of renormalizer_tpu.

DMRG, real-time dynamics and finite-temperature density matrices for
electron-phonon and spin-boson models on MPS/MPO, running on one NVIDIA
Hopper card (or on the CPU for tests).  The port carries the 2-site DMRG main
path, every evolution method of ``Mps.evolve`` (one- and two-site TDVP-PS,
MU-VMF/VMF, MU-CMF, propagate-and-compress), the thermal
density matrix (``MpDm``, ``ThermalProp``) and the jobs built on them
(``sbm``, ``spectra``, ``transport``: Kubo mobility, charge diffusion,
the spectral function; ``property``) of the JAX package
``renormalizer_tpu``, which stays the reference; its one
hand-written kernel (the Jacobi eigensolver of the truncation step) lives in
``csrc/`` and is built with ``nvcc`` at first use.  The port imports torch,
numpy and scipy, never jax.
"""

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.utils import log

from renormalizer_tpu_torch.model import (
    BasisDummy,
    BasisHalfSpin,
    BasisHopsBoson,
    BasisMultiElectron,
    BasisMultiElectronVac,
    BasisSHO,
    BasisSimpleElectron,
    BasisSineDVR,
    HolsteinModel,
    Model,
    Mol,
    Op,
    OpSum,
    Phonon,
    SpinBosonModel,
    TI1DModel,
)
from renormalizer_tpu_torch.utils import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    OptimizeConfig,
    Quantity,
    TdMpsJob,
)
from renormalizer_tpu_torch.mps import (
    BraKetPair,
    MpDm,
    Mpo,
    Mps,
    ThermalProp,
    compressed_sum,
    load_thermal_state,
    optimize_mps,
)

__version__ = "0.1.0"
