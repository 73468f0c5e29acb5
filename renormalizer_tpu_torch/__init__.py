"""renormalizer_tpu_torch — the PyTorch + CUDA port of renormalizer_tpu.

DMRG and real-time dynamics for electron-phonon and spin-boson models on
MPS/MPO, running on one NVIDIA Hopper card (or on the CPU for tests).  The
port carries the 2-site DMRG main path and the one-site TDVP-PS evolution
(with the spin-boson job in ``renormalizer_tpu_torch.sbm``) of the
JAX package ``renormalizer_tpu``, which stays the reference; its one
hand-written kernel (the Jacobi eigensolver of the truncation step) lives in
``csrc/`` and is built with ``nvcc`` at first use.  The port imports torch,
numpy and scipy, never jax.
"""

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.utils import log

from renormalizer_tpu_torch.model import (
    BasisHalfSpin,
    HolsteinModel,
    Model,
    Mol,
    Op,
    OpSum,
    Phonon,
    SpinBosonModel,
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
from renormalizer_tpu_torch.mps import Mps, Mpo, compressed_sum, optimize_mps

__version__ = "0.1.0"
