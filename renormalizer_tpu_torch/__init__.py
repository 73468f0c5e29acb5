"""renormalizer_tpu_torch — the PyTorch + CUDA port of renormalizer_tpu.

DMRG for electron-phonon models on MPS/MPO, running on one NVIDIA Hopper
card (or on the CPU for tests).  The port carries the 2-site DMRG main path
of the JAX package ``renormalizer_tpu``, which stays the reference; its one
hand-written kernel (the Jacobi eigensolver of the truncation step) lives in
``csrc/`` and is built with ``nvcc`` at first use.  The port imports torch,
numpy and scipy, never jax.
"""

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.utils import log

from renormalizer_tpu_torch.model import HolsteinModel, Model, Mol, Op, OpSum, Phonon
from renormalizer_tpu_torch.utils import (
    CompressConfig,
    CompressCriteria,
    OptimizeConfig,
    Quantity,
)
from renormalizer_tpu_torch.mps import Mps, Mpo, optimize_mps

__version__ = "0.1.0"
