"""Device, dtype and random-number policy of the PyTorch port.

Counterpart of ``renormalizer_tpu/backend.py``.  Everything the DMRG path
computes lives on one ``torch.device`` held here:

* ``RENO_PLATFORM=cpu|cuda`` picks the device (the same variable the JAX
  package reads).  The default is ``cuda`` when torch was built with CUDA
  and ``cpu`` otherwise.  Asking for CUDA without a visible card raises: the
  port never drops to the CPU on its own.
* ``RENO_DTYPE=fp32|fp64`` picks the working precision; the default is fp64
  on the CPU (parity with the reference) and fp32 on CUDA.
* TF32 is switched off for matmuls and cuDNN alike.  TF32 keeps ~3 decimal
  digits, the same class of error that broke variationality with bf16-pass
  matmuls in the JAX package.
* Every random draw takes an explicit ``torch.Generator`` seeded with
  :attr:`Backend.seed` (2019, the JAX package's seed), so numpy-side draws
  (``Mps.random``) match the JAX package exactly.
* :meth:`Backend.use_device` points the backend at another device for a
  scope (``cv.spectra_cv.batch_run``'s workers, one per visible card), the
  counterpart of ``jax.default_device``.
"""

import contextlib
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)

_NP_OF_TORCH = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def _decide_device() -> torch.device:
    platform = os.environ.get("RENO_PLATFORM", "").lower()
    if not platform:
        platform = "cuda" if torch.version.cuda is not None else "cpu"
    if platform == "cpu":
        return torch.device("cpu")
    if platform in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "RENO_PLATFORM selects CUDA (the default for a CUDA build of "
                "torch) but no CUDA device is visible; set RENO_PLATFORM=cpu "
                "to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"RENO_PLATFORM={platform!r}: expected 'cpu' or 'cuda'")


def _decide_dtype_bits(device: torch.device) -> int:
    env = os.environ.get("RENO_DTYPE", "").lower()
    if env in ("fp64", "64", "float64"):
        return 64
    if env in ("fp32", "32", "float32"):
        return 32
    return 64 if device.type == "cpu" else 32


class Backend:
    """Holds the device, the dtype policy and the seed."""

    def __init__(self):
        self.device = _decide_device()
        self._bits = _decide_dtype_bits(self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._seed = 2019
        self.canonical_atol = 1e-3 if self._bits == 32 else 1e-5
        self.canonical_rtol = 1e-2 if self._bits == 32 else 1e-5
        logger.info("renormalizer_tpu_torch backend: device=%s precision=fp%d",
                    self.device, self._bits)

    @property
    def is_32bits(self) -> bool:
        return self._bits == 32

    @property
    def real_dtype(self) -> torch.dtype:
        return torch.float32 if self._bits == 32 else torch.float64

    @property
    def complex_dtype(self) -> torch.dtype:
        return torch.complex64 if self._bits == 32 else torch.complex128

    @property
    def seed(self) -> int:
        return self._seed

    def generator(self) -> torch.Generator:
        """A fresh generator on the backend device, seeded with
        :attr:`seed`.  Callers that draw per call (the truncation sketch)
        take a new one each time, so a call's draws do not depend on what
        ran before it — as the JAX package's fixed ``PRNGKey(seed)``."""
        return torch.Generator(device=self.device).manual_seed(self._seed)

    @contextlib.contextmanager
    def use_device(self, device):
        """Within the scope, :attr:`device` (so :meth:`tensor`,
        :meth:`generator` and the truncation's index caches) is ``device``,
        and so is the current CUDA device."""
        prev = self.device
        self.device = torch.device(device)
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    yield
            else:
                yield
        finally:
            self.device = prev

    def tensor(self, x, dtype: torch.dtype = None) -> torch.Tensor:
        """``x`` (numpy, python scalar or tensor) as a tensor on the
        backend device, cast to ``dtype`` when given."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def sync(self):
        """Wait for all queued device work (for timing)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype."""
    return _NP_OF_TORCH[dtype]


backend = Backend()
