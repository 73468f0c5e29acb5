r"""Device mesh construction and the process-global mesh.

Port of ``renormalizer_tpu/parallel/mesh.py``.  A :class:`Mesh` is a numpy
object array of ``torch.device`` of shape ``(data, i, j)`` with the JAX
package's axis names; one Python process places tensors on its devices
(there is no SPMD launcher and no process group).  A device may appear more
than once: ``["cpu"] * 4`` in the tests, ``["cuda:0"] * 4`` on a one-card
machine, where every piece of the sharded path runs and only the copies
between cards are skipped.
"""

import logging
from typing import Optional

import numpy as np
import torch

from renormalizer_tpu_torch.backend import resolve_device

logger = logging.getLogger(__name__)

_GLOBAL_MESH = None


class Mesh:
    """``devices``: an object array of ``torch.device`` laid out over
    ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "i", "j")):
        assert devices.ndim == len(axis_names)
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def visible_devices():
    """The distinct visible CUDA devices, in ordinal order."""
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_mesh(data: int = 1, i: int = 1, j: int = 1, devices=None) -> Mesh:
    """An ``(data, i, j)`` mesh over the first ``data*i*j`` of ``devices``
    (default: the distinct visible CUDA devices).  An explicit list may
    repeat a device; ``"cuda"`` is resolved to the current card, so one card
    spelled two ways is one device."""
    if devices is None:
        devices = visible_devices()
    n = data * i * j
    if len(devices) < n:
        raise RuntimeError(
            f"mesh (data={data}, i={i}, j={j}) needs {n} devices, "
            f"found {len(devices)}"
        )
    arr = np.empty(n, dtype=object)
    arr[:] = [resolve_device(d) for d in devices[:n]]
    return Mesh(arr.reshape(data, i, j))


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    """Install ``mesh`` as the process-global mesh used by the sweep
    algorithms; pass ``None`` to disable sharding."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    if mesh is not None:
        logger.info(f"global mesh set: {mesh.shape}")


def get_global_mesh() -> Optional[Mesh]:
    return _GLOBAL_MESH
