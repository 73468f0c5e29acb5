r"""Device <-> host-memory tiering.

Port of ``renormalizer_tpu/mps/offload.py``.  The reference offloads big
site tensors to disk (``renormalizer/mps/mp.py:1047-1080``) and keeps
environments on the host (``mps/lib.py:114-118``).  Here the two tiers are
the card's memory and pinned host memory: cold environment entries and site
tensors far from the sweep center move to the host without waiting and come
back one site ahead of the sweep, so large-M runs are bounded by host memory
instead of device memory while the hot path stays on the card.

``RENO_HOST_OFFLOAD=N`` keeps the N most recently used environment entries
(and the site tensors within N sites of the center) on the device; 0, the
default, disables the tiering.  Site tensors move only from
``CompressConfig.dump_matrix_size`` bytes up.

Every copy is issued on the current CUDA stream, so a tensor brought back
while its copy to the host is still running is ordered behind that copy.
On the CPU both directions keep the tensor as it is and only the counters
move, as the JAX package's ``device_put`` to the CPU does.
"""

import os
from collections import OrderedDict
from functools import lru_cache

import torch

from renormalizer_tpu_torch.backend import backend


@lru_cache(maxsize=1)
def hot_window() -> int:
    """0 disables the tiering; N keeps the N most recently used entries on
    the device.  Read once per process (``hot_window.cache_clear()`` to read
    ``RENO_HOST_OFFLOAD`` again)."""
    return int(os.environ.get("RENO_HOST_OFFLOAD", "0"))


def on_host(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` in pinned host memory, the copy started without waiting; on
    the CPU ``x`` itself.  The copy keeps the layout (the order of the
    strides): a permuted view restored as a contiguous tensor sends the
    next product down another cuBLAS path, and on an H100 that moved
    phase 15(c)'s fp32 DMRG energies by 6.5e-7 relative."""
    if x.device.type == "cpu":
        return x
    out = torch.empty_like(x, device="cpu", pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


def to_device(x: torch.Tensor) -> torch.Tensor:
    """``x`` on ``backend.device`` in the same layout, the copy started
    without waiting."""
    if x.device == backend.device:
        return x
    return x.to(backend.device, non_blocking=True)


class TieredStore:
    """Mapping of key -> tensor with LRU host offload of the cold entries.

    Reads restore (and re-warm) entries transparently; :meth:`prefetch`
    starts the copy of an upcoming key back to the device without
    waiting."""

    def __init__(self, hot: int):
        assert hot > 0
        self.hot = hot
        self._data = OrderedDict()
        self._cold = set()  # keys living on the host tier
        self.n_evicted = 0
        self.n_restored = 0

    def __setitem__(self, key, value):
        self._data[key] = value
        self._cold.discard(key)
        self._data.move_to_end(key)
        self._evict()

    def __getitem__(self, key):
        v = self._data[key]
        if key in self._cold:
            v = to_device(v)
            self._data[key] = v
            self._cold.discard(key)
            self.n_restored += 1
        self._data.move_to_end(key)
        return v

    def __contains__(self, key):
        return key in self._data

    def prefetch(self, key):
        if key in self._cold:
            self._data[key] = to_device(self._data[key])
            self._cold.discard(key)
            self.n_restored += 1

    def _evict(self):
        if len(self._data) <= self.hot:
            return
        ncold = len(self._data) - self.hot
        for key in list(self._data.keys())[:ncold]:
            if key not in self._cold:
                self._data[key] = to_host(self._data[key])
                self._cold.add(key)
                self.n_evicted += 1
