"""Small shared helpers (numpy copy of ``renormalizer_tpu/utils/utils.py``)."""

from typing import List, Union

import numpy as np
import scipy.linalg


def sizeof_fmt(num, suffix="B"):
    for unit in ["", "Ki", "Mi", "Gi", "Ti", "Pi", "Ei", "Zi"]:
        if abs(num) < 1024.0:
            return "%3.1f%s%s" % (num, unit, suffix)
        num /= 1024.0
    return "%.1f%s%s" % (num, "Yi", suffix)


class cached_property:
    """Compute once, then replace with an instance attribute."""

    def __init__(self, func):
        self.__doc__ = getattr(func, "__doc__")
        self.func = func

    def __get__(self, obj, cls):
        if obj is None:
            return self
        value = obj.__dict__[self.func.__name__] = self.func(obj)
        return value


def calc_vn_entropy(p: Union[np.ndarray, List[float]]) -> float:
    """Von Neumann entropy from density-matrix eigenvalues."""
    p = np.asarray(p)
    assert np.allclose(p[p < 0], 0, atol=1e-8)
    p = p / p.sum()
    p = p[0 < p]
    return float(-(p * np.log(p)).sum())


def calc_vn_entropy_dm(dm: np.ndarray) -> float:
    """Von Neumann entropy from a (possibly unraveled) density matrix."""
    dim = int(np.prod(dm.shape[: dm.ndim // 2]))
    w = scipy.linalg.eigh(np.asarray(dm).reshape(dim, dim), eigvals_only=True)
    w = np.where(w < 0, 0, w)
    return calc_vn_entropy(w)
