"""Build the port's MPS/MPO objects from another implementation's tensors.

The tests start the JAX package and the port from one state: the JAX site
tensors travel as numpy arrays (``np.asarray(jax_mps[i])``) together with
the quantum-number bookkeeping, and these functions rebuild the port's
objects around them on the backend device.
"""

from typing import Sequence

import numpy as np

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.mps import Mps


def _fill(mp, model: Model, arrays: Sequence[np.ndarray], qn, qnidx: int,
          to_right: bool, qntot):
    mp.model = model
    if any(np.iscomplexobj(a) for a in arrays):
        from renormalizer_tpu_torch.backend import backend

        mp.dtype = backend.complex_dtype
    for a in arrays:
        mp.append(np.asarray(a))
    mp.qn = [np.asarray(q).astype(int).reshape(len(q), -1) for q in qn]
    mp.qnidx = int(qnidx)
    mp.to_right = bool(to_right)
    mp.qntot = np.atleast_1d(np.asarray(qntot)).astype(int)
    return mp


def mps_from_numpy(model: Model, arrays, qn, qnidx: int, to_right: bool,
                   qntot) -> Mps:
    """An :class:`Mps` holding ``arrays`` (one (l, d, r) array per site) with
    bond quantum numbers ``qn`` (one (dim, qn_size) array per bond)."""
    return _fill(Mps(), model, arrays, qn, qnidx, to_right, qntot)


def mpo_from_numpy(model: Model, arrays, qn, qnidx: int, to_right: bool,
                   qntot) -> Mpo:
    """An :class:`Mpo` holding ``arrays`` (one (l, d, d, r) array per site)."""
    return _fill(Mpo(), model, arrays, qn, qnidx, to_right, qntot)
