"""Carry MPS/MPO objects between the port and another implementation.

The tests start the JAX package and the port from one state: the JAX site
tensors travel as numpy arrays (``np.asarray(jax_mps[i])``) together with
the quantum-number bookkeeping, and ``mps_from_numpy``/``mpo_from_numpy``
rebuild the port's objects around them on the backend device.
``mps_to_numpy`` is the way back: everything another implementation needs
to rebuild an (evolved) port state.
"""

from typing import Sequence

import numpy as np

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.mps import Mps
from renormalizer_tpu_torch.utils import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
)


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
                   qntot, coeff=1, compress_config=None,
                   evolve_config=None) -> Mps:
    """An :class:`Mps` holding ``arrays`` (one (l, d, r) array per site) with
    bond quantum numbers ``qn`` (one (dim, qn_size) array per bond) and the
    scalar prefactor ``coeff``.  ``compress_config``/``evolve_config`` may be
    the port's objects or another implementation's with the same fields
    (see :func:`carry_compress_config`, :func:`carry_evolve_config`)."""
    mps = _fill(Mps(), model, arrays, qn, qnidx, to_right, qntot)
    mps.coeff = coeff
    if compress_config is not None:
        mps.compress_config = carry_compress_config(compress_config)
    if evolve_config is not None:
        mps.evolve_config = carry_evolve_config(evolve_config)
    return mps


def mps_from_object(model: Model, other) -> Mps:
    """The port's copy of ``other``: any MPS object with the JAX package's
    fields (an iterable of site arrays that ``np.asarray`` accepts, ``qn``,
    ``qnidx``, ``to_right``, ``qntot``, ``coeff``, ``compress_config``,
    ``evolve_config``).  ``model`` is the port's model of the same system."""
    return mps_from_numpy(
        model, [np.asarray(mt) for mt in other], other.qn, other.qnidx,
        other.to_right, other.qntot, coeff=other.coeff,
        compress_config=other.compress_config,
        evolve_config=other.evolve_config)


def mps_to_numpy(mps: Mps) -> dict:
    """The state as host data: ``arrays``, ``qn``, ``qnidx``, ``to_right``,
    ``qntot`` and ``coeff`` — the arguments of :func:`mps_from_numpy`."""
    return {
        "arrays": [to_numpy(mt) for mt in mps],
        "qn": [np.asarray(q).copy() for q in mps.qn],
        "qnidx": mps.qnidx,
        "to_right": mps.to_right,
        "qntot": np.asarray(mps.qntot).copy(),
        "coeff": mps.coeff,
    }


def carry_compress_config(other) -> CompressConfig:
    """The port's ``CompressConfig`` with the criteria, the threshold and the
    bond limits of ``other`` (any object with those fields)."""
    config = CompressConfig(CompressCriteria[other.criteria.name],
                            threshold=other.threshold,
                            max_bonddim=other.bond_dim_max_value)
    if other.max_dims is not None:
        config.max_dims = np.array(other.max_dims, dtype=int)
    return config


def carry_evolve_config(other) -> EvolveConfig:
    """The port's ``EvolveConfig`` with the method and the adaptive-step
    fields of ``other``."""
    return EvolveConfig(EvolveMethod[other.method.name],
                        adaptive=other.adaptive, guess_dt=other.guess_dt,
                        adaptive_rtol=other.adaptive_rtol)


def mpo_from_numpy(model: Model, arrays, qn, qnidx: int, to_right: bool,
                   qntot) -> Mpo:
    """An :class:`Mpo` holding ``arrays`` (one (l, d, d, r) array per site)."""
    return _fill(Mpo(), model, arrays, qn, qnidx, to_right, qntot)
