"""Carry MPS/MPO and tree (TTNS/TTNO) objects between the port and another
implementation.

The tests start the JAX package and the port from one state: the JAX site
tensors travel as numpy arrays (``np.asarray(jax_mps[i])``) together with
the quantum-number bookkeeping, and ``mps_from_numpy``/``mpo_from_numpy``
rebuild the port's objects around them on the backend device
(``mpdm_from_object`` for a density matrix with 4-leg sites).
``mps_to_numpy`` is the way back: everything another implementation needs
to rebuild an (evolved) port state.  ``ttns_from_object``/``ttno_from_object``
and ``ttns_to_numpy`` do the same for trees: one tensor and one qn array per
node, in ``node_list`` (preorder) order, on the port's basis tree of the
same system.
"""

from typing import Sequence

import numpy as np

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.mps.mpdm import MpDm
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
                   evolve_config=None, cls=Mps) -> Mps:
    """An :class:`Mps` (or ``cls``, e.g. :class:`MpDm` for (l, d, d, r)
    sites) holding ``arrays`` (one (l, d, r) array per site) with bond
    quantum numbers ``qn`` (one (dim, qn_size) array per bond) and the
    scalar prefactor ``coeff``.  ``compress_config``/``evolve_config`` may be
    the port's objects or another implementation's with the same fields
    (see :func:`carry_compress_config`, :func:`carry_evolve_config`)."""
    mps = _fill(cls(), model, arrays, qn, qnidx, to_right, qntot)
    mps.coeff = coeff
    if compress_config is not None:
        mps.compress_config = carry_compress_config(compress_config)
    if evolve_config is not None:
        mps.evolve_config = carry_evolve_config(evolve_config)
    return mps


def mps_from_object(model: Model, other, cls=Mps) -> Mps:
    """The port's copy of ``other``: any MPS object with the JAX package's
    fields (an iterable of site arrays that ``np.asarray`` accepts, ``qn``,
    ``qnidx``, ``to_right``, ``qntot``, ``coeff``, ``compress_config``,
    ``evolve_config``).  ``model`` is the port's model of the same system."""
    return mps_from_numpy(
        model, [np.asarray(mt) for mt in other], other.qn, other.qnidx,
        other.to_right, other.qntot, coeff=other.coeff,
        compress_config=other.compress_config,
        evolve_config=other.evolve_config, cls=cls)


def mpdm_from_object(model: Model, other) -> MpDm:
    """The port's copy of a density matrix ``other`` with the JAX package's
    ``MpDm`` fields: (l, d, d, r) sites whose quantum numbers sit on the bra
    index, with ``qn``, ``qnidx``, ``qntot``, ``to_right``, ``coeff`` and
    the compress and evolve configs."""
    assert all(np.ndim(mt) == 4 for mt in other), "not a density matrix"
    return mps_from_object(model, other, cls=MpDm)


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
    """The port's ``EvolveConfig`` with the method, the adaptive-step fields,
    the Taylor order and the Runge-Kutta tableau of ``other``."""
    return EvolveConfig(EvolveMethod[other.method.name],
                        adaptive=other.adaptive, guess_dt=other.guess_dt,
                        adaptive_rtol=other.adaptive_rtol,
                        taylor_order=other.taylor_config.order,
                        rk_solver=other.rk_config.method)


def mpo_from_numpy(model: Model, arrays, qn, qnidx: int, to_right: bool,
                   qntot) -> Mpo:
    """An :class:`Mpo` holding ``arrays`` (one (l, d, d, r) array per site)."""
    return _fill(Mpo(), model, arrays, qn, qnidx, to_right, qntot)


def _tree_root(basis_tree, arrays, qn):
    from renormalizer_tpu_torch.tn.node import TreeNodeTensor, copy_connection

    nodes = [TreeNodeTensor(np.asarray(a), np.asarray(q)) for a, q in zip(arrays, qn)]
    assert len(nodes) == len(basis_tree.node_list)
    return copy_connection(basis_tree.node_list, nodes)


def ttns_from_numpy(basis_tree, arrays, qn, coeff=1, compress_config=None,
                    evolve_config=None):
    """A :class:`~renormalizer_tpu_torch.tn.TTNS` on ``basis_tree`` holding
    ``arrays`` (one tensor per node in ``node_list`` order, layout
    ``[children..., physical..., parent]``) with the per-node bond quantum
    numbers ``qn`` (the root's row is the total quantum number).  The
    evolve config keeps VMF's ``reg_epsilon``, ``ivp_rtol`` and ``ivp_atol``
    of ``evolve_config`` too."""
    from renormalizer_tpu_torch.tn import TTNS

    ttns = TTNS(basis_tree, root=_tree_root(basis_tree, arrays, qn))
    ttns.coeff = coeff
    if compress_config is not None:
        ttns.compress_config = carry_compress_config(compress_config)
    if evolve_config is not None:
        ttns.evolve_config = carry_evolve_config(evolve_config)
        for field in ("reg_epsilon", "ivp_rtol", "ivp_atol", "force_ovlp"):
            setattr(ttns.evolve_config, field, getattr(evolve_config, field))
    return ttns


def ttns_from_object(basis_tree, other):
    """The port's copy of the tree state ``other`` (any object with the JAX
    package's TTNS fields: ``node_list`` of nodes with ``tensor`` and
    ``qn``, ``coeff``, ``compress_config``, ``evolve_config``) on the port's
    ``basis_tree`` of the same system and topology."""
    return ttns_from_numpy(
        basis_tree, [np.asarray(n.tensor) for n in other.node_list],
        [n.qn for n in other.node_list], coeff=other.coeff,
        compress_config=other.compress_config, evolve_config=other.evolve_config)


def ttns_to_numpy(ttns) -> dict:
    """The tree state as host data: ``arrays`` and ``qn`` per node in
    ``node_list`` order, ``qntot`` and ``coeff``."""
    return {
        "arrays": [to_numpy(n.tensor) for n in ttns.node_list],
        "qn": [np.asarray(n.qn).copy() for n in ttns.node_list],
        "qntot": np.asarray(ttns.qntot).copy(),
        "coeff": ttns.coeff,
    }


def ttno_from_object(basis_tree, other, terms=None):
    """The port's copy of the tree operator ``other`` (``node_list`` of
    nodes with ``tensor`` and ``qn``) on ``basis_tree``; ``terms`` are the
    port's operator terms it stands for (default: none)."""
    from renormalizer_tpu_torch.tn import TTNO

    return TTNO(basis_tree, [] if terms is None else terms,
                root=_tree_root(basis_tree, [np.asarray(n.tensor) for n in other.node_list],
                                [n.qn for n in other.node_list]))
