r"""Thermofield helpers for electron-phonon tree networks.

Port of ``renormalizer_tpu/tn/utils_eph.py``.  Builds the
T=:math:`\infty` one-exciton starting state used by finite-temperature tree
dynamics on a P/Q-doubled basis tree (thermofield doubling: every physical
DoF is paired with an auxiliary ``("Q", dof)`` partner, cf.
``BasisTree.add_auxiliary_space``).  Reference semantics:
``renormalizer/tn/utils_eph.py``.
"""

import numpy as np

from renormalizer_tpu_torch.model import Op
from renormalizer_tpu_torch.tn.node import TreeNodeTensor, copy_connection
from renormalizer_tpu_torch.tn.tree import TTNO, TTNS
from renormalizer_tpu_torch.tn.treebase import BasisTree


def _is_aux_dof(dof) -> bool:
    """An auxiliary (Q-space) DoF is tagged ``("Q", original_dofs)``."""
    return isinstance(dof, tuple) and len(dof) == 2 and dof[0] == "Q"


def _infinite_t_tensor(basis_node) -> np.ndarray:
    """Bond-1 node tensor of the T=inf vacuum on a doubled tree.

    A (P, Q) phonon pair carries the maximally-entangled diagonal
    :math:`\\sum_n |n\\rangle_P |n\\rangle_Q / \\sqrt{d}`; a (P, Q) electron
    pair starts in the joint vacuum; a dummy internal node is scalar 1.
    """
    d = basis_node.basis_sets[0].nbas
    child_legs = [1] * len(basis_node.children)
    if basis_node.n_sets == 1:
        if d != 1:
            raise ValueError(f"dummy node with nbas={d}")
        return np.ones(child_legs + [1, 1])
    if basis_node.n_sets != 2:
        raise ValueError(f"expected a (P, Q) pair, got {basis_node.n_sets} sets")
    pair = np.zeros((d, d))
    if basis_node.basis_sets[0].is_phonon:
        np.fill_diagonal(pair, d ** -0.5)
    else:
        pair[0, 0] = 1.0
    return pair.reshape(child_legs + [d, d, 1])


def max_entangled_ex(basis_tree: BasisTree) -> TTNS:
    """T=inf max-entangled one-exciton TTNS on a P/Q-doubled tree: the
    vacuum product state excited by :math:`a^\\dagger_P a^\\dagger_Q` on
    every electronic pair."""
    zero_qn = np.zeros((1, basis_tree.qn_size), dtype=int)
    state_nodes = [
        TreeNodeTensor(_infinite_t_tensor(bn), zero_qn.copy())
        for bn in basis_tree
    ]
    copy_connection(basis_tree.node_list, state_nodes)
    vacuum = TTNS(basis_tree, root=state_nodes[0])

    excite = TTNO(basis_tree, [
        Op(r"a^\dagger a^\dagger", [b.dof, ("Q", b.dofs)], qn=[1, 0])
        for b in basis_tree.basis_list
        if b.is_electron and not _is_aux_dof(b.dof)
    ])
    state = excite.apply(vacuum)
    state.normalize("ttns_and_coeff")
    return state
