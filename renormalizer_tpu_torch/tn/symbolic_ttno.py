r"""Symbolic TTNO compiler: sum-of-product operator -> compact TTNO.

Port of ``renormalizer_tpu/tn/symbolic_ttno.py``, host code on the port's
numpy copy of the MPO compiler (``mps/symbolic_mpo.py``).  Postorder
generalization of the MPO compiler
(reference ``renormalizer/tn/symbolic_ttno.py:16-110``): at each tree node
the operator table splits into the already-visited children/physical columns
(row part) and the rest (column part); ``_decompose_one_site`` with k input
bonds produces the node's outgoing bond operators.
"""

import logging
from itertools import chain
from typing import List

import numpy as np

from renormalizer_tpu_torch.model import Model, Op
from renormalizer_tpu_torch.model.basis import BasisSet
from renormalizer_tpu_torch.mps.symbolic_mpo import (
    OpTuple,
    _decompose_one_site,
    _terms_to_table,
)
from renormalizer_tpu_torch.tn.treebase import BasisTree

logger = logging.getLogger(__name__)


def compose_symbolic_mo_general(in_ops_list, out_ops, primary_ops, k):
    """Render a multi-input-bond symbolic node
    (reference ``symbolic_ttno.py:16-32``)."""
    shape = [len(in_ops) for in_ops in in_ops_list] + [len(out_ops)]
    mo = np.empty(shape, dtype=object)
    for idx in np.ndindex(*mo.shape):
        mo[idx] = []
    for iop, out_op in enumerate(out_ops):
        for entry in out_op:
            if in_ops_list:
                slot = mo[tuple(entry.symbol[:-k])][iop]
            else:
                slot = mo[iop]
            op = entry.factor
            for s in entry.symbol[-k:]:
                op = op * primary_ops[s]
            slot.append(op)
    return mo


def symbolic_mo_to_numeric_mo_general(basis_sets: List[BasisSet], mo, dtype):
    """Evaluate a symbolic tree node into the numeric TTNO tensor with layout
    (childbond..., updown pairs..., parentbond)
    (reference ``symbolic_ttno.py:36-52``)."""
    model = Model(basis_sets, [])
    pdims = [b.nbas for b in basis_sets]
    shape = list(mo.shape) + list(chain(*[[p, p] for p in pdims]))
    tensor = np.zeros(shape, dtype=dtype)
    for idx, terms in np.ndenumerate(mo):
        for term in terms:
            split, factor = term.split_elementary(model.dof_to_siteidx)
            assert len(split) == len(basis_sets)
            elem = np.eye(1) * factor
            for symbol, b in zip(split, basis_sets):
                elem = np.tensordot(elem, b.op_mat(symbol)[None, :, :, None], axes=1)
            assert not np.iscomplexobj(elem), "complex operator not supported yet"
            tensor[idx] += elem[0, ..., 0]
    # move the out-bond axis to the last position
    return np.moveaxis(tensor, mo.ndim - 1, -1)


def construct_symbolic_ttno(tn: BasisTree, terms: List[Op], const: float = 0, algo: str = "qr"):
    """Compile operator terms onto a basis tree; returns (symbolic nodes in
    postorder, bond quantum numbers) (reference ``symbolic_ttno.py:55-110``)."""
    nodes = tn.postorder_list()
    basis = list(chain(*[n.basis_sets for n in nodes]))
    model = Model(basis, [])
    qn_size = model.qn_size
    table, primary_ops, factor = _terms_to_table(model, terms, const)

    dummy_in_ops = [[OpTuple([0], qn=np.zeros(qn_size, dtype=int), factor=1)]]
    out_ops_list = []
    for i, node in enumerate(nodes):
        k = node.n_sets
        if not node.children:
            pad = np.zeros((table.shape[0], 1), dtype=np.uint16)
            table = np.concatenate((pad, table), axis=1)
            table_row = table[:, : k + 1]
            table_col = table[:, k + 1:]
            in_ops_list = [dummy_in_ops]
        else:
            children_idx = [nodes.index(n) for n in node.children]
            assert np.all(np.array(children_idx) < i)
            in_ops_list = [out_ops_list[j] for j in children_idx]
            m = len(node.children)
            # the children's bond columns sit at the end; roll them in front
            table = np.roll(table, m, axis=1)
            table_row = table[:, : m + k]
            table_col = table[:, m + k:]
        out_ops, table, factor = _decompose_one_site(
            table_row, table_col, in_ops_list, factor, primary_ops, algo, k
        )
        # the freshly produced bond column goes to the back of the queue
        table = np.roll(table, -1, axis=1)
        out_ops_list.append(out_ops)

    mpo = []
    for i, node in enumerate(nodes):
        children_idx = [nodes.index(n) for n in node.children]
        in_ops_list = [out_ops_list[j] for j in children_idx]
        mpo.append(
            compose_symbolic_mo_general(in_ops_list, out_ops_list[i], primary_ops, node.n_sets)
        )
    mpoqn = [np.array([ops[0].qn for ops in out_ops]) for out_ops in out_ops_list]
    return mpo, mpoqn
