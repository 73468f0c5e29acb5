r"""Effective-Hamiltonian contractions for tree tensor networks.

Port of ``renormalizer_tpu/tn/hop_expr.py`` (reference
``renormalizer/tn/hop_expr.py:10-135``).  The index-label scheme is shared
with ``tn.tree``; each matvec closure maps its labels to an einsum formula
once and then runs the pairwise einsum, whose plan is cached per (formula,
shapes).  :func:`hop_formula2` gives the 2-site matvec as an einsum
``(formula, operands)`` pair for the sharded mesh hop
(``parallel.hop.sharded_general_hop_factory``).
"""

from renormalizer_tpu_torch.ops.contract import einsum, einsum_interleaved, label_formula
from renormalizer_tpu_torch.tn.node import TreeNodeTensor
from renormalizer_tpu_torch.tn.tree import TTNEnviron, TTNO, TTNS


def _make_expr(args, x_indices, y_indices):
    """Return a matvec closure contracting ``args`` (tensor, labels, ...)
    with an input tensor labeled by ``x_indices`` into ``y_indices``."""
    tensors = list(args[0::2])
    formula = label_formula(list(args[1::2]) + [x_indices], y_indices)

    def expr(x):
        return einsum(formula, *tensors, x)

    return expr


def hop_expr0(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron):
    """Zero-site (bond) effective Hamiltonian: child-env x parent-env
    (reference ``tn/hop_expr.py:10-40``)."""
    enode = ttne.node_list[ttns.node_idx[snode]]
    args = []
    input_indices = []
    output_indices = []

    tensor = enode.parent.environ_children[enode.idx_as_child]
    indices = ttne.get_child_indices(enode.parent, enode.idx_as_child, ttns, ttno)
    output_indices.append(indices[0])
    input_indices.append(indices[2])
    args.extend([tensor, indices])

    tensor = enode.environ_parent
    indices = ttne.get_parent_indices(enode, ttns, ttno)
    assert len(indices) == 3
    indices = list(indices)
    indices[0] = tuple(list(indices[0]) + ["hop0_conj"])
    indices[2] = tuple(list(indices[2]) + ["hop0"])
    output_indices.append(indices[0])
    input_indices.append(indices[2])
    args.extend([tensor, indices])

    return _make_expr(args, input_indices, output_indices)


def hop_expr1(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron,
              return_hdiag=False):
    """One-site effective Hamiltonian (reference ``tn/hop_expr.py:43-73``)."""
    enode = ttne.node_list[ttns.node_idx[snode]]
    onode = ttno.node_list[ttns.node_idx[snode]]

    args = []
    for i, env_child in enumerate(enode.environ_children):
        args.extend([env_child, ttne.get_child_indices(enode, i, ttns, ttno)])
    args.extend([enode.environ_parent, ttne.get_parent_indices(enode, ttns, ttno)])
    args.extend([onode.tensor, ttno.get_node_indices(onode)])

    input_indices = ttns.get_node_indices(snode, ttno=ttno)
    output_indices = ttns.get_node_indices(snode, conj=True)
    expr = _make_expr(args, input_indices, output_indices)
    if not return_hdiag:
        return expr
    return expr, _get_hdiag(args, input_indices)


def _expr2_args(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron):
    sparent = snode.parent
    enode = ttne.node_list[ttns.node_idx[snode]]
    eparent = ttne.node_list[ttns.node_idx[sparent]]
    onode = ttno.node_list[ttns.node_idx[snode]]
    oparent = ttno.node_list[ttns.node_idx[sparent]]

    args = []
    for i, env_child in enumerate(enode.environ_children):
        args.extend([env_child, ttne.get_child_indices(enode, i, ttns, ttno)])
    for i, env_child in enumerate(eparent.environ_children):
        if eparent.children[i] is enode:
            continue
        args.extend([env_child, ttne.get_child_indices(eparent, i, ttns, ttno)])
    args.extend([eparent.environ_parent, ttne.get_parent_indices(eparent, ttns, ttno)])
    args.extend([oparent.tensor, ttno.get_node_indices(oparent)])
    args.extend([onode.tensor, ttno.get_node_indices(onode)])

    input_indices = ttns.get_node_indices(snode, include_parent=True, ttno=ttno)
    output_indices = ttns.get_node_indices(snode, conj=True, include_parent=True)
    return args, input_indices, output_indices


def hop_formula2(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron):
    """The two-site (node + parent) effective-H matvec as a standard einsum
    ``(formula, operands)`` pair, and its diagonal: the form the
    bond-tensor-parallel mesh factory
    (``parallel.hop.sharded_general_hop_factory``) shards.  The local (ket)
    tensor is the LAST term of the formula and not among the operands."""
    args, input_indices, output_indices = _expr2_args(snode, ttns, ttno, ttne)
    formula = label_formula(list(args[1::2]) + [input_indices], output_indices)
    return formula, list(args[0::2]), _get_hdiag(args, input_indices)


def hop_expr2(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron):
    """Two-site (node + parent) effective Hamiltonian and its diagonal
    (reference ``tn/hop_expr.py:76-113``)."""
    formula, operands, hdiag = hop_formula2(snode, ttns, ttno, ttne)
    return (lambda x: einsum(formula, *operands, x)), hdiag


def _is_conj_label(label) -> bool:
    return isinstance(label, tuple) and str(label[0]).endswith("_conj")


def _get_hdiag(args, input_indices):
    """Diagonal of the effective Hamiltonian: identify each environment's bra
    label with its ket label and each MPO 'up' label with its 'down' label,
    then contract onto the ket index pattern (a label repeated inside one
    operand takes its diagonal; the intent of reference
    ``tn/hop_expr.py:127-148``)."""
    new_args = []
    for arg in args:
        if not isinstance(arg, (tuple, list)):
            new_args.append(arg)
            continue
        labels = list(arg)
        for i, label in enumerate(labels):
            if _is_conj_label(label):
                # the matching ket label: same tuple without the _conj suffix
                labels[i] = tuple([str(label[0])[:-5]] + list(label[1:]))
            elif isinstance(label, tuple) and len(label) == 2 and label[0] == "up":
                labels[i] = ("down", label[1])
        new_args.append(labels)
    new_args.append(input_indices)
    return einsum_interleaved(*new_args)
