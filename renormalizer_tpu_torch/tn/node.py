"""Tree node types for the tree tensor network (TTN) engine.

Port of ``renormalizer_tpu/tn/node.py`` (reference
``renormalizer/tn/node.py:8-244``).  ``TreeNodeTensor`` keeps its numeric
tensor as a torch tensor on the backend device and its quantum numbers as a
numpy array; index ordering is ``[child1, ..., childN, physical1, ...,
physicalM, parent]``.
"""

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.model.basis import BasisDummy, BasisSet


class TreeNode:
    def __init__(self):
        self.children: List["TreeNode"] = []
        self.parent: "TreeNode" = None

    def add_child(self, node: Union["TreeNode", Sequence["TreeNode"]]) -> "TreeNode":
        nodes = [node] if isinstance(node, TreeNode) else node
        for n in nodes:
            if n.parent is not None:
                raise ValueError("Node already has parent")
            self.children.append(n)
            n.parent = self
        return self

    add_children = add_child

    @property
    def ancestors(self) -> List:
        """This node and all its ancestors, root last."""
        chain = [self]
        cur = self
        while cur.parent is not None:
            chain.append(cur.parent)
            cur = cur.parent
        return chain

    @property
    def idx_as_child(self) -> int:
        assert self.parent
        return self.parent.children.index(self)

    @property
    def is_leaf(self) -> bool:
        return len(self.children) == 0


# counter for auto-generated dummy basis names
_DUMMY_IDX = [0]


class TreeNodeBasis(TreeNode):
    """Tree node holding one or several basis sets
    (reference ``tn/node.py:59-134``)."""

    def __init__(self, basis_sets: Union[BasisSet, List[BasisSet]] = None, bond_dim: int = None):
        super().__init__()
        if isinstance(basis_sets, BasisSet):
            basis_sets = [basis_sets]
        elif basis_sets is None or len(basis_sets) == 0:
            basis_sets = [BasisDummy(("Virtual DOF", _DUMMY_IDX[0]))]
            _DUMMY_IDX[0] += 1
        self.basis_sets: List[BasisSet] = basis_sets
        self.n_sets = len(basis_sets)
        qn_sizes = {b.sigmaqn.shape[1] for b in basis_sets}
        if len(qn_sizes) != 1:
            raise ValueError(f"Inconsistent quantum number size: {qn_sizes}")
        self.qn_size: int = qn_sizes.pop()
        self.dofs = [b.dofs for b in basis_sets]
        self.pbond_dims = [len(b.sigmaqn) for b in basis_sets]
        self.bond_dim = bond_dim

    def copy(self):
        clone = type(self)(self.basis_sets)
        clone.children = list(self.children)
        clone.parent = None if self.parent is None else self.parent.copy()
        return clone

    @property
    def basis_set(self):
        if self.n_sets != 1:
            raise ValueError(
                f"{self.n_sets} basis sets on this node; index basis_sets "
                "explicitly instead"
            )
        return self.basis_sets[0]

    def __str__(self):
        content = ", ".join(str(b) for b in self.basis_sets)
        return f"{self.__class__.__name__}({content})"

    __repr__ = __str__


class TreeNodeTensor(TreeNode):
    """Tree node holding the numeric TTN tensor
    (reference ``tn/node.py:136-195``).

    A host array becomes a tensor of the working precision (complex when the
    array is), as the JAX package uploads it; a torch tensor keeps its dtype
    and moves to the backend device, so that the VMF integration can hold
    its state in double precision whatever the working precision."""

    def __init__(self, tensor, qn=None):
        super().__init__()
        self.tensor = tensor
        self.qn = qn

    def check_canonical(self, atol=None, assertion=True) -> bool:
        tol = backend.canonical_atol if atol is None else atol
        flat = self.tensor.reshape(-1, self.shape[-1])
        gram = flat.conj().T @ flat
        eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
        ok = bool(torch.allclose(gram, eye, rtol=0, atol=tol))
        assert ok or not assertion
        return ok

    @property
    def tensor(self) -> torch.Tensor:
        return self._tensor

    @tensor.setter
    def tensor(self, value):
        if isinstance(value, torch.Tensor):
            self._tensor = value.to(backend.device)
            return
        value = np.asarray(value)
        dtype = backend.complex_dtype if np.iscomplexobj(value) else backend.real_dtype
        self._tensor = backend.tensor(value.astype(np_dtype(dtype), copy=False), dtype)

    array = tensor

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def qn(self):
        return self._qn

    @qn.setter
    def qn(self, qn):
        self._qn = np.array(qn) if qn is not None else None

    def __str__(self):
        return f"{self.__class__.__name__}({self.shape},{self.tensor.dtype})"

    __repr__ = __str__


class TreeNodeEnviron(TreeNode):
    """Tree node holding environment tensors."""

    def __init__(self):
        super().__init__()
        self.parent: "TreeNodeEnviron" = None
        self.environ_parent = None
        self.environ_children: List = []


class TreeNodeText(TreeNode):
    def __init__(self, text):
        super().__init__()
        self.text = str(text)


NodeUnion = Union[TreeNodeTensor, TreeNodeBasis, TreeNodeEnviron, TreeNodeText]


def copy_connection(source_node_list: List[NodeUnion], target_node_list: List[NodeUnion]) -> NodeUnion:
    """Replicate the connection structure of one node list onto another
    (reference ``tn/node.py:218-244``)."""
    pos: Dict[int, int] = {id(n): i for i, n in enumerate(source_node_list)}
    root = None
    for src, dst in zip(source_node_list, target_node_list):
        dst.add_children([target_node_list[pos[id(c)]] for c in src.children])
        if src.parent is None:
            root = dst
    assert root is not None
    return root


def build_connection_adj_mat(nodes: List[NodeUnion], adj_matrix: np.ndarray) -> NodeUnion:
    for node, row in zip(nodes, np.asarray(adj_matrix)):
        node.add_children([nodes[j] for j in np.flatnonzero(row)])
    roots = [n for n in nodes if n.parent is None]
    assert roots
    return roots[-1]
