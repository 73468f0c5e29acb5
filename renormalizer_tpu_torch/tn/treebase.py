"""Tree containers and basis-tree topology factories.

Port of ``renormalizer_tpu/tn/treebase.py`` (reference
``renormalizer/tn/treebase.py``): linear (== MPS), binary, MCTDH-style
(physical DoFs on leaves, dummy interior nodes) and T3NS topologies, plus the
P/Q thermofield doubling helper.  Host code only; the factories build their
nodes in the JAX package's order, so the two packages' trees match node by
node.
"""

from typing import Any, Dict, List, Sequence

import numpy as np

from renormalizer_tpu_torch.model import Op
from renormalizer_tpu_torch.model.basis import BasisDummy, BasisSet
from renormalizer_tpu_torch.tn.node import NodeUnion, TreeNodeBasis, copy_connection


class Tree:
    def __init__(self, root: NodeUnion):
        assert root.parent is None
        self.root = root
        self.node_list = self.preorder_list()
        self.node_idx: Dict[NodeUnion, int] = {n: i for i, n in enumerate(self.node_list)}

    def preorder_list(self, func=None) -> List[NodeUnion]:
        def recursion(node):
            ret = [node if func is None else func(node)]
            for child in node.children:
                ret += recursion(child)
            return ret

        return recursion(self.root)

    def postorder_list(self) -> List[NodeUnion]:
        out: List[NodeUnion] = []

        def visit(node):
            for child in node.children:
                visit(child)
            out.append(node)

        visit(self.root)
        return out

    @staticmethod
    def find_path(node1: NodeUnion, node2: NodeUnion) -> List[NodeUnion]:
        """Path between two nodes through their lowest common ancestor."""
        assert node1 != node2
        ancestors1 = node1.ancestors
        ancestors2 = node2.ancestors
        set2 = set(ancestors2)
        common = next(a for a in ancestors1 if a in set2)
        path1 = ancestors1[: ancestors1.index(common) + 1]
        path2 = ancestors2[: ancestors2.index(common)]
        return path1 + path2[::-1]

    @property
    def adj_matrix(self) -> np.ndarray:
        # parent -> child incidence, indexed by preorder position
        mat = np.zeros((self.size, self.size), dtype=np.uint8)
        for child in self.node_list:
            if child.parent is not None:
                mat[self.node_idx[child.parent], self.node_idx[child]] = 1
        return mat

    def __len__(self):
        return len(self.node_list)

    @property
    def size(self):
        return len(self)

    def __iter__(self):
        return iter(self.node_list)

    def __repr__(self):
        return f"{type(self).__name__}(nodes={len(self)})"


def approximate_partition(sequence, ngroups):
    size = (len(sequence) - 1) // ngroups + 1
    return [
        sequence[i * size: min((i + 1) * size, len(sequence))] for i in range(ngroups)
    ]


class BasisTree(Tree):
    """Tree of :class:`TreeNodeBasis` (reference ``treebase.py:85-423``)."""

    # --- topology factories -------------------------------------------------
    @classmethod
    def linear(cls, basis_list: List[BasisSet]) -> "BasisTree":
        """Linear chain, equivalent to an MPS."""
        nodes = [TreeNodeBasis([b]) for b in basis_list]
        for i in range(len(nodes) - 1):
            nodes[i].add_child(nodes[i + 1])
        return cls(nodes[0])

    @classmethod
    def binary(cls, basis_list: List[BasisSet]) -> "BasisTree":
        """Binary tree with physical DoFs on every node."""
        nodes = [TreeNodeBasis([b]) for b in basis_list]

        def recursion(node, offspring):
            if not offspring:
                return
            node.add_child(offspring[0])
            if len(offspring) == 1:
                return
            node.add_child(offspring[1])
            rest = offspring[2:]
            mid = len(rest) // 2
            recursion(offspring[0], rest[:mid])
            recursion(offspring[1], rest[mid:])

        recursion(nodes[0], nodes[1:])
        return cls(nodes[0])

    @classmethod
    def general_mctdh(cls, basis_list: List[BasisSet], tree_order: int,
                      contract_primitive: bool = False,
                      contract_label: Sequence[bool] = None,
                      dummy_label="MCTDH virtual") -> "BasisTree":
        """MCTDH-style tree: physical DoFs only on leaves, dummy interior
        nodes (reference ``treebase.py:142-246``)."""
        if len(basis_list) < 2:
            raise AssertionError("an MCTDH tree needs at least two bases")

        elementary: List[TreeNodeBasis] = []
        if not contract_primitive:
            assert contract_label is None, (
                "providing label makes sense only when primitives are contracted"
            )
            while tree_order < len(basis_list):
                elementary.append(TreeNodeBasis(basis_list[:tree_order]))
                basis_list = basis_list[tree_order:]
            elementary.append(TreeNodeBasis(basis_list))
        else:
            if contract_label is None:
                elementary = [TreeNodeBasis([b]) for b in basis_list]
            else:
                assert len(contract_label) == len(basis_list)
                i = 0
                while i != len(basis_list):
                    if contract_label[i]:
                        elementary.append(TreeNodeBasis([basis_list[i]]))
                        i += 1
                    else:
                        for j in range(1, tree_order + 1):
                            if i + j == len(contract_label) or contract_label[i + j]:
                                break
                        elementary.append(TreeNodeBasis(basis_list[i: i + j]))
                        i += j

        counter = [0]

        def recursion(nodes_: List[TreeNodeBasis]) -> TreeNodeBasis:
            node = TreeNodeBasis([BasisDummy((dummy_label, counter[0]))])
            counter[0] += 1
            if len(nodes_) <= tree_order:
                node.add_child(nodes_)
                return node
            for group in approximate_partition(nodes_, tree_order):
                node.add_child(recursion(group))
            return node

        return cls(recursion(elementary))

    @classmethod
    def binary_mctdh(cls, basis_list, contract_primitive=False, contract_label=None,
                     dummy_label="MCTDH virtual"):
        return cls.general_mctdh(basis_list, 2, contract_primitive, contract_label, dummy_label)

    @classmethod
    def ternary_mctdh(cls, basis_list, contract_primitive=False, contract_label=None,
                      dummy_label="MCTDH virtual"):
        return cls.general_mctdh(basis_list, 3, contract_primitive, contract_label, dummy_label)

    @classmethod
    def t3ns(cls, basis_list: List[BasisSet], t3ns_label="T3NS virtual") -> "BasisTree":
        """T3NS topology (reference ``treebase.py:279-306``)."""
        counter = [0]

        def fresh_dummy():
            node = TreeNodeBasis([BasisDummy((t3ns_label, counter[0]))])
            counter[0] += 1
            return node

        def recursion(parent, remaining):
            if not remaining:
                return
            head = TreeNodeBasis(remaining[:1])
            parent.add_child(head)
            rest = remaining[1:]
            if len(rest) == 1:
                head.add_child(TreeNodeBasis(rest))
            elif rest:
                hub = fresh_dummy()
                head.add_child(hub)
                for part in approximate_partition(rest, 2):
                    recursion(hub, part)

        root = fresh_dummy()
        for partition in approximate_partition(basis_list, 3):
            recursion(root, partition)
        return cls(root)

    # --- construction --------------------------------------------------------
    def __init__(self, root: TreeNodeBasis):
        super().__init__(root)
        for node in self.node_list:
            assert isinstance(node, TreeNodeBasis)
        qn_sizes = {n.qn_size for n in self.node_list}
        if len(qn_sizes) != 1:
            raise ValueError(f"Inconsistent quantum number size: {qn_sizes}")
        self.qn_size: int = qn_sizes.pop()

        placed = [(i, b) for i, node in enumerate(self.node_list)
                  for b in node.basis_sets]
        self.basis2idx: Dict[BasisSet, int] = {b: i for i, b in placed}
        self.dof2idx: Dict[Any, int] = {d: i for i, b in placed for d in b.dofs}
        self.dof2basis: Dict[Any, BasisSet] = {
            d: b for _, b in placed for d in b.dofs
        }

        self.identity_op: Op = Op("I", self.root.dofs[0][0])
        # cached identity / dummy TTNOs (built lazily by ``tn.tree``)
        self.identity_ttno = None
        self.dummy_ttno = None

    def print(self, print_function=print):
        """ASCII rendering of the tree."""
        def recursion(node, prefix, is_last):
            text = str([b.dofs for b in node.basis_sets])
            if node.bond_dim is not None:
                text += f" {node.bond_dim}"
            connector = "└── " if is_last else "├── "
            if node.parent is None:
                print_function(text)
                child_prefix = ""
            else:
                print_function(prefix + connector + text)
                child_prefix = prefix + ("    " if is_last else "│   ")
            for i, child in enumerate(node.children):
                recursion(child, child_prefix, i == len(node.children) - 1)

        recursion(self.root, "", True)

    @property
    def basis_list(self) -> List[BasisSet]:
        return [b for n in self.node_list for b in n.basis_sets]

    @property
    def dof_list(self) -> List[Any]:
        return [d for b in self.basis_list for d in b.dofs]

    @property
    def basis_list_postorder(self) -> List[BasisSet]:
        return [b for n in self.postorder_list() for b in n.basis_sets]

    @property
    def bond_dims(self) -> List[int]:
        dims = [n.bond_dim for n in self.node_list]
        if None in dims:
            raise ValueError(
                f"bond dimension unset on node {dims.index(None)}"
            )
        return dims

    @property
    def pbond_dims(self) -> List[List[int]]:
        return [n.pbond_dims for n in self.node_list]

    def add_auxiliary_space(self, auxiliary_label="Q") -> "BasisTree":
        """Thermofield P/Q doubling: each physical basis gains an auxiliary
        copy with zero quantum numbers (reference ``treebase.py:378-395``)."""
        def with_twin(basis):
            if isinstance(basis, BasisDummy):
                return [basis]
            twin = basis.copy((auxiliary_label, basis.dofs))
            twin.sigmaqn = np.zeros_like(basis.sigmaqn)
            return [basis, twin]

        doubled = [
            TreeNodeBasis([b2 for b in node.basis_sets for b2 in with_twin(b)])
            for node in self.node_list
        ]
        return BasisTree(copy_connection(self.node_list, doubled))


def print_as_tree(text_list, adj_matrix, print_function=print):
    """ASCII rendering of an arbitrary tree given node texts and an adjacency
    matrix (reference ``treebase.py:408-420``)."""
    adj = np.asarray(adj_matrix)
    n = len(text_list)
    children = {i: [] for i in range(n)}
    indeg = [0] * n
    for i in range(n):
        for j in range(n):
            if adj[i][j]:
                children[i].append(j)
                indeg[j] += 1
    roots = [i for i in range(n) if indeg[i] == 0]
    assert len(roots) == 1, "adjacency matrix must define a single-rooted tree"

    def recursion(idx, prefix, is_last):
        connector = "└── " if is_last else "├── "
        if prefix == "" and is_last and idx == roots[0]:
            print_function(str(text_list[idx]))
            child_prefix = ""
        else:
            print_function(prefix + connector + str(text_list[idx]))
            child_prefix = prefix + ("    " if is_last else "│   ")
        for k, c in enumerate(children[idx]):
            recursion(c, child_prefix, k == len(children[idx]) - 1)

    recursion(roots[0], "", True)
