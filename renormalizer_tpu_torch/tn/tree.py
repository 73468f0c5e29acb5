r"""Tree tensor network states (TTNS), operators (TTNO) and environments.

Port of ``renormalizer_tpu/tn/tree.py`` (reference
``renormalizer/tn/tree.py:24-1809``).  Node tensors are torch tensors on the
backend device with index layout ``[children..., physical..., parent]``;
every contraction goes through the label-based pairwise einsum
(``ops.contract.einsum_interleaved``).  The factorizations take the port's
MPS routes, whatever the device:

* ``update_2site`` (tree DMRG, TDVP-PS2): randomized sector-pure candidates
  (``trunc_device.candidates``, real Grams on the Jacobi kernel) and the
  host selection, as ``Mps._update_mps_device``; threshold criteria take
  full-rank candidates.  The JAX package's asynchronous plan reuse is not
  carried.
* the state-averaged update: ``svd_qn.eigh_qn`` (real blocks on the kernel);
* ``compress_node``: ``trunc_device.compress_factors(resolve=True)``, one
  SVD per sector block in double precision, as ``Mps.compress``;
* ``decompose_to_parent``/``decompose_to_child``: ``trunc_device.qr_qn_device``.

``TTNS.random`` builds its tensors on the host with numpy and the backend
seed, so the two packages start from the same state.
"""

import logging
from functools import reduce
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import scipy.stats
import torch

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.model import Model, Op, OpSum
from renormalizer_tpu_torch.model.basis import BasisDummy, BasisSet
from renormalizer_tpu_torch.mps import trunc_device
from renormalizer_tpu_torch.mps.lib import select_basis, select_indices
from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.mps.mps import Mps, normalize
from renormalizer_tpu_torch.mps.svd_qn import add_outer, eigh_qn, get_qn_mask
from renormalizer_tpu_torch.ops.contract import einsum_interleaved
from renormalizer_tpu_torch.tn.node import (
    TreeNodeBasis,
    TreeNodeEnviron,
    TreeNodeTensor,
    copy_connection,
)
from renormalizer_tpu_torch.tn.symbolic_ttno import (
    construct_symbolic_ttno,
    symbolic_mo_to_numeric_mo_general,
)
from renormalizer_tpu_torch.tn.treebase import BasisTree, Tree
from renormalizer_tpu_torch.utils import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    OptimizeConfig,
    calc_vn_entropy,
    calc_vn_entropy_dm,
)
from renormalizer_tpu_torch.utils.profiling import COUNTERS, span

logger = logging.getLogger(__name__)


class TTNBase(Tree):
    """Shared base of TTNS and TTNO (reference ``tn/tree.py:24-113``)."""

    @classmethod
    def load(cls, basis: BasisTree, fname: str, other_attrs=()):
        payload = np.load(fname, allow_pickle=True)
        assert payload["version"] == "0.1"
        nodes = [
            TreeNodeTensor(payload[f"tensor_{i}"], payload[f"qn_{i}"])
            for i in range(int(payload["nsites"]))
        ]
        instance = cls(basis, root=copy_connection(basis.node_list, nodes))
        for attr in other_attrs:
            setattr(instance, attr, payload[attr])
        return instance

    def __init__(self, basis: BasisTree, root: TreeNodeTensor):
        self.basis = basis
        super().__init__(root)
        self.tn2bn: Dict[TreeNodeTensor, TreeNodeBasis] = dict(
            zip(self.node_list, basis.node_list)
        )
        self.tn2dofs = {tn: bn.dofs for tn, bn in self.tn2bn.items()}

    def dump(self, fname: str, other_attrs=()):
        """The same ``.npz`` keys as the JAX package, so that files cross
        between the two packages."""
        payload = {"version": "0.1", "nsites": len(self)}
        payload.update({attr: getattr(self, attr) for attr in other_attrs})
        for i, node in enumerate(self.node_list):
            payload[f"tensor_{i}"] = to_numpy(node.tensor)
            payload[f"qn_{i}"] = node.qn
        try:
            np.savez(fname, **payload)
        except Exception:
            logger.exception("Dump TTN failed.")

    def print_shape(self, full: bool = False, print_function=print):
        for node in self.node_list:
            print_function(str(node.shape if full else node.shape[-1]))

    @property
    def qntot(self) -> np.ndarray:
        return np.asarray(self.root.qn[0])

    @property
    def bond_dims(self):
        return [int(node.shape[-1]) for node in self.node_list]

    @property
    def bond_dims_mean(self) -> int:
        dims = self.bond_dims
        return int(round(sum(dims) / len(dims)))

    @property
    def pbond_dims(self) -> List[List[int]]:
        return list(self.basis.pbond_dims)


class TTNO(TTNBase):
    """Tree tensor network operator (reference ``tn/tree.py:116-313``)."""

    @classmethod
    def identity(cls, basis: BasisTree):
        cached = basis.identity_ttno
        if cached is None:
            cached = basis.identity_ttno = cls(basis, [basis.identity_op])
        return cached

    @classmethod
    def dummy(cls, basis: BasisTree):
        """Same topology, dummy physical bonds; used for norms/RDMs."""
        cached = basis.dummy_ttno
        if cached is None:
            dummy_nodes = [
                TreeNodeBasis([BasisDummy((id(node), "dummy"))])
                for node in basis.node_list
            ]
            copy_connection(basis.node_list, dummy_nodes)
            shell = BasisTree(dummy_nodes[0])
            cached = basis.dummy_ttno = cls(shell, [shell.identity_op])
        return cached

    def __init__(self, basis: BasisTree, terms: Union[List[Op], Op] = None,
                 root: TreeNodeTensor = None, algo: str = "Hopcroft-Karp"):
        """``terms`` may be left out when ``root`` is given (``load``)."""
        self.basis = basis
        if terms is None:
            terms = []
        elif isinstance(terms, Op):
            terms = [terms]
        self.terms: List[Op] = terms

        if not root:
            self.symbolic_ttno, mpoqn = construct_symbolic_ttno(basis, terms, algo=algo)
            node_list_basis = basis.postorder_list()
            node_list_op = []
            for mo, qn, node_basis in zip(self.symbolic_ttno, mpoqn, node_list_basis):
                mo_mat = symbolic_mo_to_numeric_mo_general(
                    node_basis.basis_sets, mo, np_dtype(backend.real_dtype)
                )
                node_list_op.append(TreeNodeTensor(mo_mat, qn))
            root = copy_connection(node_list_basis, node_list_op)
        super().__init__(basis, root)

    def get_node_indices(self, node: TreeNodeTensor, prefix_up="up", prefix_down="down") -> List:
        """einsum labels for this node: children bonds, interleaved up/down
        physical pairs, parent bond (reference ``tree.py:278-309``)."""
        tag = str(id(self))
        here = str(self.tn2dofs[node])
        labels: List = [
            (tag, here, str(self.tn2dofs[c])) for c in node.children
        ]
        for dofs in self.tn2dofs[node]:
            labels += [(prefix_up, str(dofs)), (prefix_down, str(dofs))]
        up = "root" if node.parent is None else str(self.tn2dofs[node.parent])
        labels.append((tag, up, here))
        assert len(labels) == node.tensor.ndim
        return labels

    def apply(self, ttns: "TTNS", canonicalise: bool = False) -> "TTNS":
        """Exact TTNO @ TTNS with qn outer sums
        (reference ``tree.py:154-200``)."""
        out = ttns.metacopy()
        for snode, merged_node, onode in zip(ttns, out, self):
            assert len(snode.children) == len(onode.children)
            nchild = len(snode.children)
            s_idx = ttns.get_node_indices(snode, ttno=self)
            o_idx = self.get_node_indices(onode)
            # merged bond pairs (state x operator) for children and parent,
            # untouched "up" physical legs in between
            out_idx: List = []
            out_shape: List[int] = []
            for i in range(nchild):
                out_idx += [s_idx[i], o_idx[i]]
                out_shape.append(snode.shape[i] * onode.shape[i])
            bnode = ttns.tn2bn[snode]
            for i, dofs in enumerate(bnode.dofs):
                out_idx.append(("up", str(dofs)))
                out_shape.append(snode.shape[nchild + i])
            out_idx += [s_idx[-1], o_idx[-1]]
            out_shape.append(snode.shape[-1] * onode.shape[-1])
            merged = einsum_interleaved(
                snode.tensor, s_idx, onode.tensor, o_idx, out_idx
            )
            merged_node.tensor = merged.reshape(out_shape)
            merged_node.qn = add_outer(snode.qn, onode.qn).reshape(
                -1, ttns.basis.qn_size
            )
        out.check_shape()
        if canonicalise:
            out.canonicalise()
        return out

    def contract(self, ttns: "TTNS", algo="svd") -> "TTNS":
        assert algo == "svd", "variational compress not supported yet"
        new_ttns = self.apply(ttns)
        new_ttns.canonicalise()
        new_ttns.compress()
        return new_ttns

    def to_contract_args(self, prefix_up, prefix_down) -> List:
        args = []
        for node in self.node_list:
            indices = self.get_node_indices(node, prefix_up, prefix_down)
            indices = [indices[i] for i, s in enumerate(node.shape) if s != 1]
            tensor = node.tensor.squeeze()
            assert len(indices) == tensor.ndim
            args.extend([tensor, indices])
        return args

    def todense(self, order: List[BasisSet] = None) -> np.ndarray:
        args = self.to_contract_args("up", "down")
        if order is None:
            order = self.basis.basis_list
        indices_up, indices_down = [], []
        for basis in order:
            if isinstance(basis, BasisDummy):
                continue
            indices_up.append(("up", str(basis.dofs)))
            indices_down.append(("down", str(basis.dofs)))
        args.append(indices_up + indices_down)
        res = to_numpy(einsum_interleaved(*args))
        dim = round(np.sqrt(np.prod(res.shape)))
        return res.reshape(dim, dim)

    def __matmul__(self, other):
        return self.apply(other)


# populated by time_evolution.py
EVOLVE_METHODS = {}


class TTNS(TTNBase):
    """Tree tensor network state (reference ``tn/tree.py:320-1574``)."""

    @classmethod
    def load(cls, basis: BasisTree, fname: str, other_attrs=None):
        if other_attrs is None:
            other_attrs = []
        return super().load(basis, fname, other_attrs + ["coeff"])

    @classmethod
    def random(cls, basis: BasisTree, qntot, m_max, percent=1.0) -> "TTNS":
        """Random TTNS with conserved quantum number, built postorder on the
        host with numpy from the backend seed, then uploaded (reference
        ``tree.py:329-394``): the JAX package's draws, tensor for tensor."""
        ttns = cls(basis)
        if isinstance(qntot, int):
            qntot = np.array([qntot])
        qn_size = len(qntot)
        assert basis.qn_size == qn_size
        rng = np.random.default_rng(backend.seed)

        for node in ttns.postorder_list()[:-1]:
            qnbigl, _, _ = ttns.get_qnmat(node, include_parent=False)
            qnbigl_shape = qnbigl.shape
            qnbigl = qnbigl.reshape(-1, qn_size)
            u_list, s_list, qn_list = [], [], []
            for sector in set(tuple(t) for t in qnbigl):
                if np.all(np.array(qntot) < np.array(sector)):
                    continue
                indices = [i for i, x in enumerate(qnbigl) if tuple(x) == sector]
                if len(indices) == 1:
                    u = np.array([[1.0]])
                else:
                    u = scipy.stats.ortho_group.rvs(len(indices), random_state=rng)
                full = np.zeros((len(qnbigl), len(indices)))
                full[indices, :] = u
                u_list.append(full)
                s_list.append(rng.random(len(indices)))
                qn_list += [sector] * len(indices)
            u = np.concatenate(u_list, axis=1)
            s = np.concatenate(s_list)
            if isinstance(m_max, (list, tuple, np.ndarray)):
                m_max2 = m_max[ttns.node_idx[node]]
            else:
                m_max2 = m_max
            mt, mpsdim, mpsqn, _ = select_basis(u, s, qn_list, u, m_max2, percent=percent)
            node.tensor = np.asarray(mt).reshape(list(qnbigl_shape)[:-1] + [mpsdim])
            node.qn = mpsqn
        # root: random, qn-masked, normalized
        ttns.root.qn = np.ones((1, qn_size), dtype=int) * qntot
        qn_mask = ttns.get_qnmask(ttns.root, include_parent=False)
        tensor = rng.random(qn_mask.shape) - 0.5
        tensor[~qn_mask] = 0
        tensor /= np.linalg.norm(tensor.ravel())
        ttns.root.tensor = tensor
        ttns.check_shape()
        ttns.check_canonical()
        return ttns

    @classmethod
    def from_tensors(cls, template: "TTNS", tensors, masks=None) -> "TTNS":
        """Fill a TTNS from a flat masked coefficient vector (reference
        ``tree.py:397-424``): a tensor keeps its dtype, a host array takes
        the working precision.  VMF evolution passes each node's qn mask as
        ``masks``."""
        ttns = template.metacopy()
        if isinstance(tensors, torch.Tensor):
            flat = tensors
        else:
            flat = np.asarray(tensors)
            flat = backend.tensor(flat, backend.complex_dtype if np.iscomplexobj(flat)
                                  else backend.real_dtype)
        if masks is None:
            masks = [template.get_qnmask(tnode) for tnode in template.node_list]
        cursor = 0
        for node, tnode, mask in zip(ttns.node_list, template.node_list, masks):
            mask = torch.as_tensor(mask, device=flat.device)
            nkeep = int(mask.sum())
            block = torch.zeros(mask.shape, dtype=flat.dtype, device=flat.device)
            block[mask] = flat[cursor:cursor + nkeep]
            node.tensor = block
            node.qn = np.array(tnode.qn)
            cursor += nkeep
        if cursor != flat.numel():
            raise ValueError(f"coefficient vector length {flat.numel()} != masked size {cursor}")
        ttns.check_shape()
        return ttns

    def __init__(self, basis: BasisTree, condition: Dict = None, root: TreeNodeTensor = None):
        """With ``condition``, construct a bond-1 Hartree product TTNS;
        with ``root``, adopt an existing tensor tree."""
        self.basis = basis
        if not root:
            if condition is None:
                condition = {}
            basis_list = basis.basis_list_postorder
            mps = Mps.hartree_product_state(Model(basis_list, []), condition, qn_idx=len(basis_list))
            site_qn = [b - a for a, b in zip(mps.qn, mps.qn[1:])]
            state_nodes = []
            for node_basis in basis.node_list:
                picked = [basis_list.index(b) for b in node_basis.basis_sets]
                assert picked
                tensor = reduce(
                    lambda t, i: np.tensordot(t, to_numpy(mps[i]), axes=1),
                    picked, np.eye(1),
                )
                shape = [1] * len(node_basis.children)
                shape += list(tensor.shape)[1:-1] + [1]
                state_nodes.append(TreeNodeTensor(
                    tensor.reshape(shape), sum(site_qn[i] for i in picked)
                ))
            super().__init__(
                basis, copy_connection(basis.node_list, state_nodes)
            )
            # accumulate subtree quantum numbers bottom-up
            for node in self.postorder_list():
                for child in node.children:
                    node.qn = node.qn + child.qn
        else:
            assert condition is None
            super().__init__(basis, root)

        self.coeff = 1
        self.compress_config = CompressConfig()
        self.optimize_config = OptimizeConfig()
        self.evolve_config = EvolveConfig(EvolveMethod.tdvp_vmf, force_ovlp=False)
        self.check_shape()

    # --- sanity -----------------------------------------------------------
    def check_shape(self):
        for snode, bnode in zip(self.node_list, self.basis.node_list):
            nchild = len(snode.children)
            assert snode.tensor.ndim == nchild + bnode.n_sets + 1
            nqn, qn_width = snode.qn.shape
            assert (nqn, qn_width) == (snode.shape[-1], bnode.qn_size)
            physical = snode.shape[nchild:nchild + bnode.n_sets]
            assert list(physical) == [b.nbas for b in bnode.basis_sets]

    def check_canonical(self, atol=None) -> bool:
        for node in self.node_list:
            if node is not self.root:
                node.check_canonical(atol)
        return True

    def is_canonical(self, atol=None) -> bool:
        return all(
            node.check_canonical(atol, assertion=False)
            for node in self.node_list if node is not self.root
        )

    # --- indices ----------------------------------------------------------
    def get_node_indices(self, node: TreeNodeTensor, conj=False,
                         include_parent=False, ttno: TTNO = None) -> List[Tuple]:
        """einsum labels of this node (reference ``tree.py:538-594``)."""
        if include_parent:
            snode_indices = self.get_node_indices(node, conj, ttno=ttno)
            parent_indices = self.get_node_indices(node.parent, conj, ttno=ttno)
            indices = snode_indices + parent_indices
            shared = snode_indices[-1]
            for _ in range(2):
                indices.remove(shared)
            return indices

        _id = str(id(self)) + ("_conj" if conj else "")
        skip_pidx = get_skip_pidx(node, self, ttno)
        all_dofs = self.tn2dofs[node]
        indices = []
        for child in node.children:
            indices.append((_id, str(all_dofs), str(self.tn2dofs[child])))
        for i, dofs in enumerate(all_dofs):
            ud = "down" if (not conj and i not in skip_pidx) else "up"
            indices.append((ud, str(dofs)))
        if node.parent is None:
            indices.append((_id, "root", str(all_dofs)))
        else:
            indices.append((_id, str(self.tn2dofs[node.parent]), str(all_dofs)))
        assert len(indices) == node.tensor.ndim
        return indices

    def to_contract_args(self, conj: bool = False):
        args = []
        for node in self.node_list:
            indices = self.get_node_indices(node, conj)
            tensor = node.tensor.conj() if conj else node.tensor
            indices = [indices[i] for i, s in enumerate(tensor.shape) if s != 1]
            tensor = tensor.squeeze()
            assert len(indices) == tensor.ndim
            args.extend([tensor, indices])
        return args

    # --- canonicalization / compression -----------------------------------
    def merge_with_parent(self, node):
        args = [
            node.tensor, self.get_node_indices(node),
            node.parent.tensor, self.get_node_indices(node.parent),
            self.get_node_indices(node, include_parent=True),
        ]
        return einsum_interleaved(*args)

    def decompose_to_parent(self, node: TreeNodeTensor) -> torch.Tensor:
        """qn-blocked QR toward the parent on the device; node becomes Q,
        returns R (reference ``tree.py:607-628``)."""
        assert node.parent
        qnbigl, qnbigr, _ = self.get_qnmat(node, include_parent=False)
        tensor = node.tensor.reshape(-1, node.shape[-1])
        u, qnlnew, v, qnrnew = trunc_device.qr_qn_device(
            tensor, qnbigl, qnbigr, self.qntot, "L"
        )
        node.tensor = u.reshape(list(node.shape[:-1]) + [u.shape[1]])
        node.qn = np.array(qnlnew)
        return v

    def merge_to_parent(self, node: TreeNodeTensor, v):
        """Absorb the R factor into the parent (reference ``tree.py:630-650``)."""
        parent_indices = self.get_node_indices(node.parent)
        args = [node.parent.tensor, parent_indices]
        child_idx1 = parent_indices[node.idx_as_child]
        child_idx2 = tuple(list(child_idx1) + ["_idx2"])
        args.extend([v, (child_idx1, child_idx2)])
        output_indices = parent_indices.copy()
        output_indices[node.idx_as_child] = child_idx2
        args.append(output_indices)
        node.parent.tensor = einsum_interleaved(*args)

    def push_cano_to_parent(self, node: TreeNodeTensor):
        v = self.decompose_to_parent(node)
        self.merge_to_parent(node, v)

    def decompose_to_child(self, node: TreeNodeTensor, ichild: int):
        """qn-blocked QR toward a child on the device
        (reference ``tree.py:666-703``)."""
        qnbigl, qnbigr, tensor, shape = moveaxis(self, node, ichild)
        u, qnl, v, qnr = trunc_device.qr_qn_device(
            tensor, qnbigl, qnbigr, self.qntot, "L"
        )
        shape[-1] = u.shape[-1]
        node.tensor = torch.movedim(u.reshape(shape), -1, ichild)
        node.children[ichild].qn = np.array(qnr)
        return v

    def merge_to_child(self, node: TreeNodeTensor, ichild: int, v):
        child = node.children[ichild]
        child.tensor = torch.tensordot(child.tensor, v.to(child.tensor.dtype), dims=([-1], [0]))

    def push_cano_to_child(self, node: TreeNodeTensor, ichild: int):
        v = self.decompose_to_child(node, ichild)
        self.merge_to_child(node, ichild, v)

    def compress_node(self, node: TreeNodeTensor, ichild: int,
                      temp_m_trunc=None, cano_child: bool = True):
        """SVD-compress the bond to one child (reference ``tree.py:735-787``):
        one SVD per sector block in double precision
        (``compress_factors(resolve=True)``, as ``Mps.compress``).  Returns
        the untruncated singular values."""
        qnbigl, qnbigr, tensor, shape = moveaxis(self, node, ichild)
        u, s, qnl, v, _, qnr = trunc_device.compress_factors(
            tensor, qnbigl, qnbigr, self.qntot, "L", resolve=True
        )
        idx = self.node_idx[node.children[ichild]]
        if temp_m_trunc is None:
            m_trunc = self.compress_config.compute_m_trunc(s, idx, left=False)
        elif np.ndim(temp_m_trunc) == 0:
            m_trunc = int(min(temp_m_trunc, len(s)))
        else:
            m_trunc = int(min(temp_m_trunc[idx], len(s)))
        orig_s = np.array(s)
        u, v = u[:, :m_trunc], v[:, :m_trunc]
        qnr = qnr[:m_trunc]
        sv = backend.tensor(np.asarray(s[:m_trunc]), dtype=u.real.dtype)
        # fold sigma into whichever side stays non-canonical
        if cano_child:
            v = v * sv[None, :].to(v.dtype)
        else:
            u = u * sv[None, :].to(u.dtype)
        shape[-1] = u.shape[-1]
        node.tensor = torch.movedim(u.reshape(shape), -1, ichild)
        child = node.children[ichild]
        child.tensor = torch.tensordot(child.tensor, v, dims=([-1], [0]))
        child.qn = np.array(qnr)
        return orig_s

    def _qn_outer_sum(self, vectors) -> np.ndarray:
        """Outer-sum accumulation of per-leg quantum-number arrays."""
        return reduce(add_outer, vectors,
                      np.zeros(self.basis.qn_size, dtype=int))

    def get_qnmat(self, node: TreeNodeTensor, include_parent: bool = False):
        """Super-block quantum numbers (reference ``tree.py:789-811``):
        ``qnbigl`` accumulates the node's own legs (children bonds then
        physical bases), ``qnbigr`` the complement through the parent."""
        bnode = self.tn2bn[node]
        qnbigl = self._qn_outer_sum(
            [c.qn for c in node.children]
            + [b.sigmaqn for b in bnode.basis_sets]
        )
        if include_parent:
            parent = node.parent
            assert parent is not None
            up_legs = [c.qn for c in parent.children if c is not node]
            up_legs += [b.sigmaqn for b in self.tn2bn[parent].basis_sets]
            up_legs.append(self.qntot - parent.qn)
            qnbigr = self._qn_outer_sum(up_legs)
        else:
            qnbigr = self.qntot - node.qn
        return qnbigl, qnbigr, add_outer(qnbigl, qnbigr)

    def get_qnmask(self, node, include_parent=False):
        return get_qn_mask(
            self.get_qnmat(node, include_parent)[-1], self.qntot
        )

    def canonicalise(self):
        for node in self.postorder_list():
            if node is not self.root:
                self.push_cano_to_parent(node)
        return self

    def compress(self, temp_m_trunc=None, ret_s=False):
        """Recursive SVD compression from the root (reference
        ``tree.py:822-851``)."""
        if self.compress_config.bonddim_should_set:
            self.compress_config.set_bonddim(len(self.node_list) + 1)
        s_dict: Dict[TreeNodeTensor, np.ndarray] = {self.root: np.array([1.0])}
        compress_recursion(self.root, self, s_dict, temp_m_trunc)
        self.check_shape()
        self.check_canonical()
        if not ret_s:
            return self
        s_list = [s_dict[n] for n in self.node_list]
        max_len = max(len(s) for s in s_list)
        s_array = np.array([np.pad(s, (0, max_len - len(s))) for s in s_list])
        return self, s_array

    # --- measurement --------------------------------------------------------
    def expectation(self, ttno: Union[TTNO, Op, OpSum], bra: "TTNS" = None):
        """<psi|O|psi> via a dummy extended root and one postorder environment
        sweep (reference ``tree.py:870-940``)."""
        if isinstance(ttno, (Op, OpSum)):
            ttno = TTNO(self.basis, ttno)
        assert bra is None  # not implemented yet

        def extend_basis(net_root_basis):
            top = TreeNodeBasis([BasisDummy("expectation dummy")])
            top.add_child(net_root_basis.copy())
            return BasisTree(top)

        def lifted_root(net_root, ndim, qn_size):
            top = TreeNodeTensor(
                np.ones([1] * ndim), qn=np.zeros((1, qn_size))
            )
            top.add_child(net_root)
            return top

        s_basis = extend_basis(self.basis.root)
        o_basis = extend_basis(ttno.basis.root)
        ttns_ext = TTNS(
            s_basis, root=lifted_root(self.root, 3, s_basis.qn_size))
        ttno_ext = TTNO(
            o_basis, [], root=lifted_root(ttno.root, 4, o_basis.qn_size))
        environ = TTNEnviron(ttns_ext, ttno_ext, build_environ=False)
        environ.build_children_environ(ttns_ext, ttno_ext)
        val = complex(environ.root.environ_children[0].reshape(-1)[0].item())
        for node in (self.basis.root, self.root, ttno.root):
            node.parent = None
        if np.isclose(val.imag, 0):
            return val.real
        return val

    def calc_1site_rdm(self, idx: Union[int, List] = None) -> Dict[int, np.ndarray]:
        """1-site RDMs keyed by node index (reference ``tree.py:942-1009``)."""
        ttno_dummy = TTNO.dummy(self.basis)
        ttne = TTNEnviron(self, ttno_dummy)
        if idx is None:
            idx = list(range(len(self)))
        elif isinstance(idx, int):
            idx = [idx]
        rdm = {}
        for node_i in idx:
            enode = ttne.node_list[node_i]
            snode = self.node_list[node_i]
            args = []
            for i, child_tensor in enumerate(enode.environ_children):
                args.extend([child_tensor, ttne.get_child_indices(enode, i, self, ttno_dummy)])
            args.append(snode.tensor.conj())
            args.append(self.get_node_indices(snode, conj=True))
            args.append(snode.tensor)
            args.append(self.get_node_indices(snode))
            args.append(enode.environ_parent)
            args.append(ttne.get_parent_indices(enode, self, ttno_dummy))
            indices_ket, indices_bra = [], []
            for dofs in self.tn2dofs[snode]:
                indices_ket.append(("down", str(dofs)))
                indices_bra.append(("up", str(dofs)))
            args.append(indices_ket + indices_bra)
            rdm[node_i] = to_numpy(einsum_interleaved(*args))
        return rdm

    def calc_1site_entropy(self, idx=None) -> Dict[int, float]:
        return {k: calc_vn_entropy_dm(dm) for k, dm in self.calc_1site_rdm(idx).items()}

    def calc_1dof_rdm(self, dof=None) -> Dict[Any, np.ndarray]:
        """Reduced density matrix per DoF (reference ``tree.py:1030-1069``)."""
        if dof is None:
            dof_list = self.basis.dof_list
        elif isinstance(dof, list):
            dof_list = dof
        else:
            dof_list = [dof]
        site_idx_list = [self.basis.dof2idx[d] for d in dof_list]
        rdm_site = self.calc_1site_rdm(site_idx_list)
        rdm_dof = {}
        for d in dof_list:
            rdm = rdm_site[self.basis.dof2idx[d]]
            bnode: TreeNodeBasis = self.basis.node_list[self.basis.dof2idx[d]]
            assert list(rdm.shape) == bnode.pbond_dims + bnode.pbond_dims
            basis_idx = bnode.basis_sets.index(self.basis.dof2basis[d])
            indices = [(0, i) for i in range(bnode.n_sets)] * 2
            indices[basis_idx] = (1, 0)
            indices[basis_idx + bnode.n_sets] = (1, 1)
            rdm_dof[d] = to_numpy(einsum_interleaved(
                torch.as_tensor(rdm), indices, [(1, 0), (1, 1)]))
        return rdm_dof

    def calc_1dof_entropy(self, dof=None) -> Dict[Any, float]:
        return {k: calc_vn_entropy_dm(dm) for k, dm in self.calc_1dof_rdm(dof).items()}

    def calc_2site_rdm(self, idxs) -> Dict[Tuple[int, int], np.ndarray]:
        """2-site RDMs along tree paths (reference ``tree.py:1075-1169``)."""
        ttno_dummy = TTNO.dummy(self.basis)
        ttne = TTNEnviron(self, ttno_dummy)
        if isinstance(idxs, tuple):
            idxs = [idxs]
        rdm = {}
        for idx1, idx2 in idxs:
            path = self.find_path(self.node_list[idx1], self.node_list[idx2])
            assert path[0] is self.node_list[idx1]
            assert path[-1] is self.node_list[idx2]

            def braket_args(snode, ket_ttno=None):
                return [
                    snode.tensor.conj(),
                    self.get_node_indices(snode, conj=True),
                    snode.tensor,
                    self.get_node_indices(snode, ttno=ket_ttno),
                ]

            # endpoints keep open physical legs; interior path nodes trace
            # theirs through the dummy TTNO
            args = braket_args(path[0]) + braket_args(path[-1])
            for snode in path[1:-1]:
                args += braket_args(snode, ttno_dummy)
            for i, node in enumerate(path):
                neighbours = [
                    nb for nb in (path[i - 1] if i else None,
                                  path[i + 1] if i + 1 < len(path) else None)
                    if nb is not None
                ]
                skip_child_idx = [
                    nb.idx_as_child for nb in neighbours if nb.parent is node
                ]
                skip_parent = any(node.parent is nb for nb in neighbours)
                enode = ttne.node_list[self.node_idx[node]]
                for j, child_tensor in enumerate(enode.environ_children):
                    if j in skip_child_idx:
                        continue
                    args.extend([child_tensor, ttne.get_child_indices(enode, j, self, ttno_dummy)])
                if not skip_parent:
                    args.append(enode.environ_parent)
                    args.append(ttne.get_parent_indices(enode, self, ttno_dummy))
            indices_ket, indices_bra = [], []
            for snode in (path[0], path[-1]):
                for dofs in self.tn2dofs[snode]:
                    indices_ket.append(("down", str(dofs)))
                    indices_bra.append(("up", str(dofs)))
            args.append(indices_ket + indices_bra)
            rdm[(idx1, idx2)] = to_numpy(einsum_interleaved(*args))
        return rdm

    def calc_2site_entropy(self, idxs) -> Dict[tuple, float]:
        if isinstance(idxs, tuple):
            idxs = [idxs]
        return {k: calc_vn_entropy_dm(dm) for k, dm in self.calc_2site_rdm(idxs).items()}

    def calc_2dof_rdm(self, dofs) -> Dict[Tuple[Any, Any], np.ndarray]:
        """RDM of two DoFs, same or different sites
        (reference ``tree.py:1182-1238``)."""
        if isinstance(dofs, tuple):
            dofs = [dofs]
        rdm_ = {}
        one_site_idx, two_site_idx = [], []
        for dof1, dof2 in dofs:
            i1, i2 = self.basis.dof2idx[dof1], self.basis.dof2idx[dof2]
            if i1 == i2:
                one_site_idx += [i1, i2]
            else:
                two_site_idx.append((i1, i2))
        rdm_1sites = self.calc_1site_rdm(one_site_idx) if one_site_idx else None
        rdm_2sites = self.calc_2site_rdm(two_site_idx) if two_site_idx else None
        for dof_pair in dofs:
            dof1, dof2 = dof_pair
            i1, i2 = self.basis.dof2idx[dof1], self.basis.dof2idx[dof2]
            if i1 == i2:
                rdm = rdm_1sites[i1]
                bnode = self.basis.node_list[i1]
                n_sets = bnode.n_sets
                b1 = bnode.basis_sets.index(self.basis.dof2basis[dof1])
                b2 = bnode.basis_sets.index(self.basis.dof2basis[dof2])
                assert b1 != b2
            else:
                rdm = rdm_2sites[(i1, i2)]
                bn1 = self.basis.node_list[i1]
                bn2 = self.basis.node_list[i2]
                n_sets = bn1.n_sets + bn2.n_sets
                b1 = bn1.basis_sets.index(self.basis.dof2basis[dof1])
                b2 = bn1.n_sets + bn2.basis_sets.index(self.basis.dof2basis[dof2])
            indices = [(0, i) for i in range(n_sets)] * 2
            indices[b1] = (1, 0)
            indices[b2] = (1, 1)
            indices[n_sets + b1] = (1, 2)
            indices[n_sets + b2] = (1, 3)
            rdm_[dof_pair] = to_numpy(einsum_interleaved(
                torch.as_tensor(rdm), indices, [(1, i) for i in range(4)]))
        return rdm_

    def calc_2dof_entropy(self, dofs, rdm=None) -> Dict[Tuple[Any, Any], float]:
        if rdm is None:
            rdm = self.calc_2dof_rdm(dofs)
        return {k: calc_vn_entropy_dm(dm) for k, dm in rdm.items()}

    def calc_2dof_mutual_info(self, dofs, rdm_2dof=None):
        """m_ij = (s_i + s_j - s_ij)/2 (reference ``tree.py:1247-1280``)."""
        if isinstance(dofs, tuple):
            dofs = [dofs]
        dofs_flat = [d for pair in dofs for d in pair]
        entropy_1dof = self.calc_1dof_entropy(dofs_flat)
        entropy_2dof = self.calc_2dof_entropy(dofs, rdm_2dof)
        mutual = {
            pair: (entropy_1dof[pair[0]] + entropy_1dof[pair[1]] - entropy_2dof[pair]) / 2
            for pair in dofs
        }
        return mutual, (entropy_1dof, entropy_2dof)

    def calc_bond_singular_values(self) -> np.ndarray:
        ttns = self.copy()
        ttns.canonicalise()
        _, s_array = ttns.compress(temp_m_trunc=np.inf, ret_s=True)
        return s_array

    def calc_bond_entropy(self, s_array=None) -> np.ndarray:
        if s_array is None:
            s_array = self.calc_bond_singular_values()
        return np.array([calc_vn_entropy(s ** 2) for s in s_array])

    # --- manipulation ------------------------------------------------------
    def add(self, other: "TTNS") -> "TTNS":
        """Block-diagonal direct sum (reference ``tree.py:1322-1366``)."""
        out = self.metacopy()
        for dst, a, b in zip(out, self, other):
            nchild = len(a.children)
            last = a.tensor.ndim - 1
            # child and (non-root) parent bonds concatenate; physical legs
            # and the trivial root bond must match
            lo, hi, merged = [], [], []
            for i, (d1, d2) in enumerate(zip(a.shape, b.shape)):
                bond_like = i < nchild or (i == last and a is not self.root)
                if bond_like:
                    merged.append(d1 + d2)
                    lo.append(slice(0, d1))
                    hi.append(slice(d1, d1 + d2))
                else:
                    assert d1 == d2
                    merged.append(d1)
                    lo.append(slice(None))
                    hi.append(slice(None))
            dtype = torch.promote_types(a.tensor.dtype, b.tensor.dtype)
            block = torch.zeros(merged, dtype=dtype, device=a.tensor.device)
            block[tuple(lo)] = a.tensor
            block[tuple(hi)] = b.tensor
            dst.tensor = block
            if a is self.root:
                np.testing.assert_allclose(a.qn, b.qn)
                dst.qn = a.qn.copy()
            else:
                dst.qn = np.vstack([a.qn, b.qn])
        out.check_shape()
        return out

    def normalize(self, kind):
        return normalize(self, kind)

    def evolve(self, ttno: TTNO, tau: Union[complex, float], normalize: bool = True):
        """Dispatch to ``EVOLVE_METHODS`` (reference ``tree.py:1385-1404``)."""
        if np.iscomplex(tau):
            ttns, coeff, tau = self, 1, tau.imag
            norm_kind = "ttns_and_coeff"  # imaginary time decays the norm
        else:
            ttns, coeff = self.to_complex(), -1j
            norm_kind = "ttns_only"
        stepper = EVOLVE_METHODS[self.evolve_config.method]
        out = stepper(ttns, ttno, coeff, tau)
        if normalize:
            out.normalize(norm_kind)
        return out

    def metacopy(self):
        """A TTNS on the same tree with the same configs and coefficient.
        Its nodes share this state's tensors until the caller replaces
        them (every caller does); the JAX package starts from a Hartree
        product state instead."""
        nodes = [TreeNodeTensor(n.tensor, n.qn) for n in self.node_list]
        shell = type(self)(self.basis, root=copy_connection(self.node_list, nodes))
        shell.coeff = self.coeff
        for attr in ("optimize_config", "evolve_config", "compress_config"):
            setattr(shell, attr, getattr(self, attr).copy())
        return shell

    def copy(self):
        dup = self.metacopy()
        for dst, src in zip(dup, self):
            dst.tensor = src.tensor
            dst.qn = src.qn.copy()
        return dup

    def to_complex(self, inplace: bool = False) -> "TTNS":
        new = self if inplace else self.metacopy()
        for node1, node2 in zip(self, new):
            node2.tensor = node1.tensor.to(
                torch.promote_types(node1.tensor.dtype, backend.complex_dtype))
            node2.qn = node1.qn.copy()
        return new

    def todense(self, order: List[BasisSet] = None) -> np.ndarray:
        args = self.to_contract_args()
        if order is None:
            order = self.basis.basis_list
        args.append([("down", str(basis.dofs)) for basis in order])
        return to_numpy(einsum_interleaved(*args))

    def update_2site(self, node, tensor, m=None, percent: float = 0, cano_parent: bool = True):
        """Truncate a 2-site (node+parent) coefficient and write back
        (reference ``tree.py:1470-1514``): randomized sector-pure candidates
        on the device, the selection on the host from their spectrum (one
        small fetch, or with ``trunc_device.async_enabled`` the previous
        visit's spectrum: :meth:`_plan_spectrum`), then the device gather
        and rotation, as ``Mps._update_mps_device``.  Threshold criteria
        take the full-rank cap; sentinel slots (sigma = -1) count toward
        neither the bond dimension nor the selection; the kept slots go in
        sector-major order."""
        with span("trunc"):
            if self.compress_config.bonddim_should_set:
                self.compress_config.set_bonddim(len(self.node_list) + 1)
            parent = node.parent
            assert parent is not None
            qnbigl, qnbigr, _ = self.get_qnmat(node, include_parent=True)
            dim1 = int(np.prod(qnbigl.shape[:-1]))
            dim2 = int(np.prod(qnbigr.shape[:-1]))
            if isinstance(tensor, (list, tuple)):
                return self._update_2site_averaged(
                    node, [t.reshape(dim1, dim2) for t in tensor],
                    qnbigl, qnbigr, m, percent, cano_parent,
                )
            tensor = tensor.reshape(dim1, dim2)
            bond_idx = self.node_idx[node]
            if m is not None:
                cap = int(m[bond_idx]) if isinstance(m, (list, tuple, np.ndarray)) else int(m)
            elif self.compress_config.criteria is CompressCriteria.fixed:
                cap = self.compress_config.compute_m_trunc(
                    np.full(min(dim1, dim2), np.inf), bond_idx, left=False)
            else:
                cap = min(dim1, dim2)
            system = "L" if cano_parent else "R"
            # the JAX package's plan reuse (tree.py:914-940): at percent 0 with
            # a fixed cap and an unchanged quantum-number pattern, select from
            # the previous visit's spectrum, whose copy to the host ran
            # meanwhile; there is no static path
            use_async = (percent == 0 and trunc_device.async_enabled()
                         and (m is not None
                              or self.compress_config.criteria is CompressCriteria.fixed))
            parts, sigma, qn_list = trunc_device.candidates(
                tensor, qnbigl, qnbigr, self.qntot, system, cap,
                want_complement=(percent != 0), fetch=not use_async)
            if use_async:
                sigma = self._plan_spectrum(
                    bond_idx, cano_parent, sigma,
                    trunc_device.plan_pattern(qnbigl, qnbigr, self.qntot, cap, system))
            valid = sigma[sigma >= 0]
            if m is None:
                m_trunc = self.compress_config.compute_m_trunc(valid, bond_idx, left=False)
            else:
                m_trunc = min(cap, len(valid))
            sidx = sorted(select_indices(sigma, qn_list, m_trunc, percent))
            msqn = np.array([qn_list[i] for i in sidx])
            ms, comp = trunc_device.apply_selection(tensor, parts, sidx, dim1, dim2, system)
            if cano_parent:
                m_node, m_parent = ms, comp          # (dim1, k), (k, dim2)
            else:
                m_node, m_parent = comp, ms.T        # (dim1, k), (k, dim2)
            self._write_2site(node, m_node, m_parent, msqn, cano_parent)

    def _plan_spectrum(self, node_idx, cano_parent, pending, pattern):
        """The spectrum an asynchronous update selects from: the previous
        visit's of the same ``(node_idx, cano_parent)`` when its pattern
        digest (``trunc_device.plan_pattern``) matches, else the current
        one; this visit's ``PendingSpectrum`` becomes the plan."""
        plans = self.__dict__.setdefault("_trunc_plans", {})
        key = (node_idx, bool(cano_parent))
        plan = plans.get(key)
        if plan is not None and plan[0] == pattern:
            sigma = plan[1].sigma()
            COUNTERS["trunc.plan.tree_stale"] += 1
        else:
            sigma = pending.sigma()
            COUNTERS["trunc.plan.tree_sync"] += 1
        plans[key] = (pattern, pending)
        return sigma

    def _write_2site(self, node, m_node, m_parent, msqn, cano_parent):
        parent = node.parent
        node.tensor = m_node.reshape(list(node.shape[:-1]) + [-1])
        node.qn = msqn if cano_parent else self.qntot - msqn
        assert node.shape[-1] == len(node.qn)
        # the truncated bond becomes the parent's leading axis, then moves
        # back into this child's slot
        ichild = parent.children.index(node)
        parent_shape = [-1] + [
            d for i, d in enumerate(parent.shape) if i != ichild
        ]
        parent.tensor = torch.movedim(m_parent.reshape(parent_shape), 0, ichild)

    def _update_2site_averaged(self, node, mats, qnbigl, qnbigr, m, percent,
                               cano_parent: bool):
        """State-averaged 2-site update: the renormalized basis diagonalizes
        the average of the roots' reduced density matrices, sector by sector
        through ``svd_qn.eigh_qn`` (real blocks on the Jacobi kernel); the
        sweep continues with root 0 rotated into the averaged basis."""
        system = "L" if cano_parent else "R"
        if cano_parent:
            ddm = sum(mat @ mat.conj().T for mat in mats) / len(mats)
        else:
            ddm = sum(mat.conj().T @ mat for mat in mats) / len(mats)
        u, s, qnnew = eigh_qn(ddm, qnbigl, qnbigr, self.qntot, system)
        if m is None:
            m_trunc = self.compress_config.compute_m_trunc(
                s, self.node_idx[node], left=False)
        else:
            m_cap = (m[self.node_idx[node]]
                     if isinstance(m, (list, tuple, np.ndarray)) else m)
            m_trunc = int(min(m_cap, len(s)))
        ms, msdim, msqn, _ = select_basis(u, s, qnnew, None, m_trunc,
                                          percent=percent)
        if cano_parent:
            m_node = ms                                   # (dim1, k) isometry
            m_parent = ms.conj().T @ mats[0]              # (k, dim2)
        else:
            m_node = mats[0] @ ms.conj()                  # (dim1, k)
            m_parent = ms.T                               # (k, dim2) isometry
        self._write_2site(node, m_node, m_parent, msqn, cano_parent)

    @property
    def norm(self):
        return abs(self.coeff) * self.ttns_norm

    @property
    def ttns_norm(self):
        sq = float(np.real(self.expectation(TTNO.dummy(self.basis))))
        if sq < 0:
            if abs(sq) >= 1e-8:
                raise RuntimeError(f"negative norm^2: {sq}")
            sq = 0.0
        return sq ** 0.5

    def scale(self, val, inplace=False):
        new = self if inplace else self.copy()
        if np.iscomplex(val):
            new.to_complex(inplace=True)
        else:
            val = val.real
        new.root.tensor = new.root.tensor * val
        return new

    def dump(self, fname, other_attrs=None):
        if other_attrs is None:
            other_attrs = []
        super().dump(fname, other_attrs + ["coeff"])

    @property
    def bond_dims_exact(self) -> np.ndarray:
        with np.errstate(over="ignore"):
            exact = [None] * len(self)
            for node in self.postorder_list():
                idx = self.node_idx[node]
                local = float(np.prod(self.pbond_dims[idx]))
                for child in node.children:
                    local *= exact[self.node_idx[child]]
                exact[idx] = local
            exact[self.node_idx[self.root]] = 1
            return exact

    def expand_bond_dimension(self, hint_mpo=None, coef=1e-10, include_ex=False):
        from renormalizer_tpu_torch.mps.mps import expand_bond_dimension_general

        assert not include_ex
        return expand_bond_dimension_general(self, hint_mpo, coef, None)

    def __add__(self, other: "TTNS"):
        return self.add(other)


class TTNEnviron(Tree):
    """Environment tree: children environments built postorder, parent
    environments preorder (reference ``tree.py:1577-1720``)."""

    def __init__(self, ttns: TTNS, ttno: TTNO, build_environ=True):
        self.basis_ttns = ttns.basis
        self.basis_ttno = ttno.basis
        enodes = [TreeNodeEnviron() for _ in range(ttns.size)]
        copy_connection(ttns.node_list, enodes)
        super().__init__(enodes[0])
        assert self.root.parent is None
        self.root.environ_parent = torch.ones((1, 1, 1), dtype=backend.real_dtype,
                                              device=backend.device)
        self.tn2dofs_ttns = {
            tn: bn.dofs for tn, bn in zip(self.node_list, self.basis_ttns.node_list)
        }
        self.tn2dofs_ttno = {
            tn: bn.dofs for tn, bn in zip(self.node_list, self.basis_ttno.node_list)
        }
        if build_environ:
            self.build_children_environ(ttns, ttno)
            self.build_parent_environ(ttns, ttno)

    def build_children_environ(self, ttns, ttno):
        for snode in ttns.postorder_list():
            self.build_children_environ_node(snode, ttns, ttno)

    def build_parent_environ(self, ttns, ttno):
        for snode in ttns.node_list:
            for ichild in range(len(snode.children)):
                self.build_parent_environ_node(snode, ichild, ttns, ttno)

    def update_1bond(self, snode, ttns, ttno):
        self.build_children_environ_node(snode, ttns, ttno)
        self.build_parent_environ_node(snode.parent, snode.idx_as_child, ttns, ttno)

    def update_1site(self, snode, ttns, ttno):
        self.build_children_environ_node(snode, ttns, ttno)
        for i, _ in enumerate(snode.children):
            self.build_parent_environ_node(snode, i, ttns, ttno)

    def update_2site(self, snode, ttns, ttno):
        with span("env"):
            parent = snode.parent
            for n in (snode, parent):
                self.build_children_environ_node(n, ttns, ttno)
            for n in (parent, snode):
                for i, _ in enumerate(n.children):
                    self.build_parent_environ_node(n, i, ttns, ttno)

    def _sandwich_args(self, snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO):
        """The bra / operator / ket column of one node, as interleaved
        einsum arguments (shared by both environment builders)."""
        onode = ttno.node_list[ttns.node_idx[snode]]
        return [
            snode.tensor.conj(), ttns.get_node_indices(snode, conj=True),
            onode.tensor, ttno.get_node_indices(onode),
            snode.tensor, ttns.get_node_indices(snode, ttno=ttno),
        ]

    def build_children_environ_node(self, snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO):
        if snode.parent is None:
            return
        enode = self.node_list[ttns.node_idx[snode]]
        args = []
        for i, env in enumerate(enode.environ_children):
            args += [env, self.get_child_indices(enode, i, ttns, ttno)]
        args += self._sandwich_args(snode, ttns, ttno)
        args.append(self.get_parent_indices(enode, ttns, ttno))
        res = einsum_interleaved(*args)
        slots = enode.parent.environ_children
        if len(slots) == len(enode.parent.children):
            slots[snode.idx_as_child] = res
        else:
            slots.append(res)

    def build_parent_environ_node(self, snode: TreeNodeTensor, ichild: int, ttns: TTNS, ttno: TTNO):
        enode = self.node_list[ttns.node_idx[snode]]
        args = []
        for j, env in enumerate(enode.environ_children):
            if j != ichild:
                args += [env, self.get_child_indices(enode, j, ttns, ttno)]
        args += [enode.environ_parent,
                 self.get_parent_indices(enode, ttns, ttno)]
        args += self._sandwich_args(snode, ttns, ttno)
        args.append(self.get_child_indices(enode, ichild, ttns, ttno))
        enode.children[ichild].environ_parent = einsum_interleaved(*args)

    def get_child_indices(self, enode, i, ttns, ttno):
        dofs = self.tn2dofs_ttns[enode]
        dofs_child = self.tn2dofs_ttns[enode.children[i]]
        dofs_o = self.tn2dofs_ttno[enode]
        dofs_o_child = self.tn2dofs_ttno[enode.children[i]]
        return [
            (str(id(ttns)) + "_conj", str(dofs), str(dofs_child)),
            (str(id(ttno)), str(dofs_o), str(dofs_o_child)),
            (str(id(ttns)), str(dofs), str(dofs_child)),
        ]

    def get_parent_indices(self, enode, ttns, ttno):
        dofs = self.tn2dofs_ttns[enode]
        dofs_o = self.tn2dofs_ttno[enode]
        if enode.parent is not None:
            dofs_parent = self.tn2dofs_ttns[enode.parent]
            dofs_o_parent = self.tn2dofs_ttno[enode.parent]
        else:
            dofs_parent = dofs_o_parent = "root"
        return [
            (str(id(ttns)) + "_conj", str(dofs_parent), str(dofs)),
            (str(id(ttno)), str(dofs_o_parent), str(dofs_o)),
            (str(id(ttns)), str(dofs_parent), str(dofs)),
        ]


def from_mps(mps: Mps) -> Tuple[BasisTree, TTNS, TTNO]:
    """Convert an MPS (and its Hamiltonian) to the equivalent linear TTNS
    (reference ``tree.py:1723-1744``)."""
    mps = mps.copy()
    mps.ensure_left_canonical()
    mps.move_qnidx(len(mps) + 1)
    basis = BasisTree.linear(mps.model.basis[::-1])
    ttns = TTNS(basis)
    for i in range(len(mps)):
        node = ttns.node_list[::-1][i]
        tensor = mps[i]
        if i == 0:
            tensor = tensor[0, ...]
        node.tensor = tensor
        node.qn = np.asarray(mps.qn[i + 1])
    ttns.check_shape()
    ttns.check_canonical()
    ttno = TTNO(basis, mps.model.ham_terms)
    return basis, ttns, ttno


def compress_recursion(snode: TreeNodeTensor, ttns: TTNS, s_dict: Dict, temp_m_trunc=None):
    assert snode.children, "can't compress a single tree node"
    for ichild, child in enumerate(snode.children):
        # leaves stay non-canonical (sigma folds into them); interior
        # children become canonical, recurse, then push back up
        is_interior = bool(child.children)
        s_dict[child] = ttns.compress_node(
            snode, ichild, temp_m_trunc, cano_child=is_interior)
        if is_interior:
            compress_recursion(child, ttns, s_dict, temp_m_trunc)
            ttns.push_cano_to_parent(child)


def moveaxis(ttns: TTNS, node: TreeNodeTensor, ichild: int):
    """Move one child bond to the last axis and flatten for decomposition
    (reference ``tree.py:1770-1791``)."""
    qnbigl = np.zeros(ttns.basis.qn_size, dtype=int)
    for child in node.children:
        if child is node.children[ichild]:
            continue
        qnbigl = add_outer(qnbigl, child.qn)
    for b in ttns.tn2bn[node].basis_sets:
        qnbigl = add_outer(qnbigl, b.sigmaqn)
    qnbigl = add_outer(qnbigl, ttns.qntot - node.qn)
    qnbigr = node.children[ichild].qn
    tensor = torch.movedim(node.tensor, ichild, -1)
    shape = list(tensor.shape)
    tensor = tensor.reshape(-1, node.shape[ichild])
    return qnbigl, qnbigr, tensor, shape


def get_skip_pidx(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO) -> List[int]:
    """Physical bonds present in the TTNS but absent in the TTNO contract
    directly with the conjugate (reference ``tree.py:1794-1809``)."""
    if ttno is None:
        return []
    idx = ttns.node_idx[snode]
    basis_ttns = ttns.basis.node_list[idx]
    basis_ttno = ttno.basis.node_list[idx]
    if basis_ttns.dofs == basis_ttno.dofs:
        return []
    return [i for i, dof in enumerate(basis_ttns.dofs) if dof not in basis_ttno.dofs]
