r"""Symbolic MPO compiler: sum-of-product operator -> compact MPO.

Host-side "compiler" that runs once per operator; the numeric site tensors it
emits are moved to the backend's device by :class:`Mpo`.  Algorithm follows the reference
(``renormalizer/mps/symbolic_mpo.py:22-347``):

1. ``_terms_to_table``: each term becomes a row of primary-operator indices,
   one column per site; duplicate rows are merged by summing factors.
2. Site-by-site sweep.  At each site the table splits into a row part
   (incoming bond x current site) and a column part (remaining sites).  The
   sparse interaction matrix Gamma between unique row/column patterns is
   decomposed either by

   * pivoted QR (``algo="qr"``, default): Gamma = Q R, bond dimension = the
     numerical rank of Gamma, or
   * bipartite minimum vertex cover (``algo="Hopcroft-Karp"/"Hungarian"``):
     Koenig's theorem yields the minimal set of row/column operators; columns
     in the cover become complementary operators.

3. ``compose_symbolic_mo`` renders each bond transformation as a matrix of
   operator sums; ``symbolic_mo_to_numeric_mo`` evaluates it with
   ``basis.op_mat``.

Also contains the symbolic two-site swap used by on-the-fly DoF reordering
(OFS), including the Jordan-Wigner-aware variant
(reference ``symbolic_mpo.py:516-726``).

Numpy copy of ``renormalizer_tpu/mps/symbolic_mpo.py``.
"""

import logging
from collections import defaultdict, namedtuple
from typing import Dict, List, Tuple

import numpy as np
import scipy.linalg
import scipy.sparse

from renormalizer_tpu_torch.lib.bipartite import bipartite_vertex_cover
from renormalizer_tpu_torch.model import Model, Op
from renormalizer_tpu_torch.model.basis import BasisSet

logger = logging.getLogger(__name__)

# light-weight symbolic operator entry: `symbol` is a list of indices
# (incoming-bond index/indices followed by primary-op index), `qn` the total
# quantum number flowing through, `factor` the scalar weight.
OpTuple = namedtuple("OpTuple", ["symbol", "qn", "factor"])


def _terms_to_table(model: Model, terms: List[Op], const: float):
    """Operator terms -> (uint16 table, primary_ops, factor vector).
    Reference ``symbolic_mpo.py:356-438``."""
    nsite = model.nsite
    primary_per_site: List[Dict[Op, int]] = []
    primary_ops: List[Op] = []

    # index 0..nsite-1 are the per-site identities
    identity_row = []
    for b in model.basis:
        dof = b.dof[0] if b.multi_dof else b.dof
        op = Op.identity(dof, qn_size=model.qn_size)
        primary_per_site.append({op: len(primary_ops)})
        identity_row.append(len(primary_ops))
        primary_ops.append(op)

    table = []
    factor_list = []
    for term in terms:
        elem_ops, factor = term.split_elementary(model.dof_to_siteidx)
        row = identity_row.copy()
        for elem in elem_ops:
            site_idx = model.dof_to_siteidx[elem.dofs[0]]
            site_dict = primary_per_site[site_idx]
            if elem not in site_dict:
                site_dict[elem] = len(primary_ops)
                primary_ops.append(elem)
            row[site_idx] = site_dict[elem]
        table.append(row)
        factor_list.append(factor)

    if const != 0:
        table.append(identity_row.copy())
        factor_list.append(const)

    assert len(primary_ops) < np.iinfo(np.uint16).max
    table = np.array(table, dtype=np.uint16)
    factor = np.array(factor_list)
    logger.debug(f"Input operator terms: {table.shape[0]}")
    table, factor = _dedup_table(table, factor)
    logger.debug(f"After combination of the same terms: {table.shape[0]}")
    return table, primary_ops, factor


def _dedup_table(table, factor):
    """Merge identical rows by summing factors; drop negligible rows."""
    new_table, inverse = np.unique(table, axis=0, return_inverse=True)
    summed = np.zeros(len(new_table), dtype=factor.dtype)
    np.add.at(summed, inverse, factor)
    keep = np.abs(summed) > np.max(np.abs(summed)) * 1e-15
    return new_table[keep], summed[keep]


def _bond_qn(in_ops_list, symbol, primary_ops, k):
    """Quantum number carried by a composite out-operator."""
    qn = sum(in_ops[i][0].qn for in_ops, i in zip(in_ops_list, symbol[:-k]))
    qn = qn + sum(primary_ops[i].qn for i in symbol[-k:])
    return qn


def construct_symbolic_mpo(table, primary_ops, factor, algo="qr"):
    """Compile an operator table into a symbolic MPO.

    Returns ``(mpo, mpoqn, qntot, qnidx, out_ops_list, primary_ops)`` where
    ``mpo[i]`` is an object array of operator-sum lists with shape
    (bond_in, bond_out), ``mpoqn[i]`` the bond quantum numbers
    (dim, qn_size).  Reference ``symbolic_mpo.py:22-161``.
    """
    qn_size = len(primary_ops[0].qn)

    if table.shape[0] == 1:
        # single product term: bond dimension 1 everywhere
        mpo = []
        mpoqn = [np.zeros((1, qn_size), dtype=int)]
        op2idx = {op: i for i, op in enumerate(primary_ops)}
        out_ops_list: List[List[OpTuple]] = [[OpTuple([0], qn=0, factor=1)]]
        qn = np.zeros(qn_size, dtype=int)
        for idx in table[0]:
            op = primary_ops[idx]
            mo = np.full((1, 1), None, dtype=object)
            mo[0][0] = [op]
            mpo.append(mo)
            qn = mpoqn[-1][0] + op.qn
            mpoqn.append(np.array([qn]))
            out_ops_list.append([OpTuple([0, op2idx[op]], qn=qn, factor=1)])
        mpo[-1][0][0][0] = factor[0] * mpo[-1][0][0][0]
        last = out_ops_list[-1][0]
        out_ops_list[-1][0] = OpTuple(last.symbol, qn=last.qn, factor=factor[0] * last.factor)
        qntot = qn
        mpoqn[-1] = np.zeros((1, qn_size), dtype=int)
        qnidx = len(mpo) - 1
        return mpo, mpoqn, qntot, qnidx, out_ops_list, primary_ops

    logger.debug(f"symbolic mpo algorithm: {algo}")

    # pad with identity boundary columns
    pad = np.zeros((table.shape[0], 1), dtype=np.uint16)
    table = np.concatenate((pad, table, pad), axis=1)

    in_ops = [[OpTuple([0], qn=np.zeros(qn_size, dtype=int), factor=1)]]
    out_ops_list = _sweep_symbolic_mpo(table, in_ops, factor, primary_ops, algo)
    assert len(out_ops_list) == table.shape[1] - 1

    mpo = [
        compose_symbolic_mo(out_ops_list[i], out_ops_list[i + 1], primary_ops)
        for i in range(len(out_ops_list) - 1)
    ]
    mpoqn = [
        np.array([ops[0].qn for ops in out_ops]) for out_ops in out_ops_list
    ]
    qntot = mpoqn[-1][0]
    mpoqn[-1] = np.zeros((1, qn_size), dtype=int)
    qnidx = len(mpo) - 1
    return mpo, mpoqn, qntot, qnidx, out_ops_list, primary_ops


def _sweep_symbolic_mpo(table, in_ops, factor, primary_ops, algo="qr"):
    """Sweep the table site by site, returning all bond operator bases."""
    assert len(np.unique(table, axis=0)) == len(table)
    nsite = table.shape[1] - 2
    out_ops_list = [in_ops]
    for _ in range(nsite):
        out_ops, table, factor = _decompose_one_site(
            table[:, :2], table[:, 2:], [in_ops], factor, primary_ops, algo
        )
        in_ops = out_ops
        out_ops_list.append(out_ops)
    assert len(factor) == 1 and len(table) == 1
    assert factor[0] == 1
    return out_ops_list


def _decompose_one_site(table_row, table_col, in_ops_list, factor, primary_ops, algo, k=1):
    """Split one site off the table (reference ``symbolic_mpo.py:189-212``).

    ``k`` is the number of active-site columns in ``table_row`` (k>1 for the
    tree generalization)."""
    term_row, row_inv = np.unique(table_row, axis=0, return_inverse=True)
    assert len(in_ops_list) + k == term_row.shape[1]

    # hash-based unique for the (usually long) column part
    col_index: Dict[bytes, int] = {}
    term_col: List[np.ndarray] = []
    col_inv = []
    for row in table_col:
        key = row.tobytes()
        idx = col_index.get(key)
        if idx is None:
            idx = len(term_col)
            col_index[key] = idx
            term_col.append(row)
        col_inv.append(idx)

    # interaction matrix between unique rows and columns; entries index into
    # `factor` (shifted by one so zero means "no entry")
    gamma = scipy.sparse.coo_matrix(
        (np.arange(len(factor)) + 1, (row_inv, col_inv))
    ).tocsr()

    if algo.startswith("qr"):
        return _decompose_qr(term_row, term_col, gamma, in_ops_list, factor, primary_ops, k)
    return _decompose_graph(term_row, term_col, gamma, in_ops_list, factor, primary_ops, algo, k)


def _decompose_qr(term_row, term_col, gamma, in_ops_list, factor, primary_ops, k=1):
    r"""Pivoted-QR decomposition of the interaction matrix
    (reference ``symbolic_mpo.py:291-347``).

    Writing the operator as O = sum_jk Gamma_jk L_j (x) R_k, decompose
    Gamma = Q R so that the new bond operators are sum_j Q_jl L_j and the
    residual table rows are sum_k R_lk R_k.  Bond dimension = rank(Gamma).
    """
    assert gamma.shape == (len(term_row), len(term_col))
    gamma = gamma.astype(factor.dtype)
    gamma.data = factor[gamma.data.astype(int) - 1]
    dense = gamma.todense()

    if dense.shape[1] != 1:
        q, r, perm = scipy.linalg.qr(dense, mode="economic", pivoting=True)
    else:
        q, r, perm = dense, np.ones((1, 1)), np.array([0])

    rtol = 1e-10
    rank = int(np.sum(np.abs(np.diag(r)) > np.abs(r[0, 0]) * rtol))

    out_ops: List[List[OpTuple]] = [[] for _ in range(rank)]
    atol = 1e-10  # q columns are normalized: absolute tolerance
    for i, j in zip(*np.where(np.abs(q[:, :rank]) > atol)):
        qn = _bond_qn(in_ops_list, term_row[i], primary_ops, k)
        out_ops[j].append(OpTuple(term_row[i], qn, factor=q[i, j]))

    r2 = r[:rank, np.argsort(perm)]
    idx_l, idx_c = np.where(np.abs(r2) > np.abs(r[0, 0]) * rtol)
    new_factor = np.asarray(r2[(idx_l, idx_c)]).ravel()
    new_table = np.concatenate(
        [idx_l.reshape(-1, 1), [term_col[i] for i in idx_c]], axis=1
    )
    return out_ops, new_table, new_factor


def _decompose_graph(term_row, term_col, gamma, in_ops_list, factor, primary_ops, algo, k=1):
    """Bipartite-vertex-cover decomposition with complementary operators
    (reference ``symbolic_mpo.py:216-288``)."""
    bigraph = []
    if gamma.shape[0] < gamma.shape[1]:
        for i in range(gamma.shape[0]):
            bigraph.append(gamma.indices[gamma.indptr[i]:gamma.indptr[i + 1]])
        rowbool, colbool = bipartite_vertex_cover(bigraph, algo=algo)
    else:
        gamma_csc = gamma.tocsc()
        for i in range(gamma.shape[1]):
            bigraph.append(gamma_csc.indices[gamma_csc.indptr[i]:gamma_csc.indptr[i + 1]])
        colbool, rowbool = bipartite_vertex_cover(bigraph, algo=algo)

    row_select = np.nonzero(rowbool)[0]
    # rows covering the most columns first
    row_select = sorted(
        row_select, key=lambda i: gamma.indptr[i + 1] - gamma.indptr[i], reverse=True
    )
    col_select = np.nonzero(colbool)[0]

    out_ops: List[List[OpTuple]] = []
    new_table = []
    new_factor = []

    # selected rows become single out-operators; each covered column yields
    # one residual table row
    for row_idx in row_select:
        qn = _bond_qn(in_ops_list, term_row[row_idx], primary_ops, k)
        out_ops.append([OpTuple(term_row[row_idx], qn, factor=1.0)])
        col_link = gamma.indices[gamma.indptr[row_idx]:gamma.indptr[row_idx + 1]]
        stack = np.full((len(col_link), 1), len(out_ops) - 1, dtype=np.uint16)
        new_table.append(np.hstack((stack, [term_col[i] for i in col_link])))
        new_factor.append(factor[gamma[row_idx, col_link].toarray().astype(int) - 1])
        gamma.data[gamma.indptr[row_idx]:gamma.indptr[row_idx + 1]] = 0
    gamma.eliminate_zeros()

    # selected columns become complementary operators (weighted sums of the
    # remaining rows) with a single residual table row each
    nz_rows, nz_cols = gamma.nonzero()
    for col_idx in col_select:
        out_ops.append([])
        col_vals = gamma[:, col_idx].toarray().flatten().astype(int)
        for i in nz_rows[np.nonzero(nz_cols == col_idx)[0]]:
            qn = _bond_qn(in_ops_list, term_row[i], primary_ops, k)
            out_ops[-1].append(OpTuple(term_row[i], qn, factor=factor[col_vals[i] - 1]))
        new_table.append(
            np.array([len(out_ops) - 1] + list(term_col[col_idx]), dtype=np.uint16).reshape(1, -1)
        )
        new_factor.append(1.0)

    table = np.concatenate(new_table)
    assert len(out_ops) <= np.iinfo(np.uint16).max
    factor = np.concatenate(new_factor, axis=None)
    assert len(table) == len(factor)
    return out_ops, table, factor


def compose_symbolic_mo(in_ops, out_ops, primary_ops):
    """Render the bond transformation as a (len_in, len_out) object array of
    operator-sum lists (reference ``symbolic_mpo.py:443-453``)."""
    mo = np.empty((len(in_ops), len(out_ops)), dtype=object)
    for idx in np.ndindex(*mo.shape):
        mo[idx] = []
    for iop, out_op in enumerate(out_ops):
        for entry in out_op:
            in_idx = entry.symbol[0]
            op = primary_ops[entry.symbol[1]]
            mo[in_idx][iop].append(entry.factor * op)
    return mo


def symbolic_mo_to_numeric_mo(basis: BasisSet, mo, dtype):
    """Evaluate a symbolic site matrix into the numeric MPO site tensor with
    layout (bond_in, pdim, pdim, bond_out)
    (reference ``symbolic_mpo.py:457-468``)."""
    pdim = basis.nbas
    mat = np.zeros(list(mo.shape) + [pdim, pdim], dtype=dtype)
    for idx, terms in np.ndenumerate(mo):
        for term in terms:
            mat[idx] += basis.op_mat(term)
    # (in, out, up, down) -> (in, up, down, out)
    axes = list(range(mo.ndim + 2))
    axes = axes[:-3] + axes[-2:] + [axes[-3]]
    return mat.transpose(axes)


def _format_symbolic_mpo(symbolic_mpo):
    """Pretty-print a symbolic MPO for debugging
    (reference ``symbolic_mpo.py:471-509``)."""

    def fmt(op: Op):
        s = op.symbol.replace(r"^\dagger", "†")
        if op.factor != 1:
            s = f"{op.factor:.1e} * " + s
        return s

    out_lines = []
    for mo in symbolic_mpo:
        strings = np.empty((len(mo), len(mo[0])), dtype=object)
        for i, row in enumerate(mo):
            for j, terms in enumerate(row):
                strings[i][j] = " + ".join(fmt(op) for op in terms) if terms else "0"
        widths = np.vectorize(len)(strings).max(axis=0)
        lines = []
        for row in strings:
            padded = [t + " " * (widths[j] - len(t)) for j, t in enumerate(row)]
            lines.append("│ " + "   ".join(padded) + " │")
        if len(lines) != 1:
            lines[0] = "┏" + lines[0][1:-1] + "┓"
            lines[-1] = "┗" + lines[-1][1:-1] + "┛"
        out_lines.append("\n".join(lines))
    return "\n".join(out_lines)


# ---------------------------------------------------------------------------
# symbolic two-site swap for on-the-fly DoF ordering (OFS)
# reference ``symbolic_mpo.py:516-726``
# ---------------------------------------------------------------------------

ExpandedOp = namedtuple("ExpandedOp", ["factor", "out_ops1_idx", "site1_op_idx", "site2_op_idx"])
_DummyOp = namedtuple("DummyOp", ["qn"])


def _expand_bond3(out_ops2, out_ops3_sum):
    """Expand a bond-3 operator into explicit (bond1, site1, site2) terms."""
    res = []
    for out_op in out_ops3_sum:
        for inner in out_ops2[out_op.symbol[0]]:
            res.append(
                ExpandedOp(
                    inner.factor * out_op.factor,
                    inner.symbol[0], inner.symbol[1], out_op.symbol[1],
                )
            )
    return res


def _swapped_row_jw(row, primary_ops: List, op2idx: Dict):
    """Jordan-Wigner-aware swap of one table row (reference
    ``symbolic_mpo.py:582-635``).  The swap rule for JW strings:
    a1 -> a1 z2, a2 -> z1 a2 etc., with sign from anticommutation."""
    assert len(row) == 5 and row[-1] == 0
    op1: Op = primary_ops[row[1]]
    op2: Op = primary_ops[row[2]]

    def parity(op):
        return (op.split_symbol.count("sigma_+") + op.split_symbol.count("sigma_-")) % 2

    op1_odd, op2_odd = parity(op1), parity(op2)
    coeff = (-1) ** (op2_odd * (op1.split_symbol.count("sigma_+") + op1.split_symbol.count("sigma_-")))

    def prepend_z(op: Op):
        syms = op.split_symbol
        if syms[0] == "I":
            assert len(syms) == 1
            return Op("sigma_z", op.dofs[0], qn=0)
        if syms[0] == "sigma_z":
            if len(syms) == 1:
                return Op.identity(op.dofs[0])
            return Op(" ".join(syms[1:]), op.dofs[1:], qn=op.qn_list[1:])
        if syms[0] in ("sigma_+", "sigma_-"):
            return Op("sigma_z " + op.symbol, [op.dofs[0]] + op.dofs, qn=[0] + op.qn_list)
        raise AssertionError(f"unexpected JW symbol {syms[0]}")

    new_op1 = prepend_z(op1) if op2_odd else op1
    new_op2 = prepend_z(op2) if op1_odd else op2
    for op in (new_op1, new_op2):
        if op not in op2idx:
            op2idx[op] = len(primary_ops)
            primary_ops.append(op)
    return [row[0], op2idx[new_op1], op2idx[new_op2], row[3], row[4]], coeff


def swap_site(out_ops_list, primary_ops: List, swap_jw: bool, algo="Hopcroft-Karp"):
    """Swap two adjacent MPO sites symbolically.

    ``out_ops_list`` holds the operator bases at the three bonds around the
    two sites.  Returns the new bond-2/bond-3 bases, the two new symbolic
    site matrices and the new bond-2 quantum numbers.
    Reference ``symbolic_mpo.py:650-726``.
    """
    out_ops1, out_ops2, out_ops3 = out_ops_list

    out_ops3_expanded = [_expand_bond3(out_ops2, s) for s in out_ops3]

    table, factor = [], []
    # auxiliary dummy primary ops label the bond-3 channels so the recompiled
    # MPO can be matched back channel by channel
    aux_ops = [_DummyOp(-s[0].qn) for s in out_ops3]
    n_primary = len(primary_ops)

    if not swap_jw:
        primary_ops = primary_ops.copy()
        primary_ops.extend(aux_ops)

    for i, expanded in enumerate(out_ops3_expanded):
        for op in expanded:
            # swap the two site columns and append the channel label
            table.append([op.out_ops1_idx, op.site2_op_idx, op.site1_op_idx, n_primary + i, 0])
            factor.append(op.factor)
    table, factor = _dedup_table(np.array(table), np.array(factor))

    if swap_jw:
        # swapping fermionic strings rewrites the operators in place
        op2idx = {op: i for i, op in enumerate(primary_ops)}
        new_table, new_factor = [], []
        for row, f in zip(table, factor):
            new_row, coeff = _swapped_row_jw(row, primary_ops, op2idx)
            new_table.append(new_row)
            new_factor.append(coeff * f)
        table, factor = np.array(new_table), np.array(new_factor)
        table[:, 3] = table[:, 3] + (len(primary_ops) - n_primary)
        n_primary = len(primary_ops)
        primary_ops = primary_ops.copy()
        primary_ops.extend(aux_ops)

    new_out_ops = _sweep_symbolic_mpo(table, out_ops1, factor, primary_ops, algo=algo)
    assert len(new_out_ops) == 4
    new_out_ops1, new_out_ops2, unsorted3 = new_out_ops[:3]

    # reorder bond-3 operators back into the original channel order using the
    # dummy labels
    new_out_ops3 = [None] * len(unsorted3)
    assert len(new_out_ops3) == len(aux_ops)
    assert len(new_out_ops[-1]) == 1
    for dummy in new_out_ops[-1][0]:
        idx1, idx2 = dummy.symbol
        idx2 -= n_primary
        channel = unsorted3[idx1]
        if dummy.factor != 1:
            channel = [
                OpTuple(op.symbol, op.qn, op.factor * dummy.factor) for op in channel
            ]
        new_out_ops3[idx2] = channel
    assert None not in new_out_ops3

    mo1 = compose_symbolic_mo(out_ops1, new_out_ops2, primary_ops)
    mo2 = compose_symbolic_mo(new_out_ops2, new_out_ops3, primary_ops)
    qn = [opsum[0].qn for opsum in new_out_ops2]
    return new_out_ops2, new_out_ops3, mo1, mo2, qn
