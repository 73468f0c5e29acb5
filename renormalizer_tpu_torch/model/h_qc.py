r"""Ab-initio quantum chemistry models via Jordan-Wigner.

FCIDUMP reader, spatial-to-spin integral transform, JW ladder operators with
sigma-z string simplification and per-spin quantum numbers (n_alpha, n_beta).
Numpy copy of ``renormalizer_tpu/model/h_qc.py`` (reference
``renormalizer/model/h_qc.py:14-196``).

JW convention (reference ``h_qc.py:136-144``): with |0> = occupied-alpha-like
computer ordering,

    a_j   -> prod_{l<j} sigma_z[l] * sigma_+[j]
    a_j^+ -> prod_{l<j} sigma_z[l] * sigma_-[j]

so sigma_- *creates* a particle (qn +1 on its spin channel).
"""

import itertools
import logging
from functools import partial

import numpy as np

from renormalizer_tpu_torch.model.basis import BasisHalfSpin
from renormalizer_tpu_torch.model.op import Op

logger = logging.getLogger(__name__)


def read_fcidump(fname, norb):
    """Parse an FCIDUMP file into spin-orbital integrals.

    Returns ``(sh, aseri, nuc)``: spin-orbital one-electron integrals, the
    antisymmetrized two-electron integrals of arXiv:2006.02056 eq 18, and the
    nuclear repulsion energy.  Reference ``h_qc.py:14-47``.
    """
    eri = np.zeros((norb, norb, norb, norb))
    h = np.zeros((norb, norb))
    nuc = 0.0
    with open(fname) as f:
        for line_no, line in enumerate(f):
            if line_no < 4:
                continue
            fields = line.split()
            integral = float(fields[0])
            p, q, r, s = (int(x) for x in fields[1:5])
            if r != 0:
                eri[p - 1, q - 1, r - 1, s - 1] = integral
                eri[q - 1, p - 1, r - 1, s - 1] = integral
                eri[p - 1, q - 1, s - 1, r - 1] = integral
                eri[q - 1, p - 1, s - 1, r - 1] = integral
            elif p != 0:
                h[p - 1, q - 1] = integral
                h[q - 1, p - 1] = integral
            else:
                nuc = integral
    sh, aseri = int_to_h(h, eri)
    logger.info(f"nuclear repulsion: {nuc}")
    return sh, aseri, nuc


def int_to_h(h, eri):
    """Spatial-orbital integrals to antisymmetrized spin-orbital integrals
    (reference ``h_qc.py:50-69``).  Even spin-orbital indices are alpha."""
    nsorb = len(h) * 2
    seri = np.zeros((nsorb,) * 4)
    sh = np.zeros((nsorb, nsorb))
    for p, q, r, s in itertools.product(range(nsorb), repeat=4):
        # a_p^+ a_q^+ a_r a_s : spin must match within (p,s) and (q,r)
        if p % 2 == s % 2 and q % 2 == r % 2:
            seri[p, q, r, s] = eri[p // 2, s // 2, q // 2, r // 2]
    for q, s in itertools.product(range(nsorb), repeat=2):
        if q % 2 == s % 2:
            sh[q, s] = h[q // 2, s // 2]
    aseri = np.zeros((nsorb,) * 4)
    for q, s in itertools.product(range(nsorb), repeat=2):
        for p, r in itertools.product(range(q), range(s)):
            aseri[p, q, r, s] = seri[p, q, r, s] - seri[p, q, s, r]
    return sh, aseri


def generate_ladder_operator(norbs):
    """JW ladder operators (reference ``h_qc.py:72-82``)."""
    a_ops, a_dag_ops = [], []
    for j in range(norbs):
        z_string = [Op("Z", l) for l in range(j)]
        a_ops.append(Op.product(z_string + [Op("+", j)]))
        a_dag_ops.append(Op.product(z_string + [Op("-", j)]))
    return a_ops, a_dag_ops


def simplify_op(old_op: Op, norbs: int, conserve_qn: bool = True) -> Op:
    """Cancel sigma-z pairs using {Z, +} = {Z, -} = 0 and assign per-spin
    quantum numbers (reference ``h_qc.py:85-124``)."""
    dof_to_siteidx = {i: i for i in range(norbs)}
    if conserve_qn:
        qn_even = {"+": [-1, 0], "-": [1, 0], "Z": [0, 0]}
        qn_odd = {"+": [0, -1], "-": [0, 1], "Z": [0, 0]}
    else:
        qn_even = qn_odd = {"+": 0, "-": 0, "Z": 0}

    elem_ops, _ = old_op.split_elementary(dof_to_siteidx)
    new_ops = []
    for elem in elem_ops:
        # count anticommutation swaps needed to bubble all Z to the front
        n_z = elem.split_symbol.count("Z")
        n_other_seen = 0
        n_permute = 0
        for s in elem.split_symbol:
            if s != "Z":
                n_other_seen += 1
            else:
                n_permute += n_other_seen
        new_symbol = [s for s in elem.split_symbol if s != "Z"]
        if n_z % 2 == 1:
            new_symbol.insert(0, "Z")
        if not new_symbol:
            # pure identity after cancellation
            continue
        dof = elem.dofs[0]
        qn_dict = qn_odd if (conserve_qn and dof % 2 == 1) else qn_even
        new_ops.append(
            Op(" ".join(new_symbol), dof, (-1) ** n_permute,
               [qn_dict[s] for s in new_symbol])
        )
    return Op.product(new_ops)


def qc_model(h1e, h2e, stacked=False, conserve_qn=True):
    """Spin-orbital ab-initio Hamiltonian -> (basis, ham_terms)
    (reference ``h_qc.py:127-195``).

    With ``stacked=True`` the terms are grouped per leading orbital index for
    use with ``StackedMpo``.
    """
    norbs = h1e.shape[0]
    logger.info(f"spin norbs: {norbs}")
    assert np.all(np.array(h1e.shape) == norbs)
    assert np.all(np.array(h2e.shape) == norbs)

    process_op = partial(simplify_op, norbs=norbs, conserve_qn=conserve_qn)
    pairs1 = np.argwhere(h1e != 0)
    pairs2 = np.argwhere(h2e != 0)
    a_ops, a_dag_ops = generate_ladder_operator(norbs)

    ham_terms = []
    if not stacked:
        for p, q in pairs1:
            ham_terms.append(process_op(a_dag_ops[p] * a_ops[q]) * h1e[p, q])
        for p, q, r, s in pairs2:
            op = process_op(
                Op.product([a_dag_ops[p], a_dag_ops[q], a_ops[r], a_ops[s]])
            )
            ham_terms.append(op * h2e[p, q, r, s])
    else:
        leading = set(np.unique(pairs1[:, 0])).union(np.unique(pairs2[:, 0]))
        for p in sorted(leading):
            local_terms = []
            for q in pairs1[pairs1[:, 0] == p][:, 1]:
                local_terms.append(process_op(a_dag_ops[p] * a_ops[q]) * h1e[p, q])
            for q, r, s in pairs2[pairs2[:, 0] == p][:, 1:]:
                op = process_op(
                    Op.product([a_dag_ops[p], a_dag_ops[q], a_ops[r], a_ops[s]])
                )
                local_terms.append(op * h2e[p, q, r, s])
            ham_terms.append(local_terms)

    basis = []
    for iorb in range(norbs):
        if conserve_qn:
            sigmaqn = np.array([[0, 0], [1, 0]]) if iorb % 2 == 0 else np.array([[0, 0], [0, 1]])
        else:
            sigmaqn = [0, 0]
        basis.append(BasisHalfSpin(iorb, sigmaqn=sigmaqn))
    return basis, ham_terms
