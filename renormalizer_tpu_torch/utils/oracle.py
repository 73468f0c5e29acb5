r"""Dense exact-diagonalization oracles for small models.

Replaces the reference's qutip-based test utilities
(``renormalizer/utils/qutip_utils.py``) with a direct kron assembly from the
symbolic operator layer — usable for any model whose full Hilbert space fits
in memory.  Numpy copy of ``renormalizer_tpu/utils/oracle.py``.
"""

import numpy as np


def dense_hamiltonian(model) -> np.ndarray:
    """Dense matrix of ``model.ham_terms`` in the full product basis
    (site-major ordering matching ``Mps.todense``)."""
    return dense_operator(model, model.ham_terms)


def dense_operator(model, terms) -> np.ndarray:
    """Dense matrix of arbitrary symbolic terms on ``model``'s basis."""
    dim = int(np.prod(model.pbond_list))
    H = np.zeros((dim, dim), dtype=complex)
    for op in terms:
        elem_ops, factor = op.split_elementary(model.dof_to_siteidx)
        site_mats = {
            model.dof_to_siteidx[e.dofs[0]]: model.dof_to_basis[e.dofs[0]].op_mat(e)
            for e in elem_ops
        }
        full = np.eye(1)
        for i, b in enumerate(model.basis):
            full = np.kron(full, site_mats.get(i, np.eye(b.nbas)))
        H = H + factor * full
    if np.allclose(H.imag, 0):
        H = H.real
    return H


def sector_indices(model, qntot) -> np.ndarray:
    """Indices of product states whose total quantum number equals
    ``qntot``."""
    dims = model.pbond_list
    qntot = np.atleast_1d(np.asarray(qntot))
    qn = np.array([
        sum(model.basis[i].sigmaqn[np.unravel_index(s, dims)[i]]
            for i in range(len(dims)))
        for s in range(int(np.prod(dims)))
    ]).reshape(-1, len(qntot))
    return np.nonzero((qn == qntot).all(axis=-1))[0]
