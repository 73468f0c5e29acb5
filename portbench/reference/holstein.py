"""The Holstein chain's Hamiltonian as a list of local product terms.

    H = sum_i (e + lambda) n_i + J sum_<ij> c_i^+ c_j
        + sum_{i,l} w_l (b^+ b + 1/2)_{il}
        - sum_{i,l} w_l^2 d_l n_i x_{il},      x = (b + b^+) / sqrt(2 w_l)

with lambda = sum_l w_l^2 d_l^2 / 2 the reorganization energy (Holstein
1959; the upstream project's ``HolsteinModel``).  One electron at most per
molecule (a two-state site), phonons truncated to ``levels`` Fock states;
``x`` is the truncated ladder sum and the oscillator term is exactly
diagonal.  Sites run molecule by molecule: the electron, then its modes.
A site's label is the molecule's index for the electron and
``(molecule, mode)`` for a phonon.
"""

import numpy as np

# CODATA 2022: the Hartree energy in eV and in cm^-1
HARTREE_EV = 27.211386245981
HARTREE_CM = 219474.63136314


def _phonon_ops(omega, levels):
    b = np.diag(np.sqrt(np.arange(1, levels, dtype=float)), k=1)
    h0 = np.diag(omega * (np.arange(levels, dtype=float) + 0.5))
    x = (b + b.T) / np.sqrt(2.0 * omega)
    return h0, x


def chain(model: dict):
    """``(sites, terms)`` of a configuration's Holstein chain: ``sites`` the
    chain's ``(label, dim)`` in order, ``terms`` a list of ``(coefficient,
    {label: matrix})``."""
    if model["model"] != "holstein_chain":
        raise ValueError(f"unknown model {model['model']!r}")
    n_mol = int(model["n_mol"])
    eps = model["elocalex_ev"] / HARTREE_EV
    j = model["j_ev"] / HARTREE_EV
    modes = [(m["omega_cm"] / HARTREE_CM, float(m["displacement_au"]), int(m["levels"]))
             for m in model["modes"]]
    lam = sum(0.5 * w * w * d * d for w, d, _ in modes)
    n_op = np.diag([0.0, 1.0])
    up = np.array([[0.0, 0.0], [1.0, 0.0]])
    down = up.T.copy()
    sites, terms = [], []
    for i in range(n_mol):
        sites.append((i, 2))
        terms.append((eps + lam, {i: n_op}))
        for lm, (w, d, levels) in enumerate(modes):
            sites.append(((i, lm), levels))
            h0, x = _phonon_ops(w, levels)
            terms.append((1.0, {(i, lm): h0}))
            terms.append((-w * w * d, {i: n_op, (i, lm): x}))
    if model.get("periodic", False):
        raise ValueError("the reference builds open chains only")
    for a, b in [(i, i + 1) for i in range(n_mol - 1)]:
        terms.append((j, {a: up, b: down}))
        terms.append((j, {b: up, a: down}))
    return sites, terms



def electron_number(model: dict):
    """The terms of the electron number operator, sum_i n_i."""
    n_op = np.diag([0.0, 1.0])
    return [(1.0, {i: n_op}) for i in range(int(model["n_mol"]))]
