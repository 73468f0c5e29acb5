"""The 4-mode pyrazine S1/S2 vibronic model, the one check of the package
against an external code (the Heidelberg MCTDH package).

Copy of ``tests/test_pyr4.py:32-91`` for the port: the bilinear vibronic
coupling model of Raab, Worth, Meyer, Cederbaum, J. Chem. Phys. 110, 936
(1999).  Propagated for 120 fs from S2 it must reproduce the S1/S2
populations of ``tests/data/pyr4_mctdh.npy`` (columns t/fs, occ(S1),
occ(S2), every 0.5 fs) to 2e-2.
"""

import numpy as np

from renormalizer_tpu_torch.model.basis import BasisSHO, BasisSimpleElectron
from renormalizer_tpu_torch.model.model import Model
from renormalizer_tpu_torch.model.op import Op
from renormalizer_tpu_torch.utils.constant import ev2au

# --- model parameters (eV), MCTDH pyr4+.op via Raab et al. table I ---------
FREQ = {"10a": 0.1139, "6a": 0.0739, "9a": 0.1525, "1": 0.1258}
DELTA = 0.42300
# state-diagonal linear couplings kappa_v^(s)
KAPPA = {
    "s1": {"6a": 0.09806, "1": 0.05033, "9a": 0.14521},
    "s2": {"6a": -0.13545, "1": 0.17100, "9a": 0.03746},
}
# state-diagonal quadratic coupling (only 10a is active)
GAMMA = {"s1": {"10a": -0.01159}, "s2": {"10a": -0.01159}}
# state-diagonal bilinear couplings; the Hamiltonian contains BOTH
# orderings x_a x_b and x_b x_a, i.e. an effective 2c (reference term
# enumeration, ``test_pyr4.py:94-109``)
BILINEAR = {
    "s1": {("6a", "1"): 0.00108, ("1", "9a"): -0.00474, ("6a", "9a"): 0.00204},
    "s2": {("6a", "1"): -0.00298, ("1", "9a"): -0.00155, ("6a", "9a"): 0.00189},
}
# S1<->S2 couplings through the coupling mode 10a
LAMBDA = 0.20804
BILINEAR_OFFDIAG = {("1", "10a"): 0.00553, ("6a", "10a"): 0.01000,
                    ("9a", "10a"): 0.00126}

E_DOFS = ["s1", "s2"]
V_DOFS = ["10a", "6a", "9a", "1"]


def pyrazine_model(nbas: int = 30) -> Model:
    """S0->S1/S2 pyrazine model in mass-frequency-scaled coordinates: the
    MCTDH couplings multiply dimensionless normal coordinates
    ``Q = sqrt(w) x``, hence the ``sqrt(w)`` factors on every x power."""
    w = {v: FREQ[v] * ev2au for v in V_DOFS}
    terms = []
    # electronic gap (reference convention: -delta on S1, +delta on S2)
    terms.append(Op(r"a^\dagger a", "s1", -DELTA * ev2au, [0, 0]))
    terms.append(Op(r"a^\dagger a", "s2", DELTA * ev2au, [0, 0]))
    # harmonic modes
    for v in V_DOFS:
        terms.append(Op("p^2", v, 0.5))
        terms.append(Op("x^2", v, 0.5 * w[v] ** 2))
    for s in E_DOFS:
        n_s = Op(r"a^\dagger a", [s, s])
        for v, k in KAPPA[s].items():
            terms.append(n_s * Op("x", v) * (k * ev2au * np.sqrt(w[v])))
        for v, g in GAMMA[s].items():
            terms.append(n_s * Op("x^2", v) * (g * ev2au * w[v]))
        for (va, vb), c in BILINEAR[s].items():
            terms.append(
                n_s * Op("x", va) * Op("x", vb)
                * (2 * c * ev2au * np.sqrt(w[va] * w[vb]))
            )
    for (si, sj) in (("s1", "s2"), ("s2", "s1")):
        hop = Op(r"a^\dagger a", [si, sj])
        terms.append(hop * Op("x", "10a") * (LAMBDA * ev2au * np.sqrt(w["10a"])))
        for (va, vb), c in BILINEAR_OFFDIAG.items():
            terms.append(
                hop * Op("x", va) * Op("x", vb)
                * (2 * c * ev2au * np.sqrt(w[va] * w[vb]))
            )
    basis = [BasisSimpleElectron(s) for s in E_DOFS]
    basis += [BasisSHO(v, w[v], nbas) for v in V_DOFS]
    return Model(basis, terms)
