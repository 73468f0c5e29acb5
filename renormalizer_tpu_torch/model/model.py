r"""Model classes binding basis sets and sum-of-product Hamiltonians.

Numpy copy of ``renormalizer_tpu/model/model.py`` holding ``Model``,
``HolsteinModel``, ``SpinBosonModel`` and ``TI1DModel``.
"""

import logging
from collections import Counter
from typing import Callable, Dict, List, Union

import numpy as np

from renormalizer_tpu_torch.model.basis import (
    BasisSet,
    BasisHalfSpin,
    BasisSHO,
    BasisSimpleElectron,
    BasisMultiElectronVac,
)
from renormalizer_tpu_torch.model.mol import Mol
from renormalizer_tpu_torch.model.op import Op, OpSum
from renormalizer_tpu_torch.model.phonon import Phonon
from renormalizer_tpu_torch.utils import Quantity, cached_property

logger = logging.getLogger(__name__)


class Model:
    r"""General sum-of-product Hamiltonian model
    (reference ``model/model.py:18-228``).

    Parameters
    ----------
    basis : list of :class:`BasisSet`
        Local bases, in MPS site order.
    ham_terms : list of :class:`Op`
        Hamiltonian terms.  All terms must be given explicitly (no implicit
        Hermitian completion).
    dipole : dict
        Transition dipoles keyed by DoF name.
    output_ordering : list of :class:`BasisSet`
        Basis ordering used for outputs; defaults to ``basis``.
    """

    def __init__(
        self,
        basis: List[BasisSet],
        ham_terms: List[Op],
        dipole: Dict = None,
        output_ordering: List[BasisSet] = None,
    ):
        if not isinstance(basis, list) or len(basis) == 0:
            raise TypeError("Basis should be a non-empty list")
        if not isinstance(basis[0], BasisSet):
            raise TypeError("Elements of the basis list should be of type BasisSet")
        all_dofs = [d for b in basis for d in b.dofs]
        if len(all_dofs) != len(set(all_dofs)):
            dup = [k for k, v in Counter(all_dofs).items() if v > 1]
            raise ValueError(f"Duplicate DoF definition found in the basis list: {dup}")
        self.basis: List[BasisSet] = basis

        qn_sizes = {b.sigmaqn.shape[1] for b in basis}
        if len(qn_sizes) != 1:
            raise ValueError(f"Inconsistent quantum number size: {qn_sizes}")
        self.qn_size: int = qn_sizes.pop()

        self.output_ordering = output_ordering if output_ordering is not None else basis

        # alias maps: DoF name -> site index / basis
        self.dof_to_siteidx = self.order = {}
        self.dof_to_basis = {}
        for siteidx, b in enumerate(basis):
            for dof in b.dofs:
                self.dof_to_siteidx[dof] = siteidx
                self.dof_to_basis[dof] = b

        self.ham_terms: List[Op] = self.check_operator_terms(ham_terms)
        self.dipole = dipole
        # cache of reusable MPOs keyed by name
        self.mpos = dict()
        self.pbond_list = [b.nbas for b in self.basis]

    def check_operator_terms(self, terms: List[Op]) -> List[Op]:
        """Ravel OpSum entries, verify DoF names, drop zero-factor terms
        (reference ``model.py:78-118``)."""
        flat = []
        for term in terms:
            if isinstance(term, OpSum):
                flat.extend(term)
            elif isinstance(term, Op):
                flat.append(term)
            else:
                raise ValueError(
                    f"Expected Op in terms. Got {type(term)}. Str: {term}"
                )
        dofs = set(self.dofs)
        checked = []
        for term in flat:
            for name in term.dofs:
                if name not in dofs:
                    raise ValueError(f"{term} contains DoF not in the basis.")
            if term.factor == 0:
                continue
            checked.append(term)
        return checked

    def _enumerate_dof(self, criteria=lambda b: True) -> List:
        return [d for b in self.output_ordering if criteria(b) for d in b.dofs]

    @cached_property
    def dofs(self) -> List:
        return self._enumerate_dof()

    @cached_property
    def nsite(self) -> int:
        return len(self.basis)

    @cached_property
    def e_dofs(self) -> List:
        return self._enumerate_dof(lambda b: b.is_electron)

    @cached_property
    def v_dofs(self) -> List:
        return self._enumerate_dof(lambda b: b.is_phonon)

    @cached_property
    def n_dofs(self) -> int:
        return len(self.dofs)

    @cached_property
    def n_edofs(self) -> int:
        return len(self.e_dofs)

    @cached_property
    def n_vdofs(self) -> int:
        return len(self.v_dofs)

    def get_mpos(self, key: str, fun: Callable):
        """Build-once cache for model-derived MPOs
        (reference ``model.py:178-204``)."""
        if key not in self.mpos:
            self.mpos[key] = fun(self)
        return self.mpos[key]

    def copy(self):
        model = Model(self.basis.copy(), self.ham_terms, self.dipole, self.output_ordering)
        model.mpos = self.mpos.copy()
        return model

    def to_dict(self) -> Dict:
        return {
            "Hamiltonian": [op.to_tuple() for op in self.ham_terms],
            "dipole": self.dipole,
        }


def construct_j_matrix(mol_num: int, j_constant: Quantity, periodic: bool) -> np.ndarray:
    """Nearest-neighbour homogeneous J matrix."""
    j_au = j_constant.as_au()
    j = np.diag(np.full(mol_num - 1, j_au), k=-1) + np.diag(
        np.full(mol_num - 1, j_au), k=1
    )
    if periodic:
        j[-1, 0] = j[0, -1] = j_au
    return j


class HolsteinModel(Model):
    r"""Holstein Hamiltonian (reference ``model/model.py:231-407``).

    .. math::
        \hat H = \sum_{ij} J_{ij} a^\dagger_i a_j
        + \sum_{i\lambda} \omega_{i\lambda} b^\dagger_{i\lambda} b_{i\lambda}
        + \sum_{i\lambda} g_{i\lambda}\omega_{i\lambda} a^\dagger_i a_i
          (b^\dagger_{i\lambda} + b_{i\lambda})

    Schemes 1-3: bases interleaved as ``[e0, ph00, ph01, ..., e1, ...]``.
    Scheme 4: all electronic DoF merged into one central
    :class:`BasisMultiElectronVac` site.
    """

    def __init__(
        self,
        mol_list: List[Mol],
        j_matrix: Union[Quantity, np.ndarray],
        scheme: int = 2,
        periodic: bool = False,
    ):
        mol_num = len(mol_list)
        self.mol_list = mol_list

        if isinstance(j_matrix, Quantity):
            j_matrix = construct_j_matrix(mol_num, j_matrix, periodic)
        else:
            if periodic:
                assert j_matrix[0][-1] != 0 and j_matrix[-1][0] != 0
            assert j_matrix.shape[0] == mol_num
        self.j_matrix = j_matrix
        self.scheme = scheme

        basis = []
        if scheme < 4:
            for imol, mol in enumerate(mol_list):
                basis.append(BasisSimpleElectron(imol))
                for iph, ph in enumerate(mol.ph_list):
                    basis.append(BasisSHO((imol, iph), ph.omega[0], ph.n_phys_dim))
        elif scheme == 4:
            n_left_mol = mol_num // 2
            n_left_ph = 0
            for imol, mol in enumerate(mol_list):
                for iph, ph in enumerate(mol.ph_list):
                    if imol < n_left_mol:
                        n_left_ph += 1
                    basis.append(BasisSHO((imol, iph), ph.omega[0], ph.n_phys_dim))
            basis.insert(n_left_ph, BasisMultiElectronVac(list(range(mol_num))))
        else:
            raise ValueError(f"invalid model.scheme: {scheme}")

        ham = []
        # electronic part
        for imol in range(mol_num):
            for jmol in range(mol_num):
                if imol == jmol:
                    factor = mol_list[imol].elocalex + mol_list[imol].e0
                else:
                    factor = j_matrix[imol, jmol]
                ham.append(Op(r"a^\dagger a", [imol, jmol], factor))
        # harmonic part
        for imol, mol in enumerate(mol_list):
            for iph, ph in enumerate(mol.ph_list):
                ham.append(Op("p^2", (imol, iph), 0.5))
                ham.append(Op("x^2", (imol, iph), 0.5 * ph.omega[0] ** 2))
        # e-ph coupling (linear, plus quadratic if omegas differ)
        for imol, mol in enumerate(mol_list):
            for iph, ph in enumerate(mol.ph_list):
                if np.allclose(ph.omega[0], ph.omega[1]):
                    ham.append(
                        Op(r"a^\dagger a", imol)
                        * Op("x", (imol, iph))
                        * (-ph.omega[1] ** 2 * ph.dis[1])
                    )
                else:
                    ham.append(
                        Op(r"a^\dagger a", imol)
                        * Op("x^2", (imol, iph))
                        * (0.5 * (ph.omega[1] ** 2 - ph.omega[0] ** 2))
                    )
                    ham.append(
                        Op(r"a^\dagger a", imol)
                        * Op("x", (imol, iph))
                        * (-ph.omega[1] ** 2 * ph.dis[1])
                    )

        dipole = {imol: mol.dipole for imol, mol in enumerate(mol_list)}
        super().__init__(basis, ham, dipole=dipole)
        self.mol_num = self.n_edofs

    def switch_scheme(self, scheme: int) -> "HolsteinModel":
        return HolsteinModel(self.mol_list, self.j_matrix, scheme)

    @property
    def gs_zpe(self) -> float:
        return sum(mol.gs_zpe for mol in self.mol_list)

    @property
    def j_constant(self):
        """Extract a constant J from ``j_matrix``; raise if non-constant."""
        j_set = set(self.j_matrix.ravel())
        if len(j_set) == 1:
            return j_set.pop()
        if len(j_set) == 2 and 0 in j_set:
            j_set.remove(0)
            return j_set.pop()
        raise ValueError("J is not constant")

    def copy(self):
        model = HolsteinModel(self.mol_list, self.j_matrix, self.scheme)
        model.mpos = self.mpos.copy()
        return model

    def __getitem__(self, item):
        return self.mol_list[item]

    def __iter__(self):
        return iter(self.mol_list)

    def __len__(self):
        return len(self.mol_list)


class SpinBosonModel(Model):
    r"""Spin-Boson model (reference ``model/model.py:410-439``):

    .. math::
        \hat H = \epsilon\sigma_z + \Delta\sigma_x
            + \frac12\sum_i (p_i^2 + \omega_i^2 q_i^2)
            + \sigma_z \sum_i c_i q_i
    """

    def __init__(
        self,
        epsilon: Quantity,
        delta: Quantity,
        ph_list: List[Phonon],
        dipole: float = None,
    ):
        self.epsilon = epsilon.as_au()
        self.delta = delta.as_au()
        self.ph_list = ph_list

        basis = [BasisHalfSpin("spin")]
        for iph, ph in enumerate(ph_list):
            basis.append(BasisSHO(iph, ph.omega[0], ph.n_phys_dim))

        ham = [Op("sigma_z", "spin", self.epsilon), Op("sigma_x", "spin", self.delta)]
        for iph, ph in enumerate(ph_list):
            assert ph.is_simple
            ham.append(Op("p^2", iph, 0.5))
            ham.append(Op("x^2", iph, 0.5 * ph.omega[0] ** 2))
            ham.append(
                Op("sigma_z", "spin") * Op("x", iph) * (-ph.omega[1] ** 2 * ph.dis[1])
            )
        super().__init__(basis, ham, dipole={"spin": dipole if dipole is not None else 0})


class TI1DModel(Model):
    r"""Translationally invariant 1D model with PBC
    (reference ``model/model.py:442-510``).

    Unit-cell DoF names become ``("cell{i}", dof)``.  Nonlocal term DoFs are
    ``(distance, dof)`` pairs resolved modulo ``ncell``.
    """

    def __init__(
        self,
        basis: List[BasisSet],
        local_ham_terms: List[Op],
        nonlocal_ham_terms: List[Op],
        ncell: int,
    ):
        full_basis = []
        for i in range(ncell):
            for local_basis in basis:
                new_dofs = [(f"cell{i}", dof) for dof in local_basis.dofs]
                if local_basis.multi_dof:
                    full_basis.append(local_basis.copy(new_dofs))
                else:
                    full_basis.append(local_basis.copy(new_dofs[0]))

        full_ham = []
        for i in range(ncell):
            for op in local_ham_terms:
                new_dofs = [(f"cell{i}", dof) for dof in op.dofs]
                full_ham.append(Op(op.symbol, new_dofs, op.factor, op.qn_list))
            for op in nonlocal_ham_terms:
                new_dofs = []
                for old_dof in op.dofs:
                    assert (
                        isinstance(old_dof, tuple)
                        and len(old_dof) == 2
                        and isinstance(old_dof[0], int)
                    )
                    cell_id = (i + old_dof[0]) % ncell
                    new_dofs.append((f"cell{cell_id}", old_dof[1]))
                full_ham.append(Op(op.symbol, new_dofs, op.factor, op.qn_list))
        super().__init__(full_basis, full_ham)
