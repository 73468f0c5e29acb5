r"""Local basis sets.

Each basis knows its DoF name(s), dimension ``nbas``, per-state quantum
numbers ``sigmaqn`` (shape ``(nbas, qn_size)``) and can evaluate the dense
matrix of any supported operator symbol via :meth:`BasisSet.op_mat`.

Numpy copy of ``renormalizer_tpu/model/basis.py``.  The supported symbol
tables follow the reference exactly — see ``renormalizer/model/basis.py``
(BasisSHO :110-339, BasisHopsBoson :342-384, BasisSineDVR :387-752,
BasisMultiElectron :755-810, BasisMultiElectronVac :813-879,
BasisSimpleElectron :882-929, BasisHalfSpin :932-996, BasisDummy
:999-1018).

These run on the host once at model-construction time; the resulting dense
matrices become MPO site tensors on the backend's device.
"""

import itertools
import logging
from typing import List, Union

import numpy as np
import scipy.linalg
import scipy.special

from renormalizer_tpu_torch.model.op import Op

logger = logging.getLogger(__name__)


class BasisSet:
    r"""Parent class for local basis sets.

    Args:
        dof: DoF name (any hashable) or list/tuple of names for multi-DoF bases.
        nbas (int): local dimension.
        sigmaqn (List): quantum number of each basis state; ints or tuples.
    """

    is_electron = False
    is_phonon = False
    is_spin = False
    multi_dof = False

    def __init__(self, dof, nbas: int, sigmaqn: List):
        self.dof = dof
        assert type(nbas) is int
        self.nbas = nbas
        qn_rows = [np.atleast_1d(np.array(qn)) for qn in sigmaqn]
        self.sigmaqn: np.ndarray = np.array(qn_rows)

    def __str__(self):
        ret = f"dof: {self.dof}, nbas: {self.nbas}"
        if not np.all(self.sigmaqn == 0):
            ret += f", qn: {self.sigmaqn.tolist()}"
        return f"{self.__class__.__name__}({ret})"

    __repr__ = __str__

    def op_mat(self, op: Union[Op, str]) -> np.ndarray:
        """Dense matrix of ``op`` in this basis, factor included."""
        raise NotImplementedError

    @property
    def dofs(self) -> tuple:
        """DoF names as a tuple, even for single-DoF bases."""
        if self.multi_dof:
            return tuple(self.dof)
        return (self.dof,)

    def copy(self, new_dof):
        raise NotImplementedError


# --- second-quantization ladder helpers ---------------------------------

def _lowering(n: int) -> np.ndarray:
    """<m| b |k> = sqrt(k) delta_{m,k-1}"""
    return np.diag(np.sqrt(np.arange(1, n)), k=1)


def _raising(n: int) -> np.ndarray:
    return _lowering(n).T


def x_power_k(k: int, m: int, n: int) -> float:
    r"""Analytic :math:`\langle m|x^k|n\rangle` for a unit-frequency SHO
    (origin 0).  Reference ``model/basis.py:1020-1043``."""
    assert type(k) is int and type(m) is int and type(n) is int
    if (m + n - k) % 2 == 1:
        return 0.0
    fact = scipy.special.factorial
    fact2 = scipy.special.factorial2
    pref = (
        2 ** (-k / 2)
        * np.sqrt(float(fact(m, exact=True)))
        * np.sqrt(float(fact(n, exact=True)))
    )
    total = 0.0
    for s in range(max(0, (m + n - k) // 2), min(m, n) + 1):
        total += (
            fact(k, exact=True)
            / fact(m - s, exact=True)
            / fact(s, exact=True)
            / fact(n - s, exact=True)
            / fact2(k - m - n + 2 * s, exact=True)
        )
    return pref * total


def p_power_k(k: int, m: int, n: int) -> complex:
    r""":math:`\langle m|p^k|n\rangle` for a unit-frequency SHO."""
    return x_power_k(k, m, n) * (1j) ** (m - n)


class BasisSHO(BasisSet):
    r"""Simple harmonic oscillator basis
    (reference ``model/basis.py:110-339``).

    Args:
        dof: DoF name.
        omega (float): oscillator frequency.
        nbas (int): number of Fock states.
        x0 (float): origin shift. Default 0.
        dvr (bool): discrete variable representation. Default False.
        general_xp_power (bool): compute x/p moments via the general analytic
            expression (testing only).
    """

    is_phonon = True

    def __init__(self, dof, omega, nbas, x0=0.0, dvr=False, general_xp_power=False):
        self.omega = omega
        self.x0 = x0
        super().__init__(dof, nbas, [0] * nbas)
        self.general_xp_power = general_xp_power
        self._depth = 0  # recursion depth for DVR basis rotation
        self.dvr = False
        self.dvr_x = None  # grid points (eigenvalues of x)
        self.dvr_v = None  # SHO -> DVR rotation
        if dvr:
            self.dvr_x, self.dvr_v = scipy.linalg.eigh(self.op_mat("x"))
            self.dvr = True

    def __str__(self):
        return (
            f"BasisSHO(dof: {self.dof}, x0: {self.x0}, omega: {self.omega}, "
            f"nbas: {self.nbas})"
        )

    def op_mat(self, op: Union[Op, str]):
        if not isinstance(op, Op):
            op = Op(op, None)
        sym = op.symbol.replace("partialx", "dx")
        sym = sym.replace(r"b^\dagger + b", r"b^\dagger+b")
        sym = sym.replace(r"b^\dagger - b", r"b^\dagger-b")

        second_quant_syms = (
            "b", "b b", r"b^\dagger", r"b^\dagger b^\dagger", r"b^\dagger b",
            r"b b^\dagger", r"b^\dagger+b",
        )
        if sym in second_quant_syms and self._depth == 0 and not np.allclose(self.x0, 0):
            logger.warning("the second quantization doesn't support nonzero x0")

        self._depth += 1
        try:
            mat = self._op_mat_body(sym)
        finally:
            self._depth -= 1
        return mat * op.factor

    def _op_mat_body(self, sym: str) -> np.ndarray:
        n = self.nbas
        omega = self.omega

        if sym == "I":
            return np.eye(n)
        if sym == "b":
            return _lowering(n)
        if sym == r"b^\dagger":
            return _raising(n)
        if sym == "b b":
            return _lowering(n) @ _lowering(n)
        if sym == r"b^\dagger b^\dagger":
            return _raising(n) @ _raising(n)
        if sym == r"b^\dagger+b":
            return _raising(n) + _lowering(n)
        if sym == r"b^\dagger-b":
            return _raising(n) - _lowering(n)
        if sym == r"b^\dagger b":
            return np.diag(np.arange(n, dtype=float))
        if sym == r"b b^\dagger":
            return np.diag(np.arange(n, dtype=float) + 1)
        if sym == "n":
            # occupation of the basis states; origin-shift-safe unlike b^dag b
            return np.diag(np.arange(n, dtype=float))

        if sym == "x" and not self.general_xp_power:
            if self.dvr:
                return np.diag(self.dvr_x)
            # x = y + x0, <m|y|n> = sqrt(1/2w) (b^dag + b)
            return np.sqrt(0.5 / omega) * self._op_mat_body(r"b^\dagger+b") + np.eye(n) * self.x0
        if sym == "x^2" and not self.general_xp_power:
            if self.dvr:
                return np.diag(self.dvr_x ** 2)
            # expand (y + x0)^2 with exact ladder matrices: squaring the
            # truncated x matrix is wrong near the highest Fock state
            y2 = (
                self._op_mat_body(r"b^\dagger b^\dagger")
                + self._op_mat_body(r"b^\dagger b")
                + self._op_mat_body(r"b b^\dagger")
                + self._op_mat_body("b b")
            ) * (0.5 / omega)
            y1 = 2 * self.x0 * np.sqrt(0.5 / omega) * self._op_mat_body(r"b^\dagger+b")
            return y2 + y1 + np.eye(n) * self.x0 ** 2

        parts = sym.split(" ")
        if set(parts) == {"x"}:
            return self._op_mat_body(f"x^{len(parts)}")
        if set(parts) == {"p"}:
            return self._op_mat_body(f"p^{len(parts)}")

        if parts[0].split("^")[0] == "x" and len(parts) == 1:
            # general x moment
            pieces = sym.split("^")
            moment = float(pieces[1]) if len(pieces) == 2 else 1
            if self.dvr:
                return np.diag(self.dvr_x ** moment)
            assert np.allclose(moment, round(moment))
            moment = round(moment)
            mat = np.zeros((n, n))
            # binomial expansion of (y + x0)^moment in analytic y moments
            for k in range(moment + 1):
                coeff = scipy.special.comb(moment, k) * np.sqrt(1 / omega) ** k
                for i, j in itertools.product(range(n), repeat=2):
                    mat[i, j] += coeff * x_power_k(k, i, j) * self.x0 ** (moment - k)
            return mat

        if sym == "p" and not self.general_xp_power:
            mat = 1j * np.sqrt(omega / 2) * (_raising(n) - _lowering(n))
            if self.dvr:
                mat = self.dvr_v.T @ mat @ self.dvr_v
            return mat
        if sym == "p^2" and not self.general_xp_power:
            mat = -omega / 2 * (
                self._op_mat_body(r"b^\dagger b^\dagger")
                - self._op_mat_body(r"b^\dagger b")
                - self._op_mat_body(r"b b^\dagger")
                + self._op_mat_body("b b")
            )
            if self.dvr:
                mat = self.dvr_v.T @ mat @ self.dvr_v
            return mat

        if parts[0].split("^")[0] == "p" and len(parts) == 1:
            pieces = sym.split("^")
            moment = float(pieces[1]) if len(pieces) == 2 else 1
            assert np.allclose(moment, round(moment))
            moment = round(moment)
            dtype = np.float64 if moment % 2 == 0 else np.complex128
            mat = np.zeros((n, n), dtype=dtype)
            for i, j in itertools.product(range(n), repeat=2):
                val = p_power_k(moment, i, j) * np.sqrt(omega) ** moment
                mat[i, j] = np.real(val) if moment % 2 == 0 else val
            if self.dvr:
                mat = self.dvr_v.T @ mat @ self.dvr_v
            return mat

        if sym == "x p":
            return -0.5j * (
                self._op_mat_body("b b")
                - self._op_mat_body(r"b^\dagger b^\dagger")
                + self._op_mat_body(r"b b^\dagger")
                - self._op_mat_body(r"b^\dagger b")
            )
        if sym == "p x":
            return -0.5j * (
                self._op_mat_body("b b")
                - self._op_mat_body(r"b^\dagger b^\dagger")
                - self._op_mat_body(r"b b^\dagger")
                + self._op_mat_body(r"b^\dagger b")
            )
        if sym == "x dx":
            return (self._op_mat_body("x p") / -1.0j).real
        if sym == "dx x":
            return (self._op_mat_body("p x") / -1.0j).real
        if sym == "dx":
            return (self._op_mat_body("p") / -1.0j).real
        if sym in ("dx^2", "dx dx"):
            return -self._op_mat_body("p^2")

        raise ValueError(f"op_symbol:{sym} is not supported. ")

    def copy(self, new_dof):
        return self.__class__(
            new_dof, omega=self.omega, nbas=self.nbas, x0=self.x0,
            dvr=self.dvr, general_xp_power=self.general_xp_power,
        )


class BasisHopsBoson(BasisSet):
    r"""Bosonic basis with HOPS ladder convention
    (reference ``model/basis.py:342-384``):

    .. math::
        \tilde{b}^\dagger |n\rangle = (n+1)|n+1\rangle, \quad
        \tilde{b} |n\rangle = |n-1\rangle
    """

    is_phonon = True

    def __init__(self, dof, nbas):
        super().__init__(dof, nbas, [0] * nbas)

    def op_mat(self, op: Union[Op, str]):
        if not isinstance(op, Op):
            op = Op(op, None)
        sym = op.symbol
        n = self.nbas
        if sym == r"b^\dagger b":
            mat = np.diag(np.arange(n, dtype=float))
        elif sym == r"\tilde{b}^\dagger":
            mat = np.diag(np.arange(1, n, dtype=float), k=-1)
        elif sym == r"\tilde{b}":
            mat = np.diag(np.ones(n - 1), k=1)
        elif sym == "I":
            mat = np.eye(n)
        else:
            raise ValueError(f"op_symbol:{sym} is not supported.")
        return mat * op.factor

    def copy(self, new_dof):
        return self.__class__(new_dof, self.nbas)


class BasisSineDVR(BasisSet):
    r"""Sine-DVR (particle-in-a-box) basis for vibrational / angular /
    dissociative modes.  Phys. Rep. 324, 1-105 (2000).
    Reference ``model/basis.py:387-752``.

    .. math::
        \psi_j(x) = \sqrt{2/L} \sin(j\pi(x-x_0)/L), \quad
        x_\alpha = x_0 + \alpha L/(N+1)

    Parameters
    ----------
    dof : hashable
    nbas : int
        number of grid points
    xi, xf : float
        leftmost and rightmost grid points
    endpoint : bool
        if False, ``x_0 = xi`` and ``x_{N+1} = xf``; else ``x_1 = xi``,
        ``x_N = xf``.
    """

    is_phonon = True

    def __init__(self, dof, nbas, xi, xf, endpoint=False, quadrature=False, dvr=False):
        assert xi < xf
        if endpoint:
            interval = (xf - xi) / (nbas - 1)
            xi -= interval
            xf += interval
        self.xi, self.xf = xi, xf
        self.L = xf - xi
        super().__init__(dof, nbas, [0] * nbas)
        self._depth = 0
        j = np.arange(1, nbas + 1)
        self.dvr_x = xi + j * self.L / (nbas + 1)
        self.dvr_v = np.sqrt(2 / (nbas + 1)) * np.sin(
            np.outer(j, j) * np.pi / (nbas + 1)
        )
        self.quadrature = quadrature
        self.dvr = dvr

    def __str__(self):
        return f"BasisSineDVR(xi: {self.xi}, xf: {self.xf}, nbas: {self.nbas})"

    # matrix elements over u = x - xi on [0, L]; all analytic.
    def _I(self):
        return np.eye(self.nbas)

    def _jk_grid(self):
        j = np.arange(1, self.nbas + 1)
        return np.meshgrid(j, j, indexing="ij")

    def _u(self):
        """<j|u|k>"""
        j, k = self._jk_grid()
        with np.errstate(divide="ignore", invalid="ignore"):
            a1 = (j + k) * np.pi / self.L
            a2 = (j - k) * np.pi / self.L
            odd = (j + k) % 2 == 1
            res = np.where(odd, -2 / a1 ** 2 + 2 / np.where(odd, a2, 1) ** 2, 0.0)
        res = np.where(j == k, -0.5 * self.L ** 2, res)
        return -res / self.L

    def _uu(self):
        """<j|u^2|k>"""
        j, k = self._jk_grid()
        with np.errstate(divide="ignore", invalid="ignore"):
            a1 = (j + k) * np.pi / self.L
            a2safe = np.where(j == k, 1.0, (j - k) * np.pi / self.L)
            odd = (j + k) % 2 == 1
            res = np.where(
                odd,
                2 * self.L * (-1 / a1 ** 2 + 1 / a2safe ** 2),
                2 * self.L * (1 / a1 ** 2 - 1 / a2safe ** 2),
            )
        res = np.where(j == k, 2 * self.L / a1 ** 2 - self.L ** 3 / 3, res)
        return -res / self.L

    def _uuu(self):
        """<j|u^3|k>"""
        j, k = self._jk_grid()
        with np.errstate(divide="ignore", invalid="ignore"):
            a1 = (j + k) * np.pi / self.L
            a2safe = np.where(j == k, 1.0, (j - k) * np.pi / self.L)
            odd = (j + k) % 2 == 1
            res = np.where(
                odd,
                -3 * self.L ** 2 / a1 ** 2 + 12 / a1 ** 4
                + 3 * self.L ** 2 / a2safe ** 2 - 12 / a2safe ** 4,
                3 * self.L ** 2 / a1 ** 2 - 3 * self.L ** 2 / a2safe ** 2,
            )
        res = np.where(j == k, 3 * self.L ** 2 / a1 ** 2 - self.L ** 4 / 4, res)
        return -res / self.L

    def _du(self):
        """<j|d/du|k> (antisymmetric)"""
        j, k = self._jk_grid()
        odd = (j + k) % 2 == 1
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = np.where(j == k, 1, j ** 2 - k ** 2)
            mat = np.where(odd, 4 * j * k / self.L / denom, 0.0)
        return mat

    def _udu(self):
        """<j|u d/du|k>"""
        j, k = self._jk_grid()
        with np.errstate(divide="ignore", invalid="ignore"):
            a1 = (j + k) * np.pi / self.L
            a2safe = np.where(j == k, 1.0, (j - k) * np.pi / self.L)
            odd = (j + k) % 2 == 1
            res = np.where(
                odd,
                self.L / a1 + self.L / a2safe,
                -self.L / a1 - self.L / a2safe,
            )
        res = np.where(j == k, -self.L / a1, res)
        return k * np.pi / self.L ** 2 * res

    def _uudu(self):
        """<j|u^2 d/du|k>"""
        j, k = self._jk_grid()
        with np.errstate(divide="ignore", invalid="ignore"):
            a1 = (j + k) * np.pi / self.L
            a2safe = np.where(j == k, 1.0, (j - k) * np.pi / self.L)
            odd = (j + k) % 2 == 1
            res = np.where(
                odd,
                -4 / a1 ** 3 + self.L ** 2 / a1 - 4 / a2safe ** 3 + self.L ** 2 / a2safe,
                -self.L ** 2 / a1 - self.L ** 2 / a2safe,
            )
        res = np.where(j == k, -self.L ** 2 / a1, res)
        return k * np.pi / self.L ** 2 * res

    def _eigene(self):
        """particle-in-box eigenenergies (unit mass)"""
        return np.pi ** 2 * np.arange(1, self.nbas + 1) ** 2 / self.L ** 2 / 2

    def op_mat(self, op: Union[Op, str]):
        if not isinstance(op, Op):
            op = Op(op, None)
        sym = op.symbol.replace("partialx", "dx")
        self._depth += 1
        try:
            mat = self._op_mat_body(sym)
        finally:
            self._depth -= 1
        if self.dvr and self._depth == 0:
            mat = self.dvr_v.T @ mat @ self.dvr_v
        return mat * op.factor

    def _op_mat_body(self, sym):
        xi = self.xi
        if sym == "I":
            return self._I()
        if sym in ("x", "x^1"):
            return self._I() * xi + self._u()
        if sym == "x^2":
            return self._I() * xi ** 2 + 2 * xi * self._u() + self._uu()
        if sym == "x^3":
            return (
                self._I() * xi ** 3 + 3 * xi ** 2 * self._u()
                + 3 * xi * self._uu() + self._uuu()
            )
        parts = sym.split(" ")
        if set(parts) == {"x"}:
            return self._op_mat_body(f"x^{len(parts)}")
        if sym == "dx":
            return self._du()
        if sym in ("dx^2", "dx dx"):
            return -self._op_mat_body("p^2")
        if sym == "p":
            return self._du() * -1.0j
        if sym == "p^2":
            return self._I() * (self._eigene() * 2)[None, :]
        if sym == "x dx":
            return self._du() * xi + self._udu()
        if sym == "x^2 dx":
            return self._uudu() + 2 * xi * self._udu() + xi ** 2 * self._du()
        if sym == "x^2 p^2":
            tmp = self._I() * xi ** 2 + 2 * xi * self._u() + self._uu()
            return tmp * (self._eigene() * 2)[None, :]
        if sym == "x^2 dx^2":
            return -self._op_mat_body("x^2 p^2")
        if sym == "x p^2":
            return (self._I() * xi + self._u()) * (self._eigene() * 2)[None, :]
        if sym == "x dx^2":
            return -self._op_mat_body("x p^2")
        if sym == "x^3 p^2":
            tmp = (
                self._I() * xi ** 3 + 3 * xi ** 2 * self._u()
                + 3 * xi * self._uu() + self._uuu()
            )
            return tmp * (self._eigene() * 2)[None, :]
        if sym == "x^3 dx^2":
            return -self._op_mat_body("x^3 p^2")

        # fall back to DVR-diagonal potentials or explicit quadrature
        logger.warning("Note that the quadrature part is not fully tested!")
        expr_sym = "*".join(sym.split())
        if "dx" not in expr_sym:
            if self.dvr:
                import sympy as sp

                x = sp.symbols("x")
                func = sp.lambdify(x, expr_sym.replace("^", "**"), "numpy")
                return self.dvr_v @ np.diag(func(self.dvr_x)) @ self.dvr_v.T
            if self.quadrature:
                return self.quad(expr_sym)
            raise ValueError(
                f"op_symbol:{expr_sym} is not supported. "
                "You can try dvr or explicit quadrature"
            )
        if self.quadrature:
            return self.quad(expr_sym)
        raise ValueError(
            f"op_symbol:{expr_sym} is not supported. You can try explicit quadrature"
        )

    @property
    def eigenfunc(self):
        return "sqrt(2/sL) * sin((sibas+1)*pi*(x-sxi)/sL)"

    def quad(self, expr):
        """Numerical quadrature <bra| expr |ket>, with d/dx factors applied
        symbolically (reference ``model/basis.py:624-651``)."""
        import sympy as sp
        import scipy.integrate

        x, sL, sxi, sibas, sjbas = sp.symbols("x sL sxi sibas sjbas")
        bra = self.eigenfunc
        ket = self.eigenfunc.replace("ibas", "jbas")
        pieces = "*".join((bra, expr, ket)).split("dx")
        pieces = [s.strip("*").replace("^", "**") for s in pieces]
        if len(pieces) == 1:
            sym_expr = sp.sympify(pieces[0])
        else:
            sym_expr = sp.sympify(pieces[-1])
            for s in pieces[::-1][1:]:
                sym_expr = sp.diff(sym_expr, x)
                if s != "":
                    sym_expr = sp.sympify(s) * sym_expr
        sym_expr = sym_expr.subs({sL: self.L, sxi: self.xi})
        func = sp.lambdify([x, sibas, sjbas], sym_expr, "numpy")
        mat = np.zeros((self.nbas, self.nbas))
        for i in range(self.nbas):
            for j in range(self.nbas):
                val, _ = scipy.integrate.quad(
                    lambda xx: func(xx, i, j), self.xi, self.xf
                )
                mat[i, j] = val
        return mat

    def copy(self, new_dof):
        return self.__class__(new_dof, self.nbas, xi=self.xi, xf=self.xf)


class BasisMultiElectron(BasisSet):
    r"""Multiple electronic states sharing one site
    (reference ``model/basis.py:755-810``).  Basis order follows ``dof``.
    """

    is_electron = True
    multi_dof = True

    def __init__(self, dof, sigmaqn: List):
        assert len(dof) == len(sigmaqn)
        self.dof_name_map = {name: i for i, name in enumerate(dof)}
        super().__init__(dof, len(dof), sigmaqn)

    def op_mat(self, op: Op):
        syms = op.split_symbol
        if len(syms) == 1:
            if syms[0] == "I":
                return np.eye(self.nbas) * op.factor
            if syms[0] in ("a", r"a^\dagger"):
                raise ValueError(
                    f"op_symbol:{syms} is not supported. Try use BasisMultiElectronVac."
                )
            raise ValueError(f"op_symbol:{syms} is not supported")
        if len(syms) == 2:
            if syms == ["I", "I"]:
                return np.eye(self.nbas) * op.factor
            i = self.dof_name_map[op.dofs[0]]
            j = self.dof_name_map[op.dofs[1]]
            mat = np.zeros((self.nbas, self.nbas))
            if syms[0] == r"a^\dagger" and syms[1] == "a":
                mat[int(i), int(j)] = 1.0
            elif syms[0] == "a" and syms[1] == r"a^\dagger":
                mat[int(j), int(i)] = 1.0
            else:
                raise ValueError(f"op_symbol:{syms} is not supported")
            return mat * op.factor
        raise ValueError(f"op_symbol:{syms} is not supported")

    def copy(self, new_dof):
        return self.__class__(new_dof, self.sigmaqn)


class BasisMultiElectronVac(BasisSet):
    r"""Multi-electron basis including the vacuum state at index 0
    (reference ``model/basis.py:813-879``).  sigmaqn is ``[0, 1, 1, ...]``.
    """

    is_electron = True
    multi_dof = True

    def __init__(self, dof):
        sigmaqn = [0] + [1] * len(dof)
        # index 0 reserved for vacuum
        self.dof_name_map = {name: i + 1 for i, name in enumerate(dof)}
        super().__init__(dof, len(dof) + 1, sigmaqn)

    def op_mat(self, op: Op):
        syms = op.split_symbol
        if len(syms) == 1:
            sym = syms[0]
            if sym == "I":
                return np.eye(self.nbas) * op.factor
            idx = self.dof_name_map[op.dofs[0]]
            mat = np.zeros((self.nbas, self.nbas))
            if sym == r"a^\dagger":
                mat[idx, 0] = 1.0
            elif sym == "a":
                mat[0, idx] = 1.0
            else:
                raise ValueError(f"op_symbol:{syms} is not supported")
            return mat * op.factor
        if len(syms) == 2:
            if syms == ["I", "I"]:
                return np.eye(self.nbas) * op.factor
            i = self.dof_name_map[op.dofs[0]]
            j = self.dof_name_map[op.dofs[1]]
            mat = np.zeros((self.nbas, self.nbas))
            if syms[0] == r"a^\dagger" and syms[1] == "a":
                mat[i, j] = 1.0
            elif syms[0] == "a" and syms[1] == r"a^\dagger":
                mat[j, i] = 1.0
            else:
                raise ValueError(f"op_symbol:{syms} is not supported")
            return mat * op.factor
        if syms.count("I") == len(syms):
            return np.eye(self.nbas) * op.factor
        raise ValueError(f"op_symbol:{syms} is not supported")

    def copy(self, new_dof):
        return self.__class__(new_dof)


class BasisSimpleElectron(BasisSet):
    r"""Two-state electron basis: 0 unoccupied, 1 occupied
    (reference ``model/basis.py:882-929``).

    Examples
    --------
    >>> b = BasisSimpleElectron(0)
    >>> b
    BasisSimpleElectron(dof: 0, nbas: 2, qn: [[0], [1]])
    >>> b.op_mat(r"a^\dagger")
    array([[0., 0.],
           [1., 0.]])
    """

    is_electron = True

    def __init__(self, dof, sigmaqn=None):
        if sigmaqn is None:
            sigmaqn = [0, 1]
        super().__init__(dof, 2, sigmaqn)

    def op_mat(self, op):
        if not isinstance(op, Op):
            op = Op(op, None)
        sym = op.symbol
        mat = np.zeros((2, 2))
        if sym == r"a^\dagger":
            mat[1, 0] = 1.0
        elif sym == "a":
            mat[0, 1] = 1.0
        elif sym == r"a^\dagger a":
            mat[1, 1] = 1.0
        elif sym == "I":
            mat = np.eye(2)
        else:
            raise ValueError(f"op_symbol:{sym} is not supported")
        return mat * op.factor

    def copy(self, new_dof):
        return self.__class__(new_dof)


_HALF_SPIN_MATS = {
    "I": np.eye(2),
    "sigma_x": np.array([[0.0, 1.0], [1.0, 0.0]]),
    "sigma_y": np.array([[0.0, -1.0j], [1.0j, 0.0]]),
    "isigma_y": np.array([[0.0, 1.0], [-1.0, 0.0]]),
    "sigma_z": np.array([[1.0, 0.0], [0.0, -1.0]]),
    "sigma_-": np.array([[0.0, 0.0], [1.0, 0.0]]),
    "sigma_+": np.array([[0.0, 1.0], [0.0, 0.0]]),
}
_HALF_SPIN_ALIASES = {
    "X": "sigma_x", "x": "sigma_x",
    "Y": "sigma_y", "y": "sigma_y",
    "iY": "isigma_y", "iy": "isigma_y",
    "Z": "sigma_z", "z": "sigma_z",
    "-": "sigma_-", "+": "sigma_+",
}


class BasisHalfSpin(BasisSet):
    r"""Spin-1/2 basis (reference ``model/basis.py:932-996``).

    Examples
    --------
    >>> b = BasisHalfSpin(0)
    >>> b
    BasisHalfSpin(dof: 0, nbas: 2)
    >>> b.op_mat("X")
    array([[0., 1.],
           [1., 0.]])
    >>> -1 * b.op_mat("iY") @ b.op_mat("iY")  # convenient for real Hamiltonian
    array([[1., 0.],
           [0., 1.]])
    """

    is_spin = True

    def __init__(self, dof, sigmaqn: List = None):
        if sigmaqn is None:
            sigmaqn = [0, 0]
        super().__init__(dof, 2, sigmaqn)

    def op_mat(self, op: Union[Op, str]):
        if not isinstance(op, Op):
            op = Op(op, None)
        mat = np.eye(2)
        for sym in op.split_symbol:
            canonical = _HALF_SPIN_ALIASES.get(sym, sym)
            if canonical not in _HALF_SPIN_MATS:
                raise ValueError(f"op_symbol:{sym} is not supported")
            factor_mat = _HALF_SPIN_MATS[canonical]
            mat = mat @ factor_mat
        if np.allclose(mat.imag, 0):
            mat = mat.real
        return mat * op.factor

    def copy(self, new_dof):
        return self.__class__(new_dof, self.sigmaqn)


class BasisDummy(BasisSet):
    """Placeholder basis supporting only the identity
    (reference ``model/basis.py:999-1018``)."""

    def __init__(self, dof, nbas=1, sigmaqn: List = None):
        if sigmaqn is None:
            sigmaqn = [0] * nbas
        super().__init__(dof, nbas, sigmaqn)

    def op_mat(self, op: Union[Op, str]):
        if not isinstance(op, Op):
            op = Op(op, None)
        if op.split_symbol == ["I"]:
            return np.eye(1) * op.factor
        raise ValueError(f"op_symbol:{op.split_symbol} is not supported")

    def copy(self, new_dof):
        return self.__class__(new_dof, self.nbas, self.sigmaqn)
