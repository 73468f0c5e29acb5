r"""Symbolic operators: :class:`Op` and :class:`OpSum`.

Semantics follow the reference (``renormalizer/model/op.py:11-528``):

* An ``Op`` is an immutable product of *simple symbols* separated by single
  spaces (e.g. ``r"a^\dagger a"``), each carrying a DoF name and a quantum
  number vector; plus a scalar factor.
* ``r"b^\dagger + b"`` counts as one simple symbol (normalized to
  ``r"b^\dagger+b"``) since the algebra is multiplication-centric.
* Default quantum numbers (when ``qn=None``): +1 for ``a^\dagger``, -1 for
  ``a``, 0 otherwise (reference ``op.py:160-170``).
* Addition yields an :class:`OpSum` (a ``list`` subclass).
"""

from collections import defaultdict
from itertools import chain
from typing import Dict, List, Tuple, Union

import numpy as np

from renormalizer_tpu_torch.utils import Quantity

# plus-connected composites treated as single simple symbols
_PLUS_ALIASES = [(r"b^\dagger + b", r"b^\dagger+b"), (r"b^\dagger - b", r"b^\dagger-b")]


def _normalize_symbol(symbol: str) -> str:
    for src, dst in _PLUS_ALIASES:
        symbol = symbol.replace(src, dst)
    return symbol


class Op:
    r"""Immutable symbolic operator.

    Parameters
    ----------
    symbol : str
        Space-separated simple symbols, e.g. ``"X"`` or ``r"a^\dagger a"``.
    dof :
        A hashable DoF name (shared by all simple symbols) or a ``list`` of
        DoF names, one per simple symbol.  Use a list (not tuple!) for
        per-symbol DoFs: tuples are themselves valid single DoF names.
    factor : float, complex or Quantity
        Scalar prefactor.
    qn :
        Quantum number per simple symbol: an int (single symbol), a list of
        ints, or a list of int containers for multiple quantum numbers.

    Examples
    --------
    >>> from renormalizer_tpu_torch.model import Op
    >>> Op(r"a^\dagger a", ['site0', "site1"], 2., qn=[1, -1])
    Op('a^\\dagger a', ['site0', 'site1'], 2.0, [[1], [-1]])
    >>> x = Op("X", 0, 0.5)
    >>> 3 * x
    Op('X', [0], 1.5)
    >>> y = Op("Y", 1, 0.2)
    >>> x * y
    Op('X Y', [0, 1], 0.1)
    >>> (x + y) * x
    [Op('X X', [0, 0], 0.25), Op('Y X', [1, 0], 0.1)]
    """

    def __init__(self, symbol: str, dof, factor: Union[float, complex, Quantity] = 1.0,
                 qn: Union[List, int] = None):
        if not isinstance(symbol, str):
            raise TypeError(f"symbol should be a str. Got {symbol} as {type(symbol)}")
        self.symbol: str = symbol
        self.split_symbol: List[str] = _normalize_symbol(symbol).split(" ")
        nsym = len(self.split_symbol)

        # normalize DoF names to one list entry per simple symbol
        if isinstance(dof, list):
            if len(dof) != nsym:
                raise ValueError(
                    f"symbol and DoF name length mismatch: {symbol} vs {dof}"
                )
            dofs = list(dof)
        else:
            dofs = [dof] * nsym
        for d in dofs:
            if d.__hash__ is None:
                raise ValueError(f"dof name should be hashable. Got {d}.")
        self.dofs: List = dofs

        # normalize quantum numbers
        if qn is None:
            qn_list = []
            for s in self.split_symbol:
                if s == r"a^\dagger":
                    qn_list.append(1)
                elif s == "a":
                    qn_list.append(-1)
                else:
                    qn_list.append(0)
        elif isinstance(qn, list):
            if len(qn) != nsym:
                raise ValueError(
                    f"Incompatible sizes of quantum number {qn} and symbol "
                    f"{self.split_symbol}"
                )
            qn_list = qn
        else:
            if nsym != 1:
                raise ValueError("qn should be a list for complex symbols.")
            qn_list = [qn]
        self.qn_list: List[np.ndarray] = [np.atleast_1d(np.array(q)) for q in qn_list]

        if isinstance(factor, Quantity):
            factor = factor.as_au()
        # "+ 0.0" promotes ints to float and keeps complex intact
        self._factor = factor + 0.0

    # --- constructors ---------------------------------------------------
    @classmethod
    def product(cls, op_list: List["Op"]) -> "Op":
        """Product of several operators (reference ``op.py:79-97``)."""
        symbol = " ".join(op.symbol for op in op_list)
        dofs = list(chain.from_iterable(op.dofs for op in op_list))
        factor = np.prod([op.factor for op in op_list])
        qn = list(chain.from_iterable(op.qn_list for op in op_list))
        return cls(symbol, dofs, factor, qn)

    @classmethod
    def identity(cls, dof, qn_size: int = 1, factor=1.0) -> "Op":
        if isinstance(dof, list):
            qn = [np.zeros(qn_size, dtype=int)] * len(dof)
            return cls(" ".join(["I"] * len(dof)), dof, factor=factor, qn=qn)
        return cls("I", dof, factor=factor, qn=[np.zeros(qn_size, dtype=int)])

    # --- properties -----------------------------------------------------
    @property
    def factor(self):
        return self._factor

    @property
    def qn(self) -> np.ndarray:
        """Total quantum number: sum over ``qn_list``."""
        return sum(self.qn_list)

    @property
    def qn_size(self) -> int:
        return len(self.qn)

    @property
    def is_identity(self) -> bool:
        return set(self.split_symbol) == {"I"}

    # --- transformations --------------------------------------------------
    def split_elementary(self, dof_to_siteidx: Dict) -> Tuple[List["Op"], Union[float, complex]]:
        """Group the simple symbols by site index into elementary operators
        with unit factor (reference ``op.py:185-228``).

        Examples
        --------
        >>> from renormalizer_tpu_torch.model import Op
        >>> op = Op("X Y", [3, 2], 0.5) * Op("Y X", [2, 3], 3.0) * Op("Z Z", [2, 2], 1.0)
        >>> ops, factor = op.split_elementary({2:0, 3:1})
        >>> ops, float(factor)
        ([Op('Y Y Z Z', [2, 2, 2, 2], 1.0), Op('X X', [3, 3], 1.0)], 1.5)
        """
        if len(self.dofs) == 1:
            return [Op(self.symbol, self.dofs, qn=self.qn_list)], self.factor
        grouped: Dict[int, List[Op]] = defaultdict(list)
        for sym, dof, qn in zip(self.split_symbol, self.dofs, self.qn_list):
            site_idx = dof_to_siteidx.get(dof)
            if site_idx is None:
                raise ValueError(f"Unknown DoF name {dof} in {self}.")
            grouped[site_idx].append(Op(sym, dof, qn=qn))
        ops = [Op.product(grouped[i]) for i in sorted(grouped.keys())]
        return ops, self.factor

    def squeeze_identity(self) -> "Op":
        """Drop identity simple symbols (reference ``op.py:261-292``).

        Examples
        --------
        >>> from renormalizer_tpu_torch.model import Op
        >>> Op("X I Y I", [0, 1, 2, 3], 0.5).squeeze_identity()
        Op('X Y', [0, 2], 0.5)
        >>> Op("I", 0, -0.5).squeeze_identity()
        Op('I', [0], -0.5)
        """
        if self.is_identity:
            return Op.identity(self.dofs[0], factor=self.factor, qn_size=self.qn_size)
        keep = [
            (s, d, q)
            for s, d, q in zip(self.split_symbol, self.dofs, self.qn_list)
            if s != "I"
        ]
        return Op(
            " ".join(s for s, _, _ in keep),
            [d for _, d, _ in keep],
            self.factor,
            [q for _, _, q in keep],
        )

    def same_term(self, other: "Op") -> bool:
        """Whether two operators differ only by their factor."""
        return self.symbol == other.symbol and self.dofs == other.dofs

    def to_tuple(self) -> Tuple:
        """Hashable representation (reference ``op.py:321-331``)."""
        return (
            self.symbol,
            tuple(self.dofs),
            self.factor,
            tuple(tuple(q) for q in self.qn_list),
        )

    # --- dunder ---------------------------------------------------------
    def __hash__(self):
        return hash(self.to_tuple())

    def __eq__(self, other):
        return isinstance(other, Op) and self.to_tuple() == other.to_tuple()

    def __str__(self):
        body = ", ".join([repr(self.symbol), str(self.dofs), str(self.factor)])
        if not np.all(np.array(self.qn_list, dtype=object) == 0):
            body += f", {[q.tolist() for q in self.qn_list]}"
        return f"Op({body})"

    __repr__ = __str__

    def __neg__(self):
        return Op(self.symbol, self.dofs, -self.factor, self.qn_list)

    def __add__(self, other):
        if _is_zero_scalar(other):
            return OpSum([self])
        if isinstance(other, Op):
            return OpSum([self, other])
        if isinstance(other, list):
            return OpSum([self] + other)
        raise TypeError(f"Unknown operand type {type(other)}")

    def __radd__(self, other):
        if _is_zero_scalar(other):
            return OpSum([self])
        raise TypeError(f"Unknown operand type {type(other)}")

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        if isinstance(other, np.generic):
            other = other.item()
        if isinstance(other, Op):
            return Op.product([self, other])
        if isinstance(other, (int, float, complex)):
            return Op(self.symbol, self.dofs, self.factor * other, self.qn_list)
        if isinstance(other, list):
            if not all(isinstance(item, Op) for item in other):
                raise TypeError("Operand must be a list of `Op`.")
            return OpSum([self * item for item in other])
        raise TypeError(f"Unsupported type: {type(other)}")

    def __rmul__(self, other):
        if isinstance(other, (int, float, complex, np.generic)):
            return self * other
        if isinstance(other, list):
            return OpSum(other) * self
        raise TypeError(f"Unknown type {type(other)}")


def _is_zero_scalar(x) -> bool:
    if isinstance(x, (int, float)) and x == 0:
        return True
    return isinstance(x, np.ndarray) and np.array_equal(x, np.array(0))


class OpSum(list):
    r"""Sum of :class:`Op` terms as a ``list`` subclass
    (reference ``op.py:406-528``).

    Examples
    --------
    >>> from renormalizer_tpu_torch.model import Op, OpSum
    >>> opsum = Op("X", 0, 1.) + Op("Y", 1, 2.)
    >>> (opsum + opsum).simplify()
    [Op('X', [0], 2.0), Op('Y', [1], 4.0)]
    >>> (opsum - opsum).simplify()
    []
    """

    @classmethod
    def product(cls, op_list):
        if len(op_list) == 0:
            return cls()
        prod = op_list[0]
        for op in op_list[1:]:
            prod = prod * op
        return prod

    def copy(self):
        return OpSum(super().copy())

    def simplify(self, atol: float = 0) -> "OpSum":
        """Combine identical terms and drop (near-)zero factors."""
        grouped: Dict[Tuple, Op] = {}
        order: List[Tuple] = []
        for op in self:
            op = op.squeeze_identity()
            key = (op.symbol, tuple(op.dofs))
            if key in grouped:
                prev = grouped[key]
                grouped[key] = Op(op.symbol, op.dofs, prev.factor + op.factor, op.qn_list)
            else:
                grouped[key] = op
                order.append(key)
        return OpSum([grouped[k] for k in order if np.abs(grouped[k].factor) > atol])

    def __add__(self, other):
        if isinstance(other, Op):
            other = [other]
        if not isinstance(other, list):
            raise TypeError("OpSum can only add with `Op` or list of `Op`")
        return OpSum(super().__add__(other))

    def __iadd__(self, other):
        if isinstance(other, Op):
            self.append(other)
            return self
        return super().__iadd__(other)

    def __neg__(self):
        return OpSum([-op for op in self])

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, other):
        if isinstance(other, list):
            res = []
            for op in self:
                res.extend(op * other)
            return OpSum(res)
        if isinstance(other, (int, float, complex, np.generic, Op)):
            return OpSum([op * other for op in self])
        return OpSum(super().__mul__(other))

    def __rmul__(self, other):
        if isinstance(other, (int, float, complex, np.generic)):
            return self * other
        return OpSum(super().__rmul__(other))

    def __truediv__(self, other):
        assert isinstance(other, (int, float, complex, np.generic))
        return self * (1 / other)

    # prevent NumPy from hijacking the arithmetic
    __array_ufunc__ = None
