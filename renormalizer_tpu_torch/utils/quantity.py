"""Unit-carrying scalar.

API-compatible with the reference's ``renormalizer/utils/quantity.py:35-103``.

Examples
--------
>>> from renormalizer_tpu_torch.utils import Quantity
>>> round(Quantity(1, "eV").as_au(), 8)
0.03674932
>>> Quantity(2, "eV").as_unit("meV").value
2000.0
>>> (Quantity(1, "eV") + Quantity(1, "eV")) == Quantity(2, "eV")
True
"""

import math
import logging

from renormalizer_tpu_torch.utils import constant

logger = logging.getLogger(__name__)

_AU_RATIO = {
    "mev": constant.au2ev * 1e3,
    "ev": constant.au2ev,
    "cm^{-1}": 1.0 / constant.cm2au,
    "cm-1": 1.0 / constant.cm2au,
    "k": constant.au2K,
    "a.u.": 1.0,
    "au": 1.0,
    "fs": constant.au2fs,
}
# also accept the canonically-capitalised spellings
_AU_RATIO.update({"meV": _AU_RATIO["mev"], "eV": _AU_RATIO["ev"], "K": _AU_RATIO["k"]})

allowed_units = set(_AU_RATIO.keys())


def convert_to_au(value, unit):
    if unit not in _AU_RATIO:
        raise ValueError(f"Unit not in {sorted(allowed_units)}, got {unit}.")
    return value / _AU_RATIO[unit]


class Quantity:
    def __init__(self, value, unit="a.u."):
        self.value = float(value)
        if unit not in _AU_RATIO:
            raise ValueError(f"Unit not in {sorted(allowed_units)}, got {unit}.")
        if unit.lower() == "k" and value != 0 and value < 0.1:
            logger.warning(
                "temperature too low and might cause various numerical errors"
            )
        self.unit = unit

    def as_au(self) -> float:
        return convert_to_au(self.value, self.unit)

    def as_unit(self, unit) -> "Quantity":
        return Quantity(self.as_au() * _AU_RATIO[unit], unit)

    def to_beta(self) -> float:
        """Kelvin temperature to inverse energy (beta) in a.u."""
        if self.value == 0:
            return math.inf
        return 1.0 / self.as_au()

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __add__(self, other):
        assert isinstance(other, Quantity)
        return Quantity(self.as_au() + other.as_au())

    def __sub__(self, other):
        assert isinstance(other, Quantity)
        return Quantity(self.as_au() - other.as_au())

    def __mul__(self, other):
        assert not isinstance(other, Quantity)
        return Quantity(self.as_au() * other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return self.as_au() / other.as_au()
        return Quantity(self.as_au() / other)

    def __eq__(self, other):
        if isinstance(other, Quantity):
            return self.as_au() == other.as_au()
        if other == 0:
            return self.value == 0
        raise TypeError(f"can't compare Quantity with {type(other)}")

    def __ne__(self, other):
        return not self == other

    def __lt__(self, other):
        if isinstance(other, Quantity):
            return self.as_au() < other.as_au()
        if other == 0:
            return self.value < 0
        raise TypeError(f"can't compare Quantity with {type(other)}")

    def __gt__(self, other):
        if isinstance(other, Quantity):
            return self.as_au() > other.as_au()
        if other == 0:
            return 0 < self.value
        raise TypeError(f"can't compare Quantity with {type(other)}")

    def __str__(self):
        return f"{self.value} {self.unit}"

    def __repr__(self):
        return f"Quantity({self.value}, {self.unit!r})"
