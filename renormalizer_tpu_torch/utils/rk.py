"""Explicit Runge-Kutta Butcher tableaus and Taylor-expansion coefficients.

Numpy copy of ``renormalizer_tpu/utils/rk.py``.

Same tableau set as the reference (``renormalizer/utils/rk.py:15-190``);
the tableaus themselves are textbook constants.
"""

import numpy as np
from scipy.special import factorial


class TaylorExpansion:
    """Taylor expansion coefficients of exp(x) up to ``order``."""

    def __init__(self, order: int):
        self.order = order
        self.coeff = np.array([1.0 / factorial(i) for i in range(order + 1)])


def _tableaus():
    t = {}
    t["Forward_Euler"] = (
        np.zeros((1, 1)),
        np.array([[1.0]]),
        np.array([0.0]),
        (1,),
    )
    for name, alpha in [("midpoint_RK2", 1.0), ("Heun_RK2", 0.5), ("Ralston_RK2", 2.0 / 3.0)]:
        t[name] = (
            np.array([[0.0, 0.0], [alpha, 0.0]]),
            np.array([[1 - 0.5 / alpha, 0.5 / alpha]]),
            np.array([0.0, alpha]),
            (2,),
        )
    t["Kutta_RK3"] = (
        np.array([[0.0, 0, 0], [0.5, 0, 0], [-1.0, 2.0, 0]]),
        np.array([[1 / 6, 2 / 3, 1 / 6]]),
        np.array([0.0, 0.5, 1.0]),
        (3,),
    )
    t["C_RK4"] = (
        np.array([[0.0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 1.0, 0]]),
        np.array([[1 / 6, 1 / 3, 1 / 3, 1 / 6]]),
        np.array([0.0, 0.5, 0.5, 1.0]),
        (4,),
    )
    t["38rule_RK4"] = (
        np.array([[0.0, 0, 0, 0], [1 / 3, 0, 0, 0], [-1 / 3, 1, 0, 0], [1, -1, 1, 0]]),
        np.array([[1 / 8, 3 / 8, 3 / 8, 1 / 8]]),
        np.array([0.0, 1 / 3, 2 / 3, 1.0]),
        (4,),
    )
    _fehlberg_a = np.array(
        [
            [0, 0, 0, 0, 0, 0],
            [1 / 4, 0, 0, 0, 0, 0],
            [3 / 32, 9 / 32, 0, 0, 0, 0],
            [1932 / 2197, -7200 / 2197, 7296 / 2197, 0, 0, 0],
            [439 / 216, -8, 3680 / 513, -845 / 4104, 0, 0],
            [-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40, 0],
        ]
    )
    _fehlberg_c = np.array([0, 1 / 4, 3 / 8, 12 / 13, 1, 1 / 2])
    _fehlberg_b5 = np.array([16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55])
    _fehlberg_b4 = np.array([25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0])
    t["Fehlberg5"] = (_fehlberg_a, _fehlberg_b5.reshape(1, -1), _fehlberg_c, (5,))
    t["RKF45"] = (
        _fehlberg_a,
        np.stack([_fehlberg_b5, _fehlberg_b4]),
        _fehlberg_c,
        (5, 4),
    )
    t["Cash-Karp45"] = (
        np.array(
            [
                [0, 0, 0, 0, 0, 0],
                [1 / 5, 0, 0, 0, 0, 0],
                [3 / 40, 9 / 40, 0, 0, 0, 0],
                [3 / 10, -9 / 10, 6 / 5, 0, 0, 0],
                [-11 / 54, 5 / 2, -70 / 27, 35 / 27, 0, 0],
                [1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096, 0],
            ]
        ),
        np.array(
            [
                [37 / 378, 0, 250 / 621, 125 / 594, 0, 512 / 1771],
                [2825 / 27648, 0, 18575 / 48384, 13525 / 55296, 277 / 14336, 1 / 4],
            ]
        ),
        np.array([0, 1 / 5, 3 / 10, 3 / 5, 1, 7 / 8]),
        (5, 4),
    )
    return t


_TABLEAUS = _tableaus()
method_list = list(_TABLEAUS.keys())


class RungeKutta:
    """Wrapper over a named explicit RK scheme."""

    def __init__(self, method: str = "C_RK4"):
        if method not in _TABLEAUS:
            raise ValueError(f"Unknown RK method {method}. Available: {method_list}")
        self.method = method
        a, b, c, order = _TABLEAUS[method]
        self.tableau = [a.astype(float), b.astype(float), c.astype(float)]
        self.stage = a.shape[0]
        self.order = order

    def runge_kutta_ti_coefficient(self) -> np.ndarray:
        """Collapse the tableau into Taylor coefficients for a
        time-independent generator (reference ``utils/rk.py:192-230``)."""
        a, b, _ = self.tableau
        n = self.stage
        # table[i+1, k] = coefficient of f^{k-1} y in stage i
        table = np.zeros([n + 1, n + 1])
        table[0, 0] = 1.0
        for i in range(n):
            table[i + 1, 2:] = a[i, :].dot(table[1:, 1:])[:-1]
            table[i + 1, 1] = 1.0
        coeff = np.zeros((b.shape[0], n + 1))
        coeff[:, 0] = 1.0
        coeff[:, 1:] = b.dot(table[1:, 1:])
        if coeff.shape[0] == 1:
            return coeff[0]
        return coeff
