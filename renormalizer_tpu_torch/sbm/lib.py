r"""Spectral density functions and bath discretizations for the spin-boson
model.

Reference ``renormalizer/sbm/lib.py:18-217``: Debye, Ohmic (with exponent s)
and Cole-Davidson spectral densities, with Wang's 1st-scheme and trapezoid
discretizations and adiabatic renormalization of the tunneling splitting.

Numpy/scipy copy of ``renormalizer_tpu/sbm/lib.py``.
"""

import logging
from typing import Tuple, Union

import numpy as np
import scipy.integrate
import scipy.optimize
import scipy.special

from renormalizer_tpu_torch.model import Phonon, SpinBosonModel
from renormalizer_tpu_torch.utils import Quantity

logger = logging.getLogger(__name__)


class DebyeSpectralDensityFunction:
    r"""J(w) = 2 lambda w w_c / (w^2 + w_c^2)"""

    def __init__(self, lamb, omega_c):
        self.lamb = lamb
        self.omega_c = omega_c

    def func(self, omega_value):
        return (
            2.0 * self.lamb * omega_value * self.omega_c
            / (omega_value ** 2 + self.omega_c ** 2)
        )


DebyeSDF = DebyeSpectralDensityFunction


class SpectralDensityFunction:
    r"""Ohmic-family J(w) = pi/2 alpha w^s w_c^{1-s} e^{-w/w_c}"""

    def __init__(self, alpha: float, omega_c: Union[Quantity, float], s: float = 1):
        self.alpha = alpha
        self.omega_c = omega_c.as_au() if isinstance(omega_c, Quantity) else omega_c
        self.s = s

    def func(self, omega_value):
        return (
            np.pi / 2.0 * self.alpha
            * omega_value ** self.s * self.omega_c ** (1 - self.s)
            * np.exp(-omega_value / self.omega_c)
        )

    def _reno_factor(self, omega_l):
        res = scipy.integrate.quad(
            lambda x: self.func(x) / x ** 2, a=omega_l, b=self.omega_c * 30
        )
        logger.info(f"integrate: {res[0]}, {res[1]}")
        return np.exp(-res[0] * 2 / np.pi)

    def reno(self, omega_l) -> float:
        return self._reno_factor(omega_l)

    def adiabatic_renormalization(
        self, delta: Union[Quantity, float], p: float
    ) -> Tuple[float, float]:
        """Self-consistent renormalization of the tunneling splitting with
        cutoff omega_l = p * delta (reference ``sbm/lib.py:61-84``)."""
        if isinstance(delta, Quantity):
            delta = delta.as_au()
        re = 1.0
        for _ in range(50):
            re_old = re
            re = self._reno_factor(delta * re * p)
            logger.info(f"re, {re_old}, {re}")
            if np.allclose(re, re_old):
                break
        return delta * re, delta * re * p

    @staticmethod
    def post_process(omega_value, c_j2, ifsort=True):
        displacement_array = np.sqrt(c_j2) / omega_value ** 2
        if ifsort:
            idx = np.argsort(c_j2 / omega_value)[::-1]
        else:
            idx = np.arange(len(omega_value))
        omega_list = [Quantity(omega_value[i]) for i in idx]
        displacement_list = [Quantity(displacement_array[i]) for i in idx]
        return omega_list, displacement_list

    def _dos_Wang1(self, nb, omega_value):
        return (nb + 1) / self.omega_c * np.exp(-omega_value / self.omega_c)

    def Wang1(self, nb):
        """Wang's 1st discretization scheme (reference ``sbm/lib.py:116-125``)."""
        omega_value = np.array(
            [-np.log(1.0 - j / (nb + 1)) * self.omega_c for j in range(1, nb + 1)]
        )
        c_j2 = (
            2.0 / np.pi * omega_value * self.func(omega_value)
            / self._dos_Wang1(nb, omega_value)
        )
        return omega_value, c_j2

    def trapz(self, nb, x0, x1):
        dw = (x1 - x0) / float(nb)
        edges = x0 + dw * np.arange(nb + 1)
        omega_value = (edges[:-1] + edges[1:]) / 2.0
        c_j2 = (
            (self.func(edges[:-1]) + self.func(edges[1:])) / 2
            * 2.0 / np.pi * omega_value * dw
        )
        return omega_value, c_j2


OhmicSDF = SpectralDensityFunction


class ColeDavidsonSDF:
    """Cole-Davidson spectral density with cumulative-DOS Wang1 sampling
    (reference ``sbm/lib.py:142-202``)."""

    def __init__(self, ita, omega_c, beta, omega_limit):
        self.ita = ita
        self.omega_c = omega_c
        self.beta = beta
        self.omega_limit = omega_limit

    def func(self, omega_value):
        theta = np.arctan(omega_value / self.omega_c)
        return (
            self.ita * np.sin(self.beta * theta)
            / (1 + omega_value ** 2 / self.omega_c ** 2) ** (self.beta / 2)
        )

    def reno(self, omega_l):
        res = scipy.integrate.quad(
            lambda x: self.func(x) / x ** 2, a=omega_l, b=omega_l * 1000
        )
        logger.info(f"integrate: {res[0]}, {res[1]}")
        return np.exp(-res[0] * 2 / np.pi)

    def _dos_Wang1(self, A, omega_value):
        return A * self.func(omega_value) / omega_value

    def Wang1(self, nb):
        A = (nb + 1) / scipy.integrate.quad(
            lambda x: self.func(x) / x, a=0, b=self.omega_limit
        )[0]
        nsamples = int(1e7)
        delta = self.omega_limit / nsamples
        omega_big = np.linspace(delta, self.omega_limit, nsamples)
        dos = self._dos_Wang1(A, omega_big)
        rho_cumint = np.cumsum(dos) * delta
        diff = (rho_cumint % 1)[1:] - (rho_cumint % 1)[:-1]
        idx = np.where(diff < 0)[0]
        omega_value = omega_big[idx]
        assert len(omega_value) == nb
        c_j2 = (
            2.0 / np.pi * omega_value * self.func(omega_value)
            / self._dos_Wang1(A, omega_value)
        )
        return omega_value, c_j2


def param2mollist(
    alpha: float,
    raw_delta: Quantity,
    omega_c: Quantity,
    renormalization_p: float,
    n_phonons: int,
):
    """Ohmic parameters -> discretized SpinBosonModel
    (reference ``sbm/lib.py:205-217``)."""
    sdf = SpectralDensityFunction(alpha, omega_c, s=1)
    delta, max_omega = sdf.adiabatic_renormalization(raw_delta, renormalization_p)
    omega_list, displacement_list = sdf.trapz(n_phonons, 0.0, max_omega)
    omega_list, displacement_list = sdf.post_process(omega_list, displacement_list)
    ph_list = [
        Phonon.simplest_phonon(o, d) for o, d in zip(omega_list, displacement_list)
    ]
    return SpinBosonModel(Quantity(0), Quantity(delta), ph_list)
