"""Phonon mode description (reference ``renormalizer/model/phonon.py:22-155``).

A phonon carries frequencies and displacements for two potential energy
surfaces plus the number of retained Fock levels.
"""

from collections import OrderedDict
from typing import List

import numpy as np
from scipy.stats import binom

from renormalizer_tpu_torch.utils import Quantity


def _single_signed(array) -> bool:
    close0 = np.isclose(array, 0)
    return bool(
        np.logical_or(array <= 0, close0).all() or np.logical_or(0 <= array, close0).all()
    )


def all_positive_or_all_negative(array) -> bool:
    """True when all entries share a sign (zeros allowed)."""
    array = np.asarray(array)
    zeroish = np.isclose(array, 0)
    return bool(np.logical_or(array <= 0, zeroish).all()
                or np.logical_or(0 <= array, zeroish).all())


class Phonon:
    """A single phonon mode: omega/displacement pairs for two PES."""

    def __init__(self, omega, displacement, n_phys_dim: int = None):
        # omega[0], omega[1], ... for different PES; dis[0] = 0 conventionally
        self.omega = [o.as_au() for o in omega]
        self.dis = [d.as_au() for d in displacement]
        self.n_phys_dim: int = n_phys_dim

    @classmethod
    def simple_phonon(cls, omega: Quantity, displacement: Quantity, n_phys_dim: int):
        return cls([omega, omega], [Quantity(0), displacement], n_phys_dim)

    @classmethod
    def simplest_phonon(
        cls,
        omega: Quantity,
        displacement: Quantity,
        temperature: Quantity = Quantity(0),
        lam: bool = False,
        max_pdim: int = 128,
    ):
        """Construct a phonon with automatically detected Fock-space dimension
        (reference ``phonon.py:30-60``): start at 256 levels, halve while the
        displaced ground state is concentrated in the lower half, and require
        negligible amplitude on the top level."""
        if lam:
            # second argument is the reorganization energy lambda
            d = np.sqrt(2 * displacement.as_au()) / omega.as_au()
            displacement = Quantity(d)
        pdim = 256
        while True:
            trial = cls.simple_phonon(omega, displacement, pdim)
            gs = trial.get_displacement_evecs()[:, 0]
            assert _single_signed(gs)
            if 0.9999 < gs[: len(gs) // 2].sum() / gs.sum():
                pdim //= 2
            elif 0.001 < np.abs(gs[-1]):
                if pdim == 256:
                    raise ValueError(
                        f"Too many phonon level required. omega: {omega}. "
                        f"displacement: {displacement}"
                    )
                pdim *= 2
                break
            else:
                break
        thermal_dim = int(temperature.as_au() * 10 / omega.as_au())
        pdim = min(pdim + thermal_dim, max_pdim)
        return cls.simple_phonon(omega, displacement, pdim)

    def get_displacement_evecs(self) -> np.ndarray:
        """Eigenvectors of the displaced harmonic Hamiltonian
        n - g sqrt(n) shift (reference ``phonon.py:83-94``)."""
        n = self.n_phys_dim
        g = self.coupling_constant
        h = np.diag(np.arange(n, dtype=float))
        off = np.diag(-g * np.sqrt(np.arange(1, n)), k=-1)
        h = h + off + off.T
        _, evecs = np.linalg.eigh(h)
        return evecs

    def split(self, n: int = 2, width: Quantity = Quantity(10, "cm-1")) -> List["Phonon"]:
        """Binomially split this mode into ``n`` sub-modes spread over
        ``2*width`` (reference ``phonon.py:96-107``)."""
        assert self.is_simple
        rv = binom(n - 1, 0.5)
        w = width.as_au()
        step = 2 * w / (n - 1)
        omegas = np.linspace(self.omega[0] - w, self.omega[0] + w + step, n)
        return [
            Phonon.simplest_phonon(
                Quantity(omega), rv.pmf(i) * self.reorganization_energy, lam=True
            )
            for i, omega in enumerate(omegas)
        ]

    def to_dict(self):
        d = OrderedDict()
        d["omega"] = self.omega
        d["displacement"] = self.dis
        d["num physical dimension"] = self.n_phys_dim
        return d

    @property
    def pbond(self):
        return self.n_phys_dim

    nlevels = pbond

    @property
    def reorganization_energy(self) -> Quantity:
        dis_diff = self.dis[1] - self.dis[0]
        return Quantity(0.5 * dis_diff ** 2 * self.omega[1] ** 2)

    @property
    def e0(self):
        return self.reorganization_energy

    @property
    def is_simple(self):
        return self.omega[0] == self.omega[1]

    @property
    def coupling_constant(self) -> float:
        """dimensionless g = sqrt(E_reorg / omega_0)"""
        return float(np.sqrt(self.reorganization_energy.as_au() / self.omega[0]))

    @property
    def term10(self):
        """linear e-ph coupling coefficient omega_1^2 (-d_1) / sqrt(2 omega_0)"""
        return self.omega[1] ** 2 / np.sqrt(2.0 * self.omega[0]) * (-self.dis[1])

    def __eq__(self, other):
        return self.__dict__ == other.__dict__
