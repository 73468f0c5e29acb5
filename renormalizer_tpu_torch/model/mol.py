"""Molecule description (reference ``renormalizer/model/mol.py:13-60``)."""

from collections import OrderedDict
from typing import List

from renormalizer_tpu_torch.model.phonon import Phonon


class Mol:
    """A molecule: local excitation energy, phonon list, transition dipole."""

    def __init__(self, elocalex, ph_list: List[Phonon], dipole=None):
        self.elocalex = elocalex.as_au()
        self.dipole = dipole
        if len(ph_list) == 0:
            raise ValueError("No phonon mode in phonon list")
        self.ph_list = ph_list
        self.e0 = sum(ph.reorganization_energy.as_au() for ph in ph_list)

    @property
    def reorganization_energy(self):
        return self.e0

    @property
    def gs_zpe(self):
        return sum(ph.omega[0] for ph in self.ph_list) / 2

    @property
    def ex_zpe(self):
        return sum(ph.omega[1] for ph in self.ph_list) / 2

    def to_dict(self):
        d = OrderedDict()
        d["elocalex"] = self.elocalex
        d["dipole"] = self.dipole
        d["reorganization energy in a.u."] = self.reorganization_energy
        d["phonon list"] = [ph.to_dict() for ph in self.ph_list]
        return d

    def __eq__(self, other):
        return self.__dict__ == other.__dict__

    def __ne__(self, other):
        return not self == other
