"""Physical unit conversion constants (atomic-unit centric).

Mirrors the reference's ``renormalizer/utils/constant.py:1-62``.
"""

from scipy.constants import physical_constants as _pc

# energy
au2ev = _pc["Hartree energy in eV"][0]
ev2au = 1.0 / au2ev

cm2au = (
    1.0e2
    * _pc["inverse meter-hertz relationship"][0]
    / _pc["hartree-hertz relationship"][0]
)
au2cm = 1.0 / cm2au

cm2ev = cm2au * au2ev
ev2cm = 1.0 / cm2ev

# time
fs2au = 1.0e-15 / _pc["atomic unit of time"][0]
au2fs = 1.0 / fs2au

# temperature
K2au = _pc["kelvin-hartree relationship"][0]
au2K = _pc["hartree-kelvin relationship"][0]

# mass / length
amu2au = _pc["atomic mass constant"][0] / _pc["atomic unit of mass"][0]
au2amu = 1.0 / amu2au
angstrom2au = 1e-10 / _pc["atomic unit of length"][0]
au2angstrom = 1.0 / angstrom2au


def nm2au(l):
    return 1.0e7 / l * cm2au


def au2nm(e):
    return 1.0e7 / (e / cm2au)


# mobility: 1 cm^2/(V s) in atomic units
mobility2au = (
    au2ev * _pc["atomic unit of time"][0] / (_pc["atomic unit of length"][0] * 100) ** 2
)

# dipole moment
debye2au = 0.393456
au2debye = 1.0 / debye2au
