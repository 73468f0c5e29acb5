r"""Factories for common property operators.

Port of ``renormalizer_tpu/property/ops.py`` (reference
``renormalizer/property/ops.py:8-120``).
"""

import numpy as np

from renormalizer_tpu_torch.model import HolsteinModel, Model
from renormalizer_tpu_torch.model.op import Op
from renormalizer_tpu_torch.mps import Mpo
from renormalizer_tpu_torch.utils import Quantity


def e_ph_static_correlation(model: HolsteinModel, imol: int = 0, jph: int = 0,
                            periodic: bool = False, name: str = "S"):
    r"""Electron-phonon static correlation operators of the polaron problem
    (Qiang Shi et al. J. Chem. Phys. 142, 174103 (2015)):

    non-periodic: S_(n,m,jph) = <x_{m,jph} a_n^+ a_n> / D_{m,jph}
    periodic:     S_(m,jph)   = sum_n <x_{m+n,jph} a_n^+ a_n> / D_{m+n,jph}
    """
    if model.scheme == 4:
        raise NotImplementedError

    prop_mpos = {}
    nmols = model.mol_num
    if not periodic:
        for jmol in range(nmols):
            op_name = "_".join([name, str(imol), str(jmol), str(jph)])
            ph = model[jmol].ph_list[jph]
            prop_mpos[op_name] = Mpo.intersite(
                model, {imol: r"a^\dagger a"}, {(jmol, jph): r"b^\dagger+b"},
                scale=Quantity(np.sqrt(1.0 / 2.0 / ph.omega[0]) / ph.dis[1]),
            )
    else:
        for dis in range(nmols):
            terms = []
            for jmol in range(nmols):
                kmol = (jmol + dis) % nmols
                ph = model[kmol].ph_list[jph]
                terms.append(
                    Mpo.intersite(
                        model, {jmol: r"a^\dagger a"}, {(kmol, jph): r"b^\dagger+b"},
                        scale=Quantity(np.sqrt(1.0 / 2.0 / ph.omega[0]) / ph.dis[1]),
                    )
                )
            total = terms[0]
            for item in terms[1:]:
                total = total.add(item)
            prop_mpos["_".join([name, str(dis), str(jph)])] = total
    return prop_mpos


def x_average(model: Model):
    """<x> of each vibrational DoF."""
    return {"x": [Mpo(model, Op("x", v_dof)) for v_dof in model.v_dofs]}


def x_square_average(model: Model):
    """<x^2> of each vibrational DoF."""
    assert isinstance(model, Model)
    return {r"x^2": [Mpo(model, Op("x^2", v_dof)) for v_dof in model.v_dofs]}
