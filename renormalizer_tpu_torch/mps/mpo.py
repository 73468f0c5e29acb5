r"""Matrix product operators.

Port of the constructor and ``todense`` of ``renormalizer_tpu/mps/mpo.py``
(reference ``renormalizer/mps/mpo.py:28-494``).  The symbolic compilation
runs on the host (``symbolic_mpo.py``); the numeric site tensors live on the
backend device.
"""

import logging
from copy import deepcopy
from typing import List, Union

import numpy as np

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.model import Model, Op
from renormalizer_tpu_torch.mps.mp import MatrixProduct
from renormalizer_tpu_torch.mps.svd_qn import add_outer
from renormalizer_tpu_torch.mps.symbolic_mpo import (
    _terms_to_table,
    construct_symbolic_mpo,
    symbolic_mo_to_numeric_mo,
)
from renormalizer_tpu_torch.utils import Quantity

logger = logging.getLogger(__name__)


class Mpo(MatrixProduct):
    """Matrix product operator, automatically compiled from symbolic terms."""

    def __init__(
        self,
        model: Model = None,
        terms: Union[Op, List[Op]] = None,
        offset: Quantity = Quantity(0),
        algo: str = "qr",
    ):
        super().__init__()
        if model is None:
            # allow manual construction
            return
        if not isinstance(offset, Quantity):
            raise ValueError(
                f"offset must be Quantity object. Got {offset} of {type(offset)}."
            )
        self.offset = offset.as_au()
        if terms is None:
            terms = model.ham_terms
        elif isinstance(terms, Op):
            terms = [terms]
        if len(terms) == 0:
            raise ValueError("Terms contain nothing.")
        terms = model.check_operator_terms(terms)
        if len(terms) == 0:
            raise ValueError("Terms all have factor 0.")

        table, primary_ops, factor = _terms_to_table(model, terms, -self.offset)
        self.dtype = (
            backend.complex_dtype if np.iscomplexobj(factor) else backend.real_dtype
        )

        (
            self.symbolic_mpo,
            self.qn,
            self.qntot,
            self.qnidx,
            self.symbolic_out_ops_list,
            self.primary_ops,
        ) = construct_symbolic_mpo(table, primary_ops, factor, algo=algo)
        self.model = model
        self.to_right = False

        for impo, mo in enumerate(self.symbolic_mpo):
            self.append(symbolic_mo_to_numeric_mo(model.basis[impo], mo,
                                                  np_dtype(self.dtype)))

    def _get_sigmaqn(self, idx):
        qn = self.model.basis[idx].sigmaqn
        return add_outer(qn, -qn)

    @property
    def is_mps(self):
        return False

    @property
    def is_mpo(self):
        return True

    def metacopy(self) -> "Mpo":
        new = super().metacopy()
        for attr in ("offset", "symbolic_out_ops_list", "primary_ops"):
            if hasattr(self, attr):
                setattr(new, attr, deepcopy(getattr(self, attr)))
        return new

    def todense(self) -> np.ndarray:
        """The operator as a dense host matrix (small systems only)."""
        dim = np.prod(self.pbond_list)
        if 20000 < dim:
            raise ValueError("operator too large")
        res = np.ones((1, 1, 1, 1))
        for mt in self:
            mt = mt.cpu().numpy()
            d1 = res.shape[1] * mt.shape[1]
            d2 = res.shape[2] * mt.shape[2]
            res = (
                np.tensordot(res, mt, axes=1)
                .transpose((0, 1, 3, 2, 4, 5))
                .reshape(1, d1, d2, mt.shape[-1])
            )
        return res[0, :, :, 0]
