"""The port's precision switch and device flags (``backend.use_32bits``,
``use_64bits``, ``is_accelerator``), on the CPU.

A 4-spin Heisenberg chain is solved by 2-site DMRG after each switch; its
tensors must carry the switched dtype and its energy must reach the dense
ground state (1e-10 in fp64, 1e-5 in fp32).  The precision is restored in
a ``finally``: ``--dist loadfile`` runs other files in the same worker."""

import numpy as np
import pytest
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.model import BasisHalfSpin, Model, heisenberg_ops
from renormalizer_tpu_torch.mps import Mpo, Mps, gs

torch.set_num_threads(2)

NSPIN = 4


def _dmrg():
    model = Model([BasisHalfSpin(i) for i in range(NSPIN)], heisenberg_ops(NSPIN))
    mpo = Mpo(model)
    mps = Mps.random(model, 0, 4)
    mps.optimize_config.procedure = [[4, 0.4], [4, 0.2], [4, 0], [4, 0]]
    energies, opt = gs.optimize_mps(mps, mpo)
    exact = np.linalg.eigvalsh(mpo.todense()).min()
    return mpo, opt, min(energies), exact


@pytest.mark.parametrize("bits", [32, 64])
def test_precision_switch_reaches_the_tensors(bits):
    start = backend.is_32bits
    before = backend.tensor(np.ones(2), dtype=backend.real_dtype)
    try:
        (backend.use_32bits if bits == 32 else backend.use_64bits)()
        real = torch.float32 if bits == 32 else torch.float64
        cplx = torch.complex64 if bits == 32 else torch.complex128
        assert (backend.real_dtype, backend.complex_dtype) == (real, cplx)
        assert backend.is_32bits == (bits == 32)
        assert before.dtype == (torch.float32 if start else torch.float64)
        mpo, opt, e, exact = _dmrg()
        assert all(mt.dtype == real for mt in mpo)
        assert all(mt.dtype == real for mt in opt)
        assert e == pytest.approx(exact, abs=1e-5 if bits == 32 else 1e-10)
    finally:
        (backend.use_32bits if start else backend.use_64bits)()
    assert backend.is_32bits == start


def test_is_accelerator_follows_the_device():
    assert backend.is_accelerator is False
    assert backend.device == torch.device("cpu")
