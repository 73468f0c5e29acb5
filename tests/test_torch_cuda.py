"""Tests of the port that need an NVIDIA GPU (marked ``cuda``).

They skip without a card.  On a machine with one, where jax is not
installed, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from renormalizer_tpu_torch.ops import jacobi
from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh, jacobi_eigh_reference

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _symmetric_stack(seed, batch, n):
    a = np.random.default_rng(seed).standard_normal((batch, n, n))
    return (a + np.swapaxes(a, -1, -2)) / 2


# the main path's steady-sweep batch, its widest growth-sweep Gram, and f64;
# tolerances relative to ||A||_F: eigenvalues within 1e-5 (f32) / 1e-11
# (f64) of the exact ones for either version, so within twice that of each
# other; |V^T V - I| as chip_smoke.py holds it
@pytest.mark.cuda
@pytest.mark.parametrize("batch, n, dtype, eig, orth", [
    (2, 288, torch.float32, 1e-5, 1e-4),
    (1, 544, torch.float32, 1e-5, 1e-4),
    (2, 96, torch.float64, 1e-11, 1e-12),
])
def test_jacobi_kernel_matches_plain(cuda, batch, n, dtype, eig, orth):
    """The CUDA kernel against its plain version, one counted launch, both
    stopping before the sweep cap."""
    a = torch.tensor(_symmetric_stack(2019, batch, n), dtype=dtype, device=cuda)
    before = jacobi_eigh.launches
    w, v, _, nsweeps = jacobi_eigh(a, return_resid=True, return_sweeps=True)
    w_p, _, _, nsweeps_p = jacobi_eigh_reference(a, return_resid=True,
                                                 return_sweeps=True)
    assert jacobi_eigh.launches == before + 1
    cap = jacobi.default_sweeps(dtype) + jacobi.MAX_EXTRA_SWEEPS
    assert int(nsweeps.max()) < cap and int(nsweeps_p.max()) < cap
    norm = float(torch.linalg.matrix_norm(a).min())
    assert float((w - w_p).abs().max()) < 2 * eig * norm
    eye = torch.eye(n, dtype=dtype, device=cuda)
    assert float((v.mT @ v - eye).abs().max()) < orth
