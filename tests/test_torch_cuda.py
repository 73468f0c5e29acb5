"""Tests of the port that need an NVIDIA GPU (marked ``cuda``).

They skip without a card.  On a machine with one, where jax is not
installed, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.cuda
def test_jacobi_kernel_matches_plain(cuda):
    """The CUDA kernel against its plain version at the main path's shape,
    (2, 288, 288) f32, with one counted launch."""
    a = torch.tensor(_symmetric_stack(2019, 2, 288), dtype=torch.float32,
                     device=cuda)
    before = jacobi_eigh.launches
    w, v = jacobi_eigh(a)
    w_p, _ = jacobi_eigh_reference(a)
    assert jacobi_eigh.launches == before + 1
    # both sit within 1e-5 ||A||_F of the exact eigenvalues
    norm = float(torch.linalg.matrix_norm(a).min())
    assert float((w - w_p).abs().max()) < 2e-5 * norm
    eye = torch.eye(288, device=cuda)
    assert float((v.mT @ v - eye).abs().max()) < 1e-4
