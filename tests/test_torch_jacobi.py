"""The port's Jacobi eigensolver against the JAX package's Pallas kernel.

On the CPU the port's ``jacobi_eigh`` runs its plain torch version (block
Jacobi) and the JAX kernel runs in Pallas interpret mode (as
``tests/test_trunc_device.py`` runs it; scalar parallel-ordered Jacobi);
both converge to the same eigenpairs, fp64."""

import numpy as np
import pytest
import torch

from renormalizer_tpu.ops.jacobi import jacobi_eigh as jax_jacobi_eigh
from renormalizer_tpu_torch.ops import jacobi
from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

torch.set_num_threads(2)


def _symmetric(rng, n):
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


# 72 pads to 96: three block pairs, the last block all padding
@pytest.mark.parametrize("n", [24, 72, 96])
def test_matches_jax_kernel(n):
    a = _symmetric(np.random.default_rng(3), n)
    w, v = jacobi_eigh(torch.tensor(a))
    w_j, v_j = (np.asarray(x) for x in jax_jacobi_eigh(a))
    w, v = w.numpy(), v.numpy()
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-11)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a), rtol=0, atol=1e-11)
    # eigenvectors compared as projectors (sign-free), one per eigenvalue
    proj = np.einsum("ik,jk->kij", v, v)
    proj_j = np.einsum("ik,jk->kij", v_j, v_j)
    assert np.abs(proj - proj_j).max() < 1e-11
    assert np.abs(v.T @ v - np.eye(n)).max() < 1e-12
    assert np.abs(a @ v - v * w[None, :]).max() < 1e-11


def test_convergence_monitor_extends_sweeps():
    """Tight eigenvalue clusters over 12 decades with a low base sweep
    count: the loop must keep sweeping and report the residual."""
    rng = np.random.default_rng(5)
    lam_true = np.repeat(10.0 ** np.arange(-6, 6), 8)
    q, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    a = (q * lam_true) @ q.T
    a = (a + a.T) / 2
    w, v, resid = jacobi_eigh(torch.tensor(a), sweeps=2, return_resid=True)
    assert float(resid) < 1e-7
    # the tolerances of the JAX kernel's own test: the 1e-6 cluster carries
    # ~1e-11 absolute error (eps * ||A||), covered by atol, not by rtol
    np.testing.assert_allclose(w.numpy(), np.sort(lam_true), rtol=1e-8,
                               atol=1e-10)
    assert np.abs(v.numpy().T @ v.numpy() - np.eye(96)).max() < 1e-10


def test_batched_equals_per_matrix():
    rng = np.random.default_rng(8)
    a = torch.tensor(np.stack([_symmetric(rng, 40) for _ in range(3)]))
    w_b, v_b, r_b = jacobi_eigh(a, return_resid=True)
    for i in range(3):
        w_i, v_i, r_i = jacobi_eigh(a[i], return_resid=True)
        assert torch.equal(w_b[i], w_i) and torch.equal(v_b[i], v_i)
        assert torch.equal(r_b[i], r_i)


def test_padding_is_exact_and_rejects_bad_input():
    """n=20 pads to 32: the result must be that of the 20x20 problem."""
    a = _symmetric(np.random.default_rng(9), 20)
    w, v = jacobi_eigh(torch.tensor(a))
    assert w.shape == (20,) and v.shape == (20, 20)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a), atol=1e-12)
    with pytest.raises(TypeError):
        jacobi_eigh(torch.zeros((4, 4), dtype=torch.complex128))
    with pytest.raises(ValueError):
        jacobi_eigh(torch.zeros((4, 5), dtype=torch.float64))


def test_f32_stop_test_ends_before_the_cap():
    """An f32 spectrum on which the earlier rule (total - diagonal <= eps^2
    ||A||^2, each sum in f32) ran to the sweep cap: at the converged
    diag(lam) the two sums do not round alike.  The block solver's
    entry-wise test stops before the cap with resid <= n eps."""
    n = 96
    rng = np.random.default_rng(17)
    lam = rng.standard_normal(n).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * lam.astype(np.float64)) @ q.T
    a = torch.tensor((a + a.T) / 2, dtype=torch.float32)
    eps = np.finfo(np.float32).eps
    sweeps = jacobi.default_sweeps(torch.float32)
    w, v, resid, nsweeps = jacobi._solve_reference(
        jacobi._pad(a[None], jacobi.padded_size(n)), sweeps)
    assert int(nsweeps[0]) < sweeps + jacobi.MAX_EXTRA_SWEEPS
    assert float(resid[0]) <= n * eps
    w, v = jacobi_eigh(a)
    np.testing.assert_allclose(w.numpy(), np.sort(lam), rtol=0,
                               atol=1e-5 * np.linalg.norm(lam))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_size_limit_is_the_kernels_block_table(dtype):
    """The kernel takes a padded n up to its 512-block table (8192) and is
    refused one padding step beyond; the plain version has no such limit
    (stride-0 views: no matrix of that size is allocated)."""
    n_max = jacobi.MAX_N
    assert n_max // jacobi.BLOCK == 512 and jacobi.padded_size(n_max) == n_max
    jacobi.check_kernel_size(n_max)
    with pytest.raises(ValueError, match="block table"):
        jacobi.check_kernel_size(n_max + 1)
    jacobi._check(torch.zeros((), dtype=dtype).expand(n_max + 1, n_max + 1))
