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


@pytest.mark.cuda
def test_thermal_prop_reaches_the_kernel(cuda, monkeypatch):
    """ThermalProp of chip_smoke.py's phase 8(a) (3 molecules, one 3-level
    phonon each, 1500 K, beta/2 in 20 TDVP-PS steps) on the card and on the
    CPU, both in fp32: the same occupations.  The compresses of the
    expansion and of every step's bond entropies factor their real sector
    blocks by cuSOLVER's SVD on the card (counted in
    ``trunc_device.SVD_BLOCKS``), no longer by Gram matrices through the
    Jacobi kernel, which this path therefore does not launch."""
    from renormalizer_tpu_torch import (
        EvolveConfig, EvolveMethod, HolsteinModel, MpDm, Mol, Phonon, Quantity,
        ThermalProp)
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device

    def occupations():
        ph = Phonon.simple_phonon(Quantity(1.0), Quantity(0.6), 3)
        model = HolsteinModel([Mol(Quantity(0.0), [ph], 1.0)] * 3, Quantity(0.1))
        tp = ThermalProp(MpDm.max_entangled_ex(model),
                         evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
        tp.evolve(None, 20, Quantity(1500.0, "K").to_beta() / 2j)
        assert tp.latest_mps[0].device.type == backend.device.type
        return tp.e_occupations_array[-1]

    assert backend.device.type == "cuda" and backend.is_32bits
    before, blocks = jacobi_eigh.launches, trunc_device.SVD_BLOCKS
    on_card = occupations()
    launches = jacobi_eigh.launches - before
    svd_blocks = trunc_device.SVD_BLOCKS - blocks
    monkeypatch.setattr(backend, "device", torch.device("cpu"))
    on_cpu = occupations()
    assert svd_blocks > 0 and launches == 0
    # both fp32; the CPU run is 4.6e-7 off the dense populations
    np.testing.assert_allclose(on_card, on_cpu, atol=1e-5)


@pytest.mark.cuda
def test_kernel_on_state_averaged_density_matrix_blocks(cuda, monkeypatch):
    """The sector blocks of the averaged density matrix that state-averaged
    DMRG (2 roots, ``tests/test_mps.py::test_dmrg_nroots``'s model and
    procedure) hands ``svd_qn.eigh_qn`` on the card: each block again
    through the kernel and through its plain version, eigenvalues within
    2e-5 ||A||_F of each other (twice phase 3's f32 tolerance), neither at
    the sweep cap."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
    from renormalizer_tpu_torch.mps import svd_qn, trunc_device
    from renormalizer_tpu_torch.mps.gs import construct_mps_mpo, optimize_mps

    blocks, inside = [], []
    gram_eigh, eigh_qn = trunc_device.gram_eigh, svd_qn.eigh_qn

    def keep(g):
        if inside:
            blocks.append(g.clone())
        return gram_eigh(g)

    def averaged(*args, **kwargs):
        inside.append(True)
        try:
            return eigh_qn(*args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(trunc_device, "gram_eigh", keep)
    monkeypatch.setattr(svd_qn, "eigh_qn", averaged)
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    mps, mpo = construct_mps_mpo(model, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0]]
    mps.optimize_config.nroots = 2
    optimize_mps(mps, mpo)
    assert blocks and all(b.device.type == "cuda" for b in blocks)
    cap = jacobi.default_sweeps(torch.float32) + jacobi.MAX_EXTRA_SWEEPS
    for a in blocks:
        w, _, _, sweeps = jacobi_eigh(a, return_resid=True, return_sweeps=True)
        w_p, _, _, sweeps_p = jacobi_eigh_reference(a, return_resid=True,
                                                    return_sweeps=True)
        assert int(sweeps.max()) < cap and int(sweeps_p.max()) < cap
        norm = max(float(torch.linalg.matrix_norm(a)), 1e-30)
        assert float((w - w_p).abs().max()) < 2e-5 * norm


@pytest.mark.cuda
def test_compress_factors_svd_on_the_card(cuda):
    """``compress``'s factorization on the card: each sector block of a
    graded qn-blocked matrix (one column at 1e-10) factored by cuSOLVER's
    SVD (counted in ``SVD_BLOCKS``, no Jacobi launch), with numpy's
    singular values of the same blocks and C = u diag(s) v^T."""
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.mps.svd_qn import svd_qn

    rng = np.random.default_rng(7)
    qnl = rng.integers(0, 2, (40, 2))
    qnr = rng.integers(0, 2, (30, 2))
    qntot = np.ones(2, dtype=int)
    c = rng.standard_normal((40, 30))
    c[:, 3] *= 1e-10
    c *= np.all(qnl[:, None, :] + qnr[None, :, :] == qntot, axis=-1)
    blocks, launches = trunc_device.SVD_BLOCKS, jacobi_eigh.launches
    u, s, _, v, _, _ = trunc_device.compress_factors(
        torch.tensor(c, device=cuda), qnl, qnr, qntot, "L", resolve=True)
    assert trunc_device.SVD_BLOCKS > blocks and jacobi_eigh.launches == launches
    _, s_host, _, _, _, _ = svd_qn(c, qnl, qnr, qntot, system="L", full_matrices=False)
    np.testing.assert_allclose(np.sort(s), np.sort(s_host), rtol=0, atol=1e-13)
    rebuilt = (u * torch.tensor(s, device=cuda)) @ v.T
    np.testing.assert_allclose(rebuilt.cpu().numpy(), c, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_tree_dmrg_reaches_the_kernel(cuda):
    """Tree DMRG (``tests/test_tn.py::test_optimize_ttns``'s model and
    procedure on a binary tree) on the card in fp32: every 2-site update's
    truncation launches the Jacobi kernel, and the lowest energy lies within
    1e-5 of the dense sector energy (0.3361574422, ``exact_model``)."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree, optimize_ttns

    assert backend.device.type == "cuda" and backend.is_32bits
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    tree = BasisTree.binary(model.basis)
    ttns = TTNS.random(tree, 1, 16)
    before = jacobi_eigh.launches
    energies = optimize_ttns(ttns, TTNO(tree, model.ham_terms),
                             [[16, 0.4], [16, 0.2], [16, 0], [16, 0]])
    # four sweeps of the tree's five bonds, one truncation each
    assert jacobi_eigh.launches - before >= 4 * 5
    assert ttns.root.tensor.device.type == "cuda"
    assert abs(min(energies) - 0.3361574422) < 1e-5
