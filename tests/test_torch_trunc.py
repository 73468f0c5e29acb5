"""The port's device truncation against the JAX package's and host LAPACK.

Blocked (quantum-number-sparse) matrices are drawn with numpy from fixed
seeds; the port (``renormalizer_tpu_torch.mps.trunc_device``, real Grams
through the plain Jacobi on the CPU) must reproduce the JAX
``trunc_device.candidates`` spectrum and the host ``svd_qn`` one, and
return orthonormal, quantum-number-pure kept bases."""

import numpy as np
import pytest
import torch

from renormalizer_tpu.mps import trunc_device as jax_trunc
from renormalizer_tpu.mps.svd_qn import svd_qn as jax_svd_qn
from renormalizer_tpu_torch.mps import trunc_device
from renormalizer_tpu_torch.mps.lib import select_indices
from renormalizer_tpu_torch.mps.svd_qn import svd_qn
from renormalizer_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _blocked(seed, m, n, qn_size):
    rng = np.random.default_rng(seed)
    qnl = rng.integers(0, 2, (m, qn_size))
    qnr = rng.integers(0, 2, (n, qn_size))
    qntot = np.ones(qn_size, dtype=int)
    c = rng.standard_normal((m, n))
    c *= np.all(qnl[:, None, :] + qnr[None, :, :] == qntot, axis=-1)
    return c, qnl, qnr, qntot


def _check_basis(ms, qn_rows, labels, tol):
    ms = ms.numpy()
    assert np.abs(ms.T @ ms - np.eye(ms.shape[1])).max() < tol
    for k, label in enumerate(labels):
        off = ms[np.any(qn_rows != np.asarray(label), axis=-1), k]
        assert np.abs(off).max(initial=0.0) == 0.0


@pytest.mark.parametrize("seed", [0, 10])
@pytest.mark.parametrize("qn_size", [1, 2])
@pytest.mark.parametrize("system", ["L", "R"])
def test_candidates_match_jax_and_host(system, qn_size, seed):
    m, n, cap = 70, 90, 30
    c, qnl, qnr, qntot = _blocked(seed + qn_size, m, n, qn_size)
    parts, sigma, qn_list = trunc_device.candidates(
        c, qnl, qnr, qntot, system, cap, want_complement=False)
    _, sigma_j, _ = jax_trunc.candidates(
        c, qnl, qnr, qntot, system, cap, want_complement=False)
    _, su, _, _, _, _ = svd_qn(c, qnl, qnr, qntot, system=system,
                               full_matrices=False)
    _, su_j, _, _, _, _ = jax_svd_qn(c, qnl, qnr, qntot, system=system,
                                     full_matrices=False)
    np.testing.assert_array_equal(su, su_j)
    k = min(cap, len(su))
    top = np.sort(sigma)[::-1][:k]
    np.testing.assert_allclose(top, np.sort(su)[::-1][:k], atol=1e-8)
    np.testing.assert_allclose(top, np.sort(np.asarray(sigma_j))[::-1][:k],
                               atol=1e-8)

    sidx = select_indices(sigma, qn_list, cap, 0)
    ms, comp = trunc_device.apply_selection(c, parts, sidx, m, n, system)
    qn_rows = qnl if system == "L" else qnr
    _check_basis(ms, qn_rows, [qn_list[i] for i in sidx], 1e-10)
    # optimal truncation residual
    recon = ms @ comp if system == "L" else comp @ ms.T
    s_ref = np.sort(su)[::-1]
    resid = np.linalg.norm(c - recon.numpy())
    resid_opt = np.sqrt(max(np.sum(s_ref ** 2) - np.sum(s_ref[:k] ** 2), 0))
    assert resid < resid_opt * 1.0001 + 1e-9


def test_complex_grams_go_to_linalg_eigh():
    """A complex coefficient takes torch.linalg.eigh for its Grams (counted)
    and still reproduces the host spectrum with a unitary, pure basis."""
    m, n, cap = 50, 40, 20
    c, qnl, qnr, qntot = _blocked(12, m, n, 1)
    rng = np.random.default_rng(13)
    c = c * np.exp(1j * rng.uniform(0, 2 * np.pi, c.shape))
    before = profiling.snapshot()
    parts, sigma, qn_list = trunc_device.candidates(
        c, qnl, qnr, qntot, "L", cap, want_complement=False)
    assert profiling.delta(before)["trunc.linalg_eigh_grams"] == 2  # two sectors
    _, su, _, _, _, _ = svd_qn(c, qnl, qnr, qntot, system="L",
                               full_matrices=False)
    k = min(cap, len(su))
    np.testing.assert_allclose(np.sort(sigma)[::-1][:k],
                               np.sort(su)[::-1][:k], atol=1e-8)
    sidx = select_indices(sigma, qn_list, cap, 0)
    ms, _ = trunc_device.apply_selection(c, parts, sidx, m, n, "L")
    ms = ms.numpy()
    assert np.abs(ms.conj().T @ ms - np.eye(ms.shape[1])).max() < 1e-10


def test_complement_candidates_orthonormal():
    """percent-based allocation needs valid zero-weight in-sector states."""
    m, n, cap = 90, 30, 25
    c, qnl, qnr, qntot = _blocked(1, m, n, 1)
    parts, sigma, qn_list = trunc_device.candidates(
        c, qnl, qnr, qntot, "L", cap, want_complement=True)
    sidx = select_indices(sigma, qn_list, cap, 0.5)
    ms, _ = trunc_device.apply_selection(c, parts, sidx, m, n, "L")
    _check_basis(ms, qnl, [qn_list[i] for i in sidx], 1e-9)


@pytest.mark.parametrize("system", ["L", "R"])
def test_compress_factors_reconstruct(system):
    m, n = 60, 50
    c, qnl, qnr, qntot = _blocked(6, m, n, 2)
    u, s, qnl_list, v, _, qnr_list = trunc_device.compress_factors(
        c, qnl, qnr, qntot, system)
    rec = (u.numpy() * s) @ v.numpy().T
    assert np.abs(rec - c).max() < 1e-10
    _, su, _, _, _, _ = svd_qn(c, qnl, qnr, qntot, system=system,
                               full_matrices=False)
    np.testing.assert_allclose(s, su, atol=1e-10)
    _check_basis(u, qnl, qnl_list, 1e-10)
    _check_basis(v, qnr, qnr_list, 1e-10)


@pytest.mark.parametrize("system", ["L", "R"])
def test_qr_qn_device_reconstructs(system):
    m, n = 40, 30
    c, qnl, qnr, qntot = _blocked(7, m, n, 1)
    u, qnl_list, v, qnr_list = trunc_device.qr_qn_device(c, qnl, qnr, qntot, system)
    assert np.abs(u.numpy() @ v.numpy().T - c).max() < 1e-12
    ortho = u if system == "L" else v
    rows, labels = (qnl, qnl_list) if system == "L" else (qnr, qnr_list)
    _check_basis(ortho, rows, labels, 1e-12)


@pytest.mark.parametrize("budget", [trunc_device.MASK_BUDGET, 0])
@pytest.mark.parametrize("system", ["L", "R"])
def test_basis_quality_f32(system, budget, monkeypatch):
    """f32 with sector spectra decaying to 1e-9 (columns beyond the f32
    numerical rank exist): the kept basis must be orthonormal to f32
    roundoff and exactly qn-pure, through the masked batch and through
    the per-sector path (budget 0)."""
    monkeypatch.setattr(trunc_device, "MASK_BUDGET", budget)
    rng = np.random.default_rng(3)
    m, n, cap = 200, 180, 64
    qnl = rng.integers(0, 3, (m, 1))
    qnr = rng.integers(0, 3, (n, 1))
    qntot = np.array([2])
    c = np.zeros((m, n), dtype=np.float32)
    for q in range(3):
        ls = np.where(qnl[:, 0] == q)[0]
        rs = np.where((qntot[0] - qnr[:, 0]) == q)[0]
        r = min(len(ls), len(rs))
        if r == 0:
            continue
        u, _ = np.linalg.qr(rng.standard_normal((len(ls), r)))
        v, _ = np.linalg.qr(rng.standard_normal((len(rs), r)))
        c[np.ix_(ls, rs)] = (u * 10.0 ** np.linspace(0, -9, r)) @ v.T
    parts, sigma, qn_list = trunc_device.candidates(
        c, qnl, qnr, qntot, system, cap, want_complement=False)
    assert parts[0].dtype == torch.float32
    sidx = select_indices(sigma, qn_list, cap, 0)
    ms, _ = trunc_device.apply_selection(c, parts, sidx, m, n, system)
    _check_basis(ms, qnl if system == "L" else qnr,
                 [qn_list[i] for i in sidx], 1e-5)


def _expanded_chain(seed, monkeypatch):
    """``MpDm.max_entangled_ex`` of the 3-molecule, 3-level, J = 0.2 chain
    after the port's ``expand_bond_dimension`` (its ``compress`` inside), as
    ``ThermalProp`` expands it, with the port's generator seeded by
    ``seed``."""
    import renormalizer_tpu_torch as rt
    from renormalizer_tpu_torch.backend import backend

    monkeypatch.setattr(backend, "_seed", seed)
    ph = rt.Phonon.simple_phonon(rt.Quantity(1.0), rt.Quantity(0.6), 3)
    model = rt.HolsteinModel([rt.Mol(rt.Quantity(0.0), [ph], 1.0)] * 3,
                             rt.Quantity(0.2))
    return rt.MpDm.max_entangled_ex(model).expand_bond_dimension(rt.Mpo(model))


def test_compress_of_the_expansion_does_not_depend_on_the_seed(monkeypatch):
    """``compress`` factors each sector block by a full SVD, so the padding
    of an expansion (the exact zeros and the 1e-10-weight directions) comes
    from the data, not from the generator: seeds 2019 and 1 give the same
    bond dimensions per sector and the same site tensors up to the sign of
    each bond state.  Deflating by Gram passes with seeded completions gave
    other padding columns for each seed, and 10 imaginary-time steps from
    them ended 4.4e-6 and 1.5e-3 off the dense ensemble."""
    a = _expanded_chain(2019, monkeypatch)
    b = _expanded_chain(1, monkeypatch)
    assert a.bond_dims == b.bond_dims
    for qa, qb in zip(a.qn, b.qn):
        la, ca = np.unique(np.asarray(qa), axis=0, return_counts=True)
        lb, cb = np.unique(np.asarray(qb), axis=0, return_counts=True)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ca, cb)
    sign = np.ones(1)
    for mta, mtb in zip(a, b):
        ma = (sign[:, None] * mta.numpy().reshape(len(sign), -1)).reshape(
            -1, mta.shape[-1])
        mb = mtb.numpy().reshape(-1, mtb.shape[-1])
        sign = np.where(np.einsum("ij,ij->j", ma, mb) < 0, -1.0, 1.0)
        np.testing.assert_allclose(ma * sign[None, :], mb, rtol=0, atol=1e-8)


def test_compress_factors_resolve_the_graded_tail(monkeypatch):
    """The singular values ``compress`` cuts by are those of numpy's SVD of
    the same sector blocks, down to the expansion's 1e-10-weight
    directions and the exact zeros."""
    mpdm = _expanded_chain(2019, monkeypatch)
    for idx in mpdm.iter_idx_list(full=False):
        qnbigl, qnbigr, _ = mpdm._get_big_qn([idx])
        system = "L" if mpdm.to_right else "R"
        _, sigma, _, _, _, _ = trunc_device.compress_factors(
            mpdm[idx], qnbigl, qnbigr, mpdm.qntot, system, resolve=True)
        _, s_host, _, _, _, _ = svd_qn(mpdm[idx].numpy(), qnbigl, qnbigr,
                                       mpdm.qntot, system=system,
                                       full_matrices=False)
        np.testing.assert_allclose(np.sort(sigma)[::-1],
                                   np.sort(s_host)[::-1], rtol=0, atol=1e-14)
        assert (np.asarray(s_host) < 1e-6).any()
        mpdm._push_cano(idx)
