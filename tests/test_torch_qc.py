"""The port's quantum-chemistry slice, fp64 on the CPU.

``read_fcidump``/``int_to_h``/``qc_model`` against the JAX package's term
lists and the H2O MPO against the JAX package's site by site; QC-DMRG
(``tests/test_qc.py``'s 3-orbital case with ``Mpo`` and ``StackedMpo``, and
H2O/STO-3G at M=50 against the published FCI energy); ``StackedMpo`` DMRG
of the Holstein fixture split in two, OFS-S on its scheme-1 chain,
``variational_compress`` and ``DmrgFCISolver`` (``tests/test_mps.py``'s
protocols) against their oracles; OFS that swaps, in DMRG and in
TDVP-PS2, against dense oracles; and the JAX package's OFS DMRG on the same
start (its one JAX job)."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import GS_E
import renormalizer_tpu as rj
import renormalizer_tpu.model as jm
from renormalizer_tpu.model import h_qc as jh_qc
import renormalizer_tpu_torch as rt
import renormalizer_tpu_torch.model as tm
from renormalizer_tpu_torch import CompressConfig, CompressCriteria, Model, Mpo, Mps, Op
from renormalizer_tpu_torch.model import h_qc
from renormalizer_tpu_torch.mps import DmrgFCISolver, StackedMpo
from renormalizer_tpu_torch.mps import mpo as mpo_module
from renormalizer_tpu_torch.mps.gs import construct_mps_mpo, optimize_mps
from renormalizer_tpu_torch.mps.mp import to_numpy
from renormalizer_tpu_torch.utils import OFS, EvolveConfig, EvolveMethod, OptimizeConfig
from renormalizer_tpu_torch.utils.oracle import dense_hamiltonian, dense_operator, sector_indices
from test_torch_dmrg import port_model

torch.set_num_threads(2)

H2O_FCIDUMP = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "data", "h2o_fcidump.txt")
H2O_FCI = -75.008697516450


def _integrals(n=3, seed=5):
    """``tests/test_qc.py``'s random integrals with the 8-fold symmetry."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n))
    h = (h + h.T) / 2
    c = rng.standard_normal((4, n, n))
    c = (c + c.transpose(0, 2, 1)) / 2
    return h, np.einsum("mij,mkl->ijkl", c, c) * 0.2


def _term_key(op):
    return (op.symbol, str(op.dofs), op.factor, str(np.asarray(op.qn_list).tolist()))


@pytest.mark.parametrize("stacked", [False, True])
def test_fcidump_and_qc_model_match_jax(stacked):
    """``read_fcidump`` of the vendored H2O file, ``int_to_h`` and
    ``qc_model`` (grouped per leading orbital with ``stacked``): the JAX
    package's integrals, nuclear repulsion, bases and terms (symbol, DoFs,
    factor and the two-component quantum numbers), term by term."""
    sh, aseri, nuc = h_qc.read_fcidump(H2O_FCIDUMP, 7)
    jsh, jaseri, jnuc = jh_qc.read_fcidump(H2O_FCIDUMP, 7)
    np.testing.assert_array_equal(sh, jsh)
    np.testing.assert_array_equal(aseri, jaseri)
    assert nuc == jnuc == pytest.approx(9.307155269556182, abs=1e-12)
    h, eri = _integrals()
    for a, b in zip(h_qc.int_to_h(h, eri), jh_qc.int_to_h(h, eri)):
        np.testing.assert_array_equal(a, b)
    basis, terms = h_qc.qc_model(sh, aseri, stacked=stacked)
    jbasis, jterms = jh_qc.qc_model(jsh, jaseri, stacked=stacked)
    assert [np.asarray(b.sigmaqn).tolist() for b in basis] == \
        [np.asarray(b.sigmaqn).tolist() for b in jbasis]
    assert np.asarray(basis[0].sigmaqn).tolist() == [[0, 0], [1, 0]]
    assert np.asarray(basis[1].sigmaqn).tolist() == [[0, 0], [0, 1]]
    if stacked:
        assert [len(t) for t in terms] == [len(t) for t in jterms]
        terms = [t for group in terms for t in group]
        jterms = [t for group in jterms for t in group]
    assert [_term_key(t) for t in terms] == [_term_key(t) for t in jterms]
    ops, jops = h_qc.generate_ladder_operator(4), jh_qc.generate_ladder_operator(4)
    for a, b in zip(ops, jops):
        assert [_term_key(o) for o in a] == [_term_key(o) for o in b]
    for conserve in (False, True):
        assert _term_key(h_qc.simplify_op(ops[1][3] * ops[0][1], 4, conserve)) == \
            _term_key(jh_qc.simplify_op(jops[1][3] * jops[0][1], 4, conserve))


def test_h2o_mpo_matches_jax():
    """``Mpo(model)`` of H2O (14 sites, 1140 terms): the JAX package's bond
    dimensions, quantum numbers and site tensors."""
    sh, aseri, _ = h_qc.read_fcidump(H2O_FCIDUMP, 7)
    basis, terms = h_qc.qc_model(sh, aseri)
    mpo = Mpo(Model(basis, terms))
    jbasis, jterms = jh_qc.qc_model(sh, aseri)
    jmpo = rj.Mpo(jm.Model(jbasis, jterms))
    assert mpo.bond_dims == jmpo.bond_dims
    assert mpo.bond_dims == [1, 4, 16, 33, 46, 71, 92, 77, 60, 69, 54, 33, 16, 4, 1]
    for q, jq in zip(mpo.qn, jmpo.qn):
        np.testing.assert_array_equal(np.asarray(q), np.asarray(jq))
    for mt, mj in zip(mpo, jmpo):
        np.testing.assert_allclose(to_numpy(mt), np.asarray(mj), rtol=0, atol=1e-14)


def _qc(stacked, n=3, seed=5):
    h1e, h2e = h_qc.int_to_h(*_integrals(n, seed))
    basis, ham_terms = h_qc.qc_model(h1e, h2e, stacked=stacked)
    if not stacked:
        model = Model(basis, ham_terms)
        return model, Mpo(model)
    model = Model(basis, [t for terms in ham_terms for t in terms])
    return model, StackedMpo([Mpo(Model(basis, terms)) for terms in ham_terms])


def _fci(model, nelec):
    hd = dense_hamiltonian(model)
    sec = sector_indices(model, nelec)
    return np.linalg.eigvalsh(hd[np.ix_(sec, sec)])[0]


@pytest.mark.parametrize("stacked", [False, True])
def test_qc_dmrg(stacked):
    """``tests/test_qc.py::test_qc_dmrg``: 2-site DMRG of the 3-orbital
    model with [1, 1] electrons (two-component quantum numbers) within 1e-8
    of the dense FCI energy, with one Mpo or a StackedMpo of one Mpo per
    leading orbital (one environment each, the hops summed)."""
    model, mpo = _qc(stacked)
    if stacked:
        assert len(mpo.mpos) == 6
    mps = Mps.random(model, [1, 1], 16, percent=1.0)
    mps.optimize_config = OptimizeConfig(
        procedure=[[16, 0.4], [16, 0.2], [16, 0.1], [16, 0], [16, 0], [16, 0]])
    mps.optimize_config.method = "2site"
    energies, opt = optimize_mps(mps, mpo)
    e = min(np.min(np.asarray(x)) for x in energies)
    assert abs(e - _fci(model, [1, 1])) < 1e-8
    np.testing.assert_array_equal(opt.qntot, [1, 1])


def test_qc_dmrg_h2o():
    """``tests/test_qc.py::test_qc_dmrg_h2o``: H2O/STO-3G at M=50, 2-site,
    within 1e-8 of the published FCI energy (nuclear repulsion added)."""
    h1e, h2e, nuc = h_qc.read_fcidump(H2O_FCIDUMP, 7)
    basis, ham_terms = h_qc.qc_model(h1e, h2e)
    model = Model(basis, ham_terms)
    m = 50
    mps = Mps.random(model, [5, 5], m, percent=1.0)
    mps.optimize_config = OptimizeConfig(procedure=[[m, 0.4], [m, 0.2], [m, 0.1]] + [[m, 0]] * 6)
    mps.optimize_config.method = "2site"
    energies, opt = optimize_mps(mps, Mpo(model))
    e = min(float(np.min(np.asarray(x))) for x in energies) + nuc
    assert abs(e - H2O_FCI) < 1e-8
    assert max(opt.bond_dims) <= m


def test_dmrg_stacked_mpo():
    """``tests/test_mps.py::test_dmrg_stacked_mpo``: the Holstein fixture's
    terms split into two MPOs; the summed eigenproblem reaches GS_E."""
    model = port_model()
    half = len(model.ham_terms) // 2
    stacked = StackedMpo([Mpo(model, model.ham_terms[:half]),
                          Mpo(model, model.ham_terms[half:])])
    mps, _ = construct_mps_mpo(model, 10, 1)
    mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [30, 0], [30, 0]]
    energies, _ = optimize_mps(mps.copy(), stacked)
    assert min(energies) == pytest.approx(GS_E, rel=1e-4)
    with pytest.raises(NotImplementedError, match="StackedMpo"):
        optimize_mps(mps.copy(), stacked, omega=0.1)


def test_variational_compress():
    """``tests/test_mps.py::test_variational_compress``: the sweeping fit of
    mpo @ mps against the exact dense product (1e-10), also through
    ``Mpo.contract(algo="variational")``."""
    ph = rt.Phonon.simple_phonon(rt.Quantity(1), rt.Quantity(1), 2)
    model = rt.HolsteinModel([rt.Mol(rt.Quantity(0), [ph])] * 3, rt.Quantity(1), 3)
    mpo = Mpo(model)
    small = Mps.random(model, 1, 12)
    small.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=24)
    dense_big = (mpo @ small).todense()
    for comp in (small.variational_compress(mpo), mpo.contract(small, algo="variational")):
        err = np.linalg.norm(comp.todense() - dense_big) / np.linalg.norm(dense_big)
        assert err < 1e-10
    with pytest.raises(NotImplementedError):
        small.variational_compress()


def test_ofs():
    """``tests/test_mps.py::test_ofs``: OFS-S on the scheme-1 Holstein chain
    (as a generic Model: OFS raises on a HolsteinModel) reaches GS_E.  As
    in the JAX package, the procedure's integer entries replace the compress
    config and with it ``ofs``, so no swap is tried here; the swaps run in
    the two tests below."""
    model1 = port_model().switch_scheme(1)
    mps, mpo = construct_mps_mpo(model1, 10, 1)
    mps.model = Model(mps.model.basis, mps.model.ham_terms)
    mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]
    mps.optimize_config.method = "2site"
    mps.compress_config.ofs = OFS.ofs_s
    energies, mps_opt = optimize_mps(mps.copy(), mpo)
    assert abs(energies[-1] - GS_E) / GS_E < 1e-5
    assert abs(mps_opt.expectation(Mpo(mps_opt.model)) - GS_E) / GS_E < 1e-5


@pytest.mark.parametrize("ofs", [OFS.ofs_s, OFS.ofs_d, OFS.ofs_ds])
def test_ofs_swaps_on_the_scheme1_chain(ofs, monkeypatch):
    """``test_ofs``'s chain and procedure with OFS given through the
    procedure's compress configs, so that it runs: the sweeps swap sites and
    the energy of the last sweep and of the reordered chain reach GS_E
    (1e-5, ``test_ofs``'s bound)."""
    swaps = _count_swaps(monkeypatch)
    model1 = port_model().switch_scheme(1)
    mps, mpo = construct_mps_mpo(model1, 10, 1)
    mps.model = Model(mps.model.basis, mps.model.ham_terms)
    mps.optimize_config.procedure = [
        [CompressConfig(CompressCriteria.fixed, max_bonddim=m, ofs=ofs), p]
        for m, p in ((10, 0.4), (20, 0.2), (30, 0.1), (40, 0), (40, 0))]
    mps.optimize_config.method = "2site"
    energies, mps_opt = optimize_mps(mps.copy(), mpo)
    assert swaps
    assert abs(energies[-1] - GS_E) / GS_E < 1e-5
    assert abs(mps_opt.expectation(Mpo(mps_opt.model)) - GS_E) / GS_E < 1e-5


def test_eigh_wide_solves_float32_in_double():
    """The small dense eigensolves of DMRG run in double precision and
    return the input's precision: the eigenvalues of a float32 matrix of
    norm ~84 (the H2O local problems') are the float32 rounding of the
    float64 solve of the same matrix."""
    from renormalizer_tpu_torch.lib.solvers import eigh_wide

    rng = np.random.default_rng(7)
    a = rng.standard_normal((66, 66))
    a = torch.as_tensor((a + a.T) * 3.0 - 84.0 * np.eye(66), dtype=torch.float32)
    w, v = eigh_wide(a)
    assert w.dtype == torch.float32 and v.dtype == torch.float32
    w64 = torch.linalg.eigvalsh(a.double())
    assert torch.equal(w, w64.float())
    assert float((v.double().T @ v.double() - torch.eye(66, dtype=torch.float64)).abs().max()) < 1e-6


def _paired_spins(m, n=6):
    """Spins i and i + n/2 coupled by a Heisenberg term, a weak field on
    each: in the order 0..n-1 every pair crosses the middle bond, so OFS
    has swaps to make."""
    terms = []
    for i in range(n // 2):
        j = i + n // 2
        terms += [m.Op("sigma_z sigma_z", [i, j], 1.0), m.Op("sigma_+ sigma_-", [i, j], 0.5),
                  m.Op("sigma_- sigma_+", [i, j], 0.5)]
    terms += [m.Op("sigma_x", i, 0.05 * (i + 1)) for i in range(n - 1)]
    return m.Model([m.BasisHalfSpin(i) for i in range(n)], terms)


def _ofs_procedure(cc_cls, crit, ofs):
    def cc(m):
        return cc_cls(crit.fixed, max_bonddim=m, ofs=ofs)

    return [[cc(4), 0.4], [cc(4), 0.2]] + [[cc(8), 0]] * 4


def _count_swaps(monkeypatch):
    swaps = []
    orig = mpo_module.Mpo.try_swap_site

    def counting(self, new_model, swap_jw, algo="Hopcroft-Karp"):
        if any(a.dofs != b.dofs for a, b in zip(self.model.basis, new_model.basis)):
            swaps.append([b.dofs[0] for b in new_model.basis])
        return orig(self, new_model, swap_jw, algo)

    monkeypatch.setattr(mpo_module.Mpo, "try_swap_site", counting)
    return swaps


@pytest.mark.parametrize("ofs", [OFS.ofs_s, OFS.ofs_d, OFS.ofs_ds])
def test_ofs_swaps_in_dmrg(ofs, monkeypatch):
    """OFS given through the procedure's compress configs: the sweeps swap
    sites (the singular values of both orders from ``compress``'s SVD on the
    device), the MPO follows each swap, and the ground state of the
    reordered chain is the dense one (1e-10); the JAX package's OFS DMRG from
    the same start reaches the same energy (its order may differ: the
    entropies tie)."""
    swaps = _count_swaps(monkeypatch)
    model = _paired_spins(tm)
    e_dense = np.linalg.eigvalsh(dense_hamiltonian(model))[0]
    mpo = Mpo(model, algo="Hopcroft-Karp")
    mps = Mps.random(model, 0, 8, percent=1.0)
    mps.optimize_config = OptimizeConfig(
        procedure=_ofs_procedure(rt.CompressConfig, rt.CompressCriteria, ofs))
    mps.optimize_config.method = "2site"
    energies, opt = optimize_mps(mps, mpo)
    assert swaps
    assert sorted(b.dofs[0] for b in opt.model.basis) == list(range(6))
    assert abs(min(energies) - e_dense) < 1e-10
    assert abs(opt.expectation(Mpo(opt.model)) - e_dense) < 1e-10
    if ofs is OFS.ofs_s:
        from renormalizer_tpu.mps.gs import optimize_mps as jax_optimize_mps
        from renormalizer_tpu.utils import OFS as JOFS

        jmodel = _paired_spins(jm)
        jmps = rj.Mps.random(jmodel, 0, 8, percent=1.0)
        jmps.optimize_config = rj.OptimizeConfig(
            procedure=_ofs_procedure(rj.CompressConfig, rj.CompressCriteria, JOFS.ofs_s))
        jmps.optimize_config.method = "2site"
        jenergies, _ = jax_optimize_mps(jmps, rj.Mpo(jmodel, algo="Hopcroft-Karp"))
        assert abs(min(jenergies) - min(energies)) < 1e-10


def test_tdvp_ps2_with_ofs_against_dense(monkeypatch):
    """TDVP-PS2 with OFS-S on the paired chain from a product state: the
    steps swap sites (``try_swap_site`` after each update) and every spin's
    <sigma_z>, read by DoF from the reordered chain, follows
    ``scipy.linalg.expm`` of the dense Hamiltonian (1e-6 after 8 steps of
    0.1 at the chain's exact bond dimension)."""
    swaps = _count_swaps(monkeypatch)
    model = _paired_spins(tm)
    h = dense_hamiltonian(model)
    condition = {i: i % 2 for i in range(6)}
    mps = Mps.hartree_product_state(model, condition)
    psi0 = mps.todense().astype(complex)
    mps.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=8,
                                         ofs=OFS.ofs_s)
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps2)
    mps = mps.expand_bond_dimension(Mpo(model), include_ex=False)
    mpo = Mpo(model, algo="Hopcroft-Karp")
    dt, nsteps = 0.1, 8
    for _ in range(nsteps):
        mps = mps.evolve(mpo, dt)
    assert swaps
    psi = scipy.linalg.expm(-1j * h * dt * nsteps) @ psi0
    for dof in range(6):
        dense = np.real(psi.conj() @ dense_operator(model, [Op("sigma_z", dof)]) @ psi)
        got = mps.expectation(Mpo(mps.model, Op("sigma_z", dof)))
        assert abs(got - dense) < 1e-6


def test_dmrg_fci_solver():
    """``tests/test_mps.py::test_dmrg_fci_solver``: the energy rebuilt from
    the solver's own spin-traced 1- and 2-RDMs (1e-8), tr rdm1 = nelec, and
    the energy the dense FCI of the same integrals (1e-8).  pyscf is not
    installed, so its ImportError branch runs; ``spin_square`` raises as in
    the JAX package."""
    rng = np.random.default_rng(3)
    n = 2
    h1 = rng.standard_normal((n, n))
    h1 = (h1 + h1.T) / 2
    c = rng.standard_normal((3, n, n))
    c = (c + c.transpose(0, 2, 1)) / 2
    h2 = np.einsum("mij,mkl->ijkl", c, c) * 0.3
    solver = DmrgFCISolver()
    e, _ = solver.kernel(h1, h2, n, (1, 1))
    rdm1, rdm2 = solver.make_rdm12(None, n, (1, 1))
    assert abs(np.trace(rdm1) - 2) < 1e-8
    e_rdm = np.einsum("ij,ij->", h1, rdm1) + 0.5 * np.einsum("ijkl,ijkl->", h2, rdm2)
    assert abs(e_rdm - e) < 1e-8
    basis, terms = h_qc.qc_model(*h_qc.int_to_h(h1, h2))
    assert abs(e - _fci(Model(basis, terms), [1, 1])) < 1e-8
    with pytest.raises(NotImplementedError):
        solver.spin_square(None, n, (1, 1))
