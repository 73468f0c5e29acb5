"""The port's host layers against the JAX package's, fp64 on the CPU.

The numpy copies (``utils/elementop.py``, ``utils/oracle.py``, the bases
``BasisHopsBoson``, ``BasisSineDVR``, ``BasisMultiElectron`` and
``BasisDummy``, ``heisenberg_ops``, ``load_from_dict``) must give what the
JAX package's give on the same inputs; ``Mps.ground_state(condition=)``,
``from_mp``, ``pbond_dims``, ``dot_ob``, ``nexciton``, ``Mpo.digest`` and
the OFS site swap (``symbolic_mpo.swap_site`` through ``Mpo.try_swap_site``)
against the JAX package's objects and dense matrices.  Nothing here runs a
JAX job."""

import numpy as np
import pytest
import torch

import renormalizer_tpu as rj
import renormalizer_tpu.model as jm
import renormalizer_tpu.utils.elementop as jelementop
import renormalizer_tpu.utils.oracle as joracle
import renormalizer_tpu_torch as rt
import renormalizer_tpu_torch.model as tm
import renormalizer_tpu_torch.utils.elementop as telementop
import renormalizer_tpu_torch.utils.oracle as toracle
from renormalizer_tpu_torch.mps.mp import to_numpy

torch.set_num_threads(2)

PH_OPS = ["b", r"b^\dagger", r"b^\dagger b", r"b^\dagger + b", "Iden",
          r"(b^\dagger + b)^2", r"(b^\dagger + b)^3"]
E_OPS = ["a", r"a^\dagger", r"a^\dagger a", "Iden", "sigma_x", "sigma_y", "sigma_z"]


@pytest.mark.parametrize("size", [2, 5])
def test_elementop_matches_jax(size):
    """Operator matrices and elements: exactly the JAX package's."""
    for op in PH_OPS:
        np.testing.assert_array_equal(telementop.ph_op_matrix(op, size),
                                      jelementop.ph_op_matrix(op, size))
        for i in range(size):
            for j in range(size):
                assert telementop.ph_element_op(op, i, j) == jelementop.ph_element_op(op, i, j)
    for op in E_OPS:
        np.testing.assert_array_equal(telementop.e_op_matrix(op), jelementop.e_op_matrix(op))
        assert telementop.e_element_op(op, 1, 0) == jelementop.e_element_op(op, 1, 0)
    tdict, jdict = telementop.construct_ph_op_dict(size), jelementop.construct_ph_op_dict(size)
    assert tdict.keys() == jdict.keys()
    for k in tdict:
        np.testing.assert_array_equal(tdict[k], jdict[k])
    with pytest.raises(ValueError):
        telementop.ph_op_matrix("q", size)


@pytest.mark.parametrize("limit", [None, 1024, "3 kb", "1.5 GB", "2 mb"])
def test_parse_memory_limit_matches_jax(limit):
    from renormalizer_tpu.utils import parse_memory_limit as jparse
    from renormalizer_tpu_torch.utils import parse_memory_limit

    assert parse_memory_limit(limit) == jparse(limit)
    with pytest.raises(ValueError):
        parse_memory_limit("lots")


def _sbm(pkg, m):
    """A 2-mode spin-boson model on a BasisHalfSpin and two BasisSHO."""
    basis = [m.BasisHalfSpin("spin"), m.BasisSHO("v0", 0.5, 3), m.BasisSHO("v1", 1.5, 3)]
    terms = [m.Op("sigma_z", "spin", 0.3), m.Op("sigma_x", "spin", 0.1)]
    for i, w in enumerate((0.5, 1.5)):
        terms += [m.Op(r"b^\dagger b", f"v{i}", w),
                  m.Op(r"sigma_z b^\dagger+b", ["spin", f"v{i}"], 0.2 * (i + 1))]
    return m.Model(basis, terms)


def test_oracle_matches_jax():
    """``dense_hamiltonian``, ``dense_operator`` and ``sector_indices`` of
    the same model in both packages (``sector_indices`` on a Holstein chain
    whose states carry an exciton number)."""
    tmodel, jmodel = _sbm(rt, tm), _sbm(rj, jm)
    np.testing.assert_allclose(toracle.dense_hamiltonian(tmodel),
                               joracle.dense_hamiltonian(jmodel), rtol=0, atol=1e-15)
    op = [tm.Op("sigma_z", "spin")]
    np.testing.assert_array_equal(toracle.dense_operator(tmodel, op),
                                  joracle.dense_operator(jmodel, [jm.Op("sigma_z", "spin")]))
    tph = rt.Phonon.simple_phonon(rt.Quantity(1), rt.Quantity(1), 2)
    jph = rj.Phonon.simple_phonon(rj.Quantity(1), rj.Quantity(1), 2)
    thol = rt.HolsteinModel([rt.Mol(rt.Quantity(0), [tph])] * 3, rt.Quantity(1), 3)
    jhol = rj.HolsteinModel([jm.Mol(rj.Quantity(0), [jph])] * 3, rj.Quantity(1), 3)
    for n in (0, 1, 2):
        np.testing.assert_array_equal(toracle.sector_indices(thol, n),
                                      joracle.sector_indices(jhol, n))
    assert len(toracle.sector_indices(thol, 1)) == 3 * 2 ** 3


def _basis_cases(m):
    return [
        (m.BasisHopsBoson("h", 5), [r"b^\dagger b", r"\tilde{b}^\dagger", r"\tilde{b}", "I"]),
        (m.BasisSineDVR("x", 8, -2.0, 3.0),
         ["I", "x", "x^2", "x^3", "x x", "dx", "dx^2", "p", "p^2", "x dx",
          "x^2 dx", "x^2 p^2", "x p^2", "x^3 p^2", "x dx^2", "x^2 dx^2",
          "x^3 dx^2", "partialx"]),
        (m.BasisSineDVR("y", 6, -1.0, 1.0, endpoint=True, dvr=True),
         ["I", "x", "x^2", "dx", "p^2", "x dx"]),
        (m.BasisDummy("d"), ["I"]),
    ]


@pytest.mark.parametrize("case", range(4))
def test_bases_op_mat_match_jax(case):
    """``op_mat`` of the four bases this slice adds, symbol by symbol, with
    a factor: the JAX package's matrices to 1e-13 (the same numpy
    arithmetic)."""
    (tb, syms), (jb, _) = _basis_cases(tm)[case], _basis_cases(jm)[case]
    assert tb.nbas == jb.nbas
    np.testing.assert_array_equal(tb.sigmaqn, jb.sigmaqn)
    for sym in syms:
        np.testing.assert_allclose(tb.op_mat(tm.Op(sym, tb.dof, 0.7)),
                                   jb.op_mat(jm.Op(sym, jb.dof, 0.7)), rtol=0, atol=1e-13)
    if isinstance(tb, tm.BasisSineDVR):
        np.testing.assert_allclose(tb.dvr_x, jb.dvr_x, rtol=0, atol=0)
        np.testing.assert_allclose(tb.dvr_v, jb.dvr_v, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tb.op_mat(tm.Op("q dx^3", tb.dof))


def test_multi_electron_basis_and_ground_state_condition():
    """``BasisMultiElectron``'s matrices as the JAX package's, and
    ``Mps.ground_state`` with ``condition`` on it (a state index and an
    amplitude vector of quantum number 0) giving the JAX package's dense
    state."""
    def build(pkg, m):
        basis = [m.BasisMultiElectron(["e0", "e1", "e2"], [0, 0, 1]),
                 m.BasisSHO("v", 1.0, 3)]
        terms = [m.Op(r"a^\dagger a", ["e0", "e1"], 0.4),
                 m.Op(r"a^\dagger a", ["e1", "e0"], 0.4),
                 m.Op(r"a^\dagger a", ["e2", "e2"], 0.2),
                 m.Op(r"b^\dagger b", "v", 1.0)]
        return m.Model(basis, terms)

    tmodel, jmodel = build(rt, tm), build(rj, jm)
    for sym, dofs in ((r"a^\dagger a", ["e0", "e2"]), ("a a^\\dagger", ["e1", "e0"]),
                      ("I I", ["e0", "e0"])):
        np.testing.assert_array_equal(tmodel.basis[0].op_mat(tm.Op(sym, dofs, 2.0)),
                                      jmodel.basis[0].op_mat(jm.Op(sym, dofs, 2.0)))
    with pytest.raises(ValueError, match="BasisMultiElectronVac"):
        tmodel.basis[0].op_mat(tm.Op("a", "e0"))
    np.testing.assert_allclose(toracle.dense_hamiltonian(tmodel),
                               joracle.dense_hamiltonian(jmodel), rtol=0, atol=1e-15)
    for condition in ({"e0": 1}, {"e0": np.array([0.6, 0.8, 0.0])}):
        for entangled in (False, True):
            tgs = rt.Mps.ground_state(tmodel, entangled, condition=dict(condition))
            jgs = rj.Mps.ground_state(jmodel, entangled, condition=dict(condition))
            np.testing.assert_allclose(tgs.todense(), np.asarray(jgs.todense()),
                                       rtol=0, atol=1e-15)
    with pytest.raises(AssertionError):
        rt.Mps.ground_state(tmodel, False)


def test_heisenberg_ops_and_load_from_dict():
    """The module functions ``heisenberg_ops`` and ``load_from_dict``: the
    JAX package's terms and the same Holstein model (terms, local
    dimensions, temperature)."""
    def key(op):
        return (op.symbol, str(op.dofs), op.factor)

    assert [key(o) for o in tm.heisenberg_ops(5)] == [key(o) for o in jm.heisenberg_ops(5)]
    spins = [tm.BasisHalfSpin(i) for i in range(4)]
    jspins = [jm.BasisHalfSpin(i) for i in range(4)]
    np.testing.assert_allclose(
        toracle.dense_hamiltonian(tm.Model(spins, tm.heisenberg_ops(4))),
        joracle.dense_hamiltonian(jm.Model(jspins, jm.heisenberg_ops(4))), rtol=0, atol=0)
    param = {"mol num": 2, "j constant": [0.05, "eV"], "temperature": [300, "K"],
             "ph modes": [[[500, "cm^{-1}"], [0.2, "a.u."]],
                          [[1500, "cm^{-1}"], [0.1, "a.u."]]]}
    for lam in (False, True):
        tmodel, ttemp = tm.load_from_dict(param, 3, lam)
        jmodel, jtemp = jm.load_from_dict(param, 3, lam)
        assert ttemp.as_au() == jtemp.as_au()
        assert tmodel.pbond_list == jmodel.pbond_list
        tterms, jterms = sorted(map(key, tmodel.ham_terms)), sorted(map(key, jmodel.ham_terms))
        assert [t[:2] for t in tterms] == [t[:2] for t in jterms]
        np.testing.assert_allclose([t[2] for t in tterms], [t[2] for t in jterms],
                                   rtol=1e-14, atol=0)


def test_from_mp_pbond_dims_dot_ob_nexciton():
    """``from_mp`` builds a chain with empty quantum numbers from site
    tensors (complex ones make it complex), ``pbond_dims`` is the model's,
    ``nexciton`` the total quantum number, and ``dot_ob`` of chains with
    open edge bonds equals the JAX package's."""
    model, jmodel = _sbm(rt, tm), _sbm(rj, jm)
    rng = np.random.default_rng(7)
    sites = [rng.standard_normal((2, 2, 3)), rng.standard_normal((3, 3, 2)),
             rng.standard_normal((2, 3, 2))]
    other = [rng.standard_normal((2, 2, 2)) + 1j * rng.standard_normal((2, 2, 2)),
             rng.standard_normal((2, 3, 3)), rng.standard_normal((3, 3, 2))]
    a, b = rt.Mps.from_mp(model, sites), rt.Mps.from_mp(model, other)
    ja, jb = rj.Mps.from_mp(jmodel, sites), rj.Mps.from_mp(jmodel, other)
    assert not a.is_complex and b.is_complex
    assert a.pbond_dims == ja.pbond_dims == [2, 3, 3]
    assert [q.shape for q in a.qn] == [np.asarray(q).shape for q in ja.qn]
    np.testing.assert_array_equal(a.nexciton, ja.nexciton)
    got = a.dot_ob(b).numpy()
    assert got.shape == (2, 2, 2, 2)
    np.testing.assert_allclose(got, np.asarray(ja.dot_ob(jb)), rtol=1e-13, atol=1e-13)
    hol = rt.Mps.random(rt.HolsteinModel([rt.Mol(rt.Quantity(0), [
        rt.Phonon.simple_phonon(rt.Quantity(1), rt.Quantity(1), 2)])] * 2,
        rt.Quantity(1), 3), 1, 4)
    np.testing.assert_array_equal(hol.nexciton, [1])


def _spinless_chain(m, perm=(0, 1, 2, 3)):
    """Jordan-Wigner spinless fermions on 4 sites (hopping, on-site
    energies and a density interaction) from ``qc_model``'s ladder
    operators, spelled ``sigma_z``/``sigma_+``/``sigma_-`` (the symbols the
    JW-aware swap rewrites), with the orbitals relabelled by ``perm``."""
    from itertools import product

    n = 4
    h1 = np.zeros((n, n))
    for i in range(n - 1):
        h1[i, i + 1] = h1[i + 1, i] = -1.0
    h1 += np.diag(np.linspace(-0.3, 0.3, n))
    h2 = np.zeros((n,) * 4)
    for p, q in product(range(n), repeat=2):
        if p < q:
            h2[p, q, q, p] = 0.5 / (q - p)
    perm = list(perm)
    basis, terms = m.h_qc.qc_model(h1[np.ix_(perm, perm)],
                                   h2[np.ix_(perm, perm, perm, perm)], conserve_qn=False)
    spelled = {"Z": "sigma_z", "+": "sigma_+", "-": "sigma_-"}
    terms = [m.Op(" ".join(spelled[s] for s in t.split_symbol), t.dofs, t.factor)
             for t in terms]
    return m.Model(basis, terms)


@pytest.mark.parametrize("swap_jw", [False, True])
def test_mpo_swap_site_matches_jax(swap_jw):
    """``Mpo.try_swap_site`` of sites 1 and 2 (``swap_site``, with and
    without the Jordan-Wigner rewrite): the swapped MPO equals the JAX
    package's swapped MPO site by site; as a dense matrix it is the original
    with the two sites' physical legs exchanged, or with the JW rewrite the
    MPO of the chain built in the swapped orbital order.  ``digest`` follows
    the JAX package's."""
    tmodel, jmodel = _spinless_chain(tm), _spinless_chain(jm)
    tmpo, jmpo = rt.Mpo(tmodel, algo="Hopcroft-Karp"), rj.Mpo(jmodel, algo="Hopcroft-Karp")
    assert tmpo.digest == pytest.approx(jmpo.digest, rel=1e-13)
    dense = tmpo.todense()

    def swapped(model, m):
        basis = model.basis.copy()
        basis[1], basis[2] = basis[2], basis[1]
        return m.Model(basis, model.ham_terms)

    tmpo.try_swap_site(swapped(tmodel, tm), swap_jw)
    jmpo.try_swap_site(swapped(jmodel, jm), swap_jw)
    assert [b.dofs for b in tmpo.model.basis] == [(0,), (2,), (1,), (3,)]
    assert tmpo.bond_dims == jmpo.bond_dims
    for mt, mj in zip(tmpo, jmpo):
        np.testing.assert_allclose(to_numpy(mt), np.asarray(mj), rtol=0, atol=1e-14)
    assert tmpo.digest == pytest.approx(jmpo.digest, rel=1e-13)
    if swap_jw:
        oracle = rt.Mpo(_spinless_chain(tm, (0, 2, 1, 3))).todense()
    else:
        perm = np.arange(16).reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).ravel()
        oracle = dense[np.ix_(perm, perm)]
    np.testing.assert_allclose(tmpo.todense(), oracle, rtol=0, atol=1e-13)
