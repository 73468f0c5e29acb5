"""The port's density matrices (``MpDm``), exact propagators and
``ThermalProp`` against the JAX package and dense oracles, fp64 on the CPU.

Model: ``tests/fixtures.py``'s ``exact_model`` (3 molecules, one 2-level
phonon each, J = 1).  An MpDm is a 4-leg chain whose dense form is the
operator rho (physical x ancilla); constructors, ``apply``, expectations and
``todense`` are held against dense linear algebra and against the JAX
package, ``ThermalProp`` against the dense thermal state (its P&C steps are
order-4 Taylor polynomials, reproduced densely to 1e-8).  The comparisons of
``ThermalProp`` (TDVP-PS) and of the expansion with the JAX package compile
hundreds of XLA programs and carry the ``slow`` marker:
``python -m pytest -m slow tests/test_torch_mpdm.py``."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import dense_hamiltonian, exact_model
import renormalizer_tpu as rj
from renormalizer_tpu.model import Model as JaxModel
from renormalizer_tpu_torch import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    HolsteinModel,
    MpDm,
    Mol,
    Mpo,
    Mps,
    Phonon,
    Quantity,
    ThermalProp,
    interop,
    load_thermal_state,
)

torch.set_num_threads(2)

TOL = 1e-8

jmodel = exact_model()
H_DENSE = dense_hamiltonian(jmodel)


def port_exact_model() -> HolsteinModel:
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


MODEL = port_exact_model()


def _dense(mp):
    return mp.todense() * mp.coeff


@pytest.mark.parametrize("kind", ["ex", "gs"])
def test_max_entangled_matches_jax(kind):
    """The T = inf density matrices: same dense operator, bonds, quantum
    numbers (on the bra index only) and ``coeff``; bond_dims_exact counts
    pbond^2 per site."""
    rho = getattr(MpDm, f"max_entangled_{kind}")(MODEL)
    jrho = getattr(rj.MpDm, f"max_entangled_{kind}")(jmodel)
    assert rho.is_mpdm and not rho.is_mps and not rho.is_mpo
    assert rho.bond_dims == jrho.bond_dims
    np.testing.assert_allclose(_dense(rho), _dense(jrho), atol=1e-15)
    for q, jq in zip(rho.qn, jrho.qn):
        np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(rho._get_sigmaqn(0), jrho._get_sigmaqn(0))
    np.testing.assert_array_equal(rho.bond_dims_exact, jrho.bond_dims_exact)
    assert rho.bond_dims_exact[1] == 4
    assert "mpdm" in str(rho)


def test_from_mps_embeds_the_diagonal():
    mps = Mpo.onsite(MODEL, r"a^\dagger", dof_set=[1]) @ Mps.ground_state(MODEL, False)
    rho = MpDm.from_mps(mps)
    vec = mps.todense()
    np.testing.assert_allclose(rho.todense(), np.diag(vec), atol=1e-15)


def test_apply_add_and_expectation_against_dense():
    """rho @ mpo (ancilla side), mpo @ rho (physical side), rho + rho and
    the ancilla-traced expectation Tr(rho^H O rho)."""
    rho = MpDm.max_entangled_ex(MODEL)
    r = _dense(rho)
    h = Mpo(MODEL)
    occ = Mpo.onsite(MODEL, r"a^\dagger a", dof_set=[0])
    np.testing.assert_allclose(_dense(rho.apply(occ)), r @ occ.todense(), atol=1e-14)
    applied = h.apply(rho)
    assert applied.is_mpdm
    np.testing.assert_allclose(_dense(applied), H_DENSE @ r, atol=1e-13)
    both = rho.apply(occ) + h.apply(rho, canonicalise=True)
    np.testing.assert_allclose(_dense(both), r @ occ.todense() + H_DENSE @ r, atol=1e-13)
    assert rho.expectation(h) == pytest.approx(
        np.trace(r.conj().T @ H_DENSE @ r).real, abs=1e-13)
    np.testing.assert_allclose(rho.e_occupations, [1 / 3] * 3, atol=1e-14)


@pytest.mark.parametrize("space", ["GS", "EX"])
@pytest.mark.parametrize("x", [-0.3, -0.3j], ids=["imag_time", "real_time"])
def test_exact_propagator_matches_jax(space, x):
    prop = Mpo.exact_propagator(MODEL, x, space=space, shift=0.25)
    jprop = rj.Mpo.exact_propagator(jmodel, x, space=space, shift=0.25)
    assert prop.is_complex == jprop.is_complex
    np.testing.assert_allclose(prop.todense(), jprop.todense(), atol=1e-14)


def test_exact_propagator_gs_is_the_phonon_exponential():
    """In the GS space the local Hamiltonian is sum omega b^dagger b."""
    hph = dense_hamiltonian(JaxModel(jmodel.basis, [
        rj.Op(r"b^\dagger b", d, 1.0) for d in jmodel.v_dofs]))
    prop = Mpo.exact_propagator(MODEL, -0.7, space="GS")
    np.testing.assert_allclose(prop.todense(), np.diag(np.exp(-0.7 * np.diag(hph))),
                               atol=1e-14)


def test_evolve_exact_matches_jax():
    """``evolve_exact`` of an Mps and of an MpDm (propagator on the ancilla
    side) from carried states."""
    h, jh = Mpo(MODEL, offset=Quantity(0.1)), rj.Mpo(jmodel, offset=rj.Quantity(0.1))
    jmps = rj.Mpo.onsite(jmodel, r"a^\dagger", dof_set=[0]) @ rj.Mps.ground_state(jmodel, False)
    jrho = rj.MpDm.max_entangled_ex(jmodel)
    for jstate, state in ((jmps, interop.mps_from_object(MODEL, jmps)),
                          (jrho, interop.mpdm_from_object(MODEL, jrho))):
        for space in ("GS", "EX"):
            out = state.evolve_exact(h, 0.4, space, shift=0.2)
            jout = jstate.evolve_exact(jh, 0.4, space, shift=0.2)
            np.testing.assert_allclose(_dense(out), _dense(jout), atol=1e-13)


def test_intersite_and_ph_onsite_match_jax():
    e_opera, ph_opera = {0: r"a^\dagger", 2: "a"}, {(1, 0): "b"}
    op = Mpo.intersite(MODEL, e_opera, ph_opera, Quantity(0.3))
    jop = rj.Mpo.intersite(jmodel, e_opera, ph_opera, rj.Quantity(0.3))
    np.testing.assert_allclose(op.todense(), jop.todense(), atol=1e-15)
    for opera in ("b", r"b^\dagger", r"b^\dagger b"):
        np.testing.assert_allclose(Mpo.ph_onsite(MODEL, opera, 2).todense(),
                                   rj.Mpo.ph_onsite(jmodel, opera, 2).todense(),
                                   atol=1e-15)


BETA = 0.6
INSTEPS = 3


def _taylor4(h, x):
    """Sum_{k<=4} (x h)^k / k!, one P&C step of a time-independent h."""
    term, out = np.eye(len(h)), np.eye(len(h))
    for k in range(1, 5):
        term = term @ (x * h) / k
        out = out + term
    return out


def test_thermal_prop_pc_against_dense():
    """``ThermalProp`` with its default P&C steps on the 2-molecule chain
    at bond dimension 16, its exact one: each step is the dense order-4
    Taylor step of exp(-tau (H - E)) with E the previous step's energy,
    then normalized; energies and occupations within 1e-8, the thermal
    occupations summing to one and the energy falling."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 2, Quantity(1), 3)
    jph = rj.Phonon.simple_phonon(rj.Quantity(1), rj.Quantity(1), 2)
    jmodel2 = rj.HolsteinModel([rj.Mol(rj.Quantity(0), [jph])] * 2, rj.Quantity(1), 3)
    h = dense_hamiltonian(jmodel2)
    rho = MpDm.max_entangled_ex(model)
    rho.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=16)
    tp = ThermalProp(rho)
    tp.evolve(None, INSTEPS, BETA / 2j)
    occ = [dense_hamiltonian(JaxModel(jmodel2.basis, [rj.Op(r"a^\dagger a", d)]))
           for d in jmodel2.e_dofs]
    r = _dense(MpDm.max_entangled_ex(model))
    energies, occupations = [np.trace(r.T @ h @ r)], []
    for _ in range(INSTEPS):
        r = _taylor4(h - energies[-1] * np.eye(len(r)), -BETA / 2 / INSTEPS) @ r
        r /= np.linalg.norm(r)
        energies.append(np.trace(r.T @ h @ r))
        occupations.append([np.trace(r.T @ o @ r) for o in occ])
    np.testing.assert_allclose(tp.energies, energies, atol=TOL, rtol=0)
    np.testing.assert_allclose(tp.e_occupations_array[1:], occupations, atol=TOL, rtol=0)
    np.testing.assert_allclose(_dense(tp.latest_mps), r, atol=TOL)
    assert tp.latest_mps.is_mpdm and not tp.latest_mps.is_complex
    assert tp.e_occupations_array[-1].sum() == pytest.approx(1.0, abs=1e-12)
    assert tp.energies[-1] < tp.energies[0]
    assert tp.get_dump_dict()["time series"] == pytest.approx([0, 0.1, 0.2, 0.3])


def test_expanded_density_matrix_is_the_same_operator():
    """``expand_bond_dimension`` of an MpDm with the Hamiltonian as hint
    (what ``ThermalProp`` starts TDVP-PS from): bonds grown to M = 8, the
    operator unchanged up to the 1e-10 padding, real, on the bra-index
    quantum numbers."""
    rho = MpDm.max_entangled_ex(MODEL).canonicalise()
    rho.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=8)
    expanded = rho.expand_bond_dimension(Mpo(MODEL))
    assert expanded.is_mpdm and not expanded.is_complex
    assert max(expanded.bond_dims) == 8 and max(rho.bond_dims) == 2
    np.testing.assert_allclose(_dense(expanded), _dense(rho), atol=1e-9)


def test_thermal_prop_tdvp_against_dense():
    """TDVP-PS from the expanded start at this chain's exact bond dimension
    follows the dense thermal state to the projection error of three steps
    of 0.1 (measured 2e-6 in the occupations)."""
    tp = ThermalProp(MpDm.max_entangled_ex(MODEL),
                     evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
    tp.evolve(None, INSTEPS, BETA / 2j)
    occ = [dense_hamiltonian(JaxModel(jmodel.basis, [rj.Op(r"a^\dagger a", d)]))
           for d in jmodel.e_dofs]
    r = _dense(MpDm.max_entangled_ex(MODEL))
    r = scipy.linalg.expm(-BETA / 2 * H_DENSE) @ r
    r /= np.linalg.norm(r)
    dense = [np.trace(r.T @ o @ r) for o in occ]
    assert np.abs(tp.e_occupations_array[-1] - dense).max() < 1e-4


@pytest.fixture(scope="module")
def jax_thermal():
    """The JAX package's ThermalProp (TDVP-PS) from the T = inf state.
    ``auto_expand=False`` keeps the bonds at the start state's, all of them
    carrying weight: imaginary time amplifies by exp(dt |H|) the rounding of
    the QR that splits zero-weight padding directions, so from an expanded
    start the two packages agree only to ~6e-7 at dt = 0.1 on this model
    (``test_expanded_density_matrix_matches_jax`` holds the expansion)."""
    tp = rj.ThermalProp(rj.MpDm.max_entangled_ex(jmodel),
                        evolve_config=rj.EvolveConfig(rj.EvolveMethod.tdvp_ps),
                        auto_expand=False)
    tp.evolve(None, INSTEPS, BETA / 2j)
    return tp


@pytest.mark.slow
def test_thermal_prop_tdvp_matches_jax(jax_thermal):
    jtp = jax_thermal
    tp = ThermalProp(MpDm.max_entangled_ex(MODEL),
                     evolve_config=EvolveConfig(EvolveMethod.tdvp_ps), auto_expand=False)
    tp.evolve(None, INSTEPS, BETA / 2j)
    np.testing.assert_allclose(tp.energies, jtp.energies, atol=TOL, rtol=0)
    np.testing.assert_allclose(tp.e_occupations_array, jtp.e_occupations_array,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(tp.ph_occupations_array, jtp.ph_occupations_array,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_dense(tp.latest_mps), _dense(jtp.latest_mps), atol=TOL)
    assert set(tp.get_dump_dict()) == set(jtp.get_dump_dict())


@pytest.mark.slow
def test_expanded_density_matrix_matches_jax():
    """The expansion in both packages: the same operator up to the 1e-10
    padding, bonds grown to M = 8."""
    states = []
    for pkg, model in ((rj, jmodel), (None, MODEL)):
        cls = rj.MpDm if pkg else MpDm
        rho = cls.max_entangled_ex(model).canonicalise()
        rho.compress_config = (rj.CompressConfig(rj.CompressCriteria.fixed, max_bonddim=8)
                               if pkg else CompressConfig(CompressCriteria.fixed, max_bonddim=8))
        states.append(rho.expand_bond_dimension((rj.Mpo if pkg else Mpo)(model)))
    jrho, rho = states
    assert rho.is_mpdm and max(rho.bond_dims) == 8
    np.testing.assert_allclose(_dense(rho), _dense(jrho), atol=1e-9)


@pytest.mark.parametrize("space", ["GS", "EX"])
def test_thermal_prop_exact_matches_jax(space):
    """One exact step (the analytic local propagator) to beta / 2."""
    start = {"GS": "max_entangled_gs", "EX": "max_entangled_ex"}[space]
    tp = ThermalProp(getattr(MpDm, start)(MODEL), exact=True, space=space)
    tp.evolve(None, 1, 2.0 / 2j)
    jtp = rj.ThermalProp(getattr(rj.MpDm, start)(jmodel), exact=True, space=space)
    jtp.evolve(None, 1, 2.0 / 2j)
    np.testing.assert_allclose(tp.energies, jtp.energies, atol=TOL, rtol=0)
    np.testing.assert_allclose(_dense(tp.latest_mps), _dense(jtp.latest_mps), atol=TOL)


def test_thermal_state_dump_and_load(tmp_path):
    path = str(tmp_path / "rho.npz")
    assert load_thermal_state(MODEL, path) is None
    rho = MpDm.max_entangled_ex(MODEL).evolve_exact(Mpo(MODEL), 0.3, "GS")
    rho.dump(path)
    loaded = load_thermal_state(MODEL, path)
    assert isinstance(loaded, MpDm) and loaded.coeff == rho.coeff
    np.testing.assert_allclose(loaded.todense(), rho.todense(), atol=1e-15)


def test_thermal_prop_argument_checks():
    """The argument checks, and ``properties=``, which is taken now: a
    ``Property`` collector fills one entry per recorded step."""
    from renormalizer_tpu_torch.property import Property

    rho = MpDm.max_entangled_ex(MODEL)
    prop = Property(["e_rdm"], {})
    tp = ThermalProp(rho.copy(), exact=False, properties=prop)
    tp.evolve(None, 2, -0.1j)
    assert len(prop.prop_res["e_rdm"]) == len(tp.evolve_times) == 3
    assert np.trace(prop.prop_res["e_rdm"][-1]).real == pytest.approx(1.0, abs=1e-8)
    with pytest.raises(ValueError, match="space"):
        ThermalProp(rho, space="XX")
    tp = ThermalProp(rho, exact=True)
    with pytest.raises(AssertionError, match="negative imaginary"):
        tp.evolve(0.1, 1)
    with pytest.raises(ValueError, match="max_entangled"):
        MpDm.ground_state(MODEL, True)
