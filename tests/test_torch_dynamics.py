"""The port's charge-diffusion, property and spectral-function jobs and the
observables they read, fp64 on the CPU.

``ChargeDiffusionDynamics`` in the band limit against r^2 = 2 J^2 t^2 and,
with ``rdm=True``, against the JAX job on a 3-molecule chain;
``Property`` with ``e_ph_static_correlation`` under ``ThermalProp`` against
the dense thermal ensemble; ``SpectralFunctionZT`` on the 4-cell
``TI1DModel`` against a dense G(t); ``expectations`` with its
shared-environment cache against the plain loop; ``calc_2site_rdm``,
``calc_edof_rdm`` and the entropies against the JAX package on one carried
state (the protocols of ``tests/test_apps.py`` and
``tests/test_expectations_cache.py``)."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import dense_hamiltonian
import renormalizer_tpu as rj
import renormalizer_tpu.model as jm
import renormalizer_tpu.transport as jtransport
import renormalizer_tpu_torch as rt
import renormalizer_tpu_torch.model as tm
import renormalizer_tpu_torch.transport as ttransport
from renormalizer_tpu_torch import interop
from renormalizer_tpu_torch.mps import mps as port_mps
from renormalizer_tpu_torch.property import Property, ops as prop_ops

torch.set_num_threads(2)


def _sector(model, h, n=1):
    dims = model.pbond_list
    qn = np.array([sum(model.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
                       for i in range(len(dims))) for s in range(h.shape[0])])
    return np.nonzero(qn == n)[0]


def test_charge_diffusion_band_limit():
    """Free-electron charge diffusion: r^2(t) = 2 J^2 t^2 until the packet
    reaches the edge (``tests/test_apps.py:467-484``)."""
    mol_num = 13
    ph_list = [rt.Phonon.simple_phonon(rt.Quantity(1e-10, "cm-1"),
                                       rt.Quantity(1e-10, "a.u."), 4)]
    j_constant = rt.Quantity(0.8, "eV")
    model = rt.HolsteinModel([rt.Mol(rt.Quantity(0), ph_list)] * mol_num, j_constant, 3)
    ct = ttransport.ChargeDiffusionDynamics(
        model, evolve_config=rt.EvolveConfig(rt.EvolveMethod.prop_and_compress))
    ct.stop_at_edge = True
    ct.evolve(4, 25)
    assert ttransport.EDGE_THRESHOLD < ct.latest_mps.e_occupations[0] < 0.1
    analytical = 2 * j_constant.as_au() ** 2 * ct.evolve_times_array ** 2
    m = analytical > 0
    assert np.allclose(np.asarray(ct.r_square_array)[m], analytical[m], rtol=1e-3)


def _chain3(pkg, m, levels=3, j=0.2):
    ph = m.Phonon.simple_phonon(pkg.Quantity(1.0), pkg.Quantity(0.6), levels)
    return m.HolsteinModel([m.Mol(pkg.Quantity(0.0), [ph], 1.0)] * 3, pkg.Quantity(j))


def test_charge_diffusion_rdm_matches_jax(tmp_path):
    """``rdm=True`` on a 3-molecule chain (2-level phonons) with the default
    P&C step, both packages: every recorded observable and the npz dump
    keys."""
    jobs = {}
    for name, pkg, m, tr in (("jax", rj, jm, jtransport), ("port", rt, tm, ttransport)):
        job = tr.ChargeDiffusionDynamics(
            _chain3(pkg, m, levels=2), rdm=True, stop_at_edge=False,
            dump_dir=str(tmp_path / name), job_name="cd")
        job.evolve(0.5, 2)
        jobs[name] = job
    job, jjob = jobs["port"], jobs["jax"]
    assert np.allclose(job.evolve_times, jjob.evolve_times)
    for name in ("energies", "r_square_array", "e_occupations_array",
                 "ph_occupations_array", "k_occupations_array",
                 "eph_vn_entropy_array", "coherent_length_array",
                 "reduced_density_matrices"):
        np.testing.assert_allclose(np.array(getattr(job, name)),
                                   np.array(getattr(jjob, name)), atol=1e-10,
                                   err_msg=name)
    for a, b in zip(job.bond_vn_entropy_array, jjob.bond_vn_entropy_array):
        np.testing.assert_allclose(a, b, atol=1e-8)
    assert job.is_similar(jjob)
    # the dump keys, the reference's "tempearture" included
    dump = job.get_dump_dict()
    assert list(dump) == list(jjob.get_dump_dict())
    assert "tempearture" in dump
    rdm = job.reduced_density_matrices[-1]
    assert np.trace(rdm).real == pytest.approx(1.0, abs=1e-10)
    assert ttransport.calc_r_square([0, 0, 0]) == 0


def _thermal_properties(model):
    prop_mpos = {}
    for imol in range(3):
        prop_mpos.update(prop_ops.e_ph_static_correlation(model, imol=imol))
    return Property(list(prop_mpos) + ["e_rdm"], prop_mpos), prop_mpos


def _thermal_oracle(jmodel, beta):
    """The dense one-electron thermal ensemble: rho and the electron RDM."""
    h = dense_hamiltonian(jmodel)
    s1 = _sector(jmodel, h)
    rho = scipy.linalg.expm(-beta * h[np.ix_(s1, s1)])
    rho /= np.trace(rho)
    rdm = np.zeros((3, 3))
    for i, di in enumerate(jmodel.e_dofs):
        for j, dj in enumerate(jmodel.e_dofs):
            o = dense_hamiltonian(jm.Model(jmodel.basis, [jm.Op(r"a^\dagger a", [di, dj], 1.0)]))
            rdm[i, j] = float(np.real(np.trace(rho @ o[np.ix_(s1, s1)])))
    return rho, s1, rdm


BETA_1500K = rt.Quantity(1500.0, "K").to_beta()
THERMAL_STEPS = 10


def test_property_thermal_equilibrium():
    """``Property`` with the electron RDM and ``e_ph_static_correlation``
    under ``ThermalProp`` (TDVP-PS) against the dense thermal ensemble, with
    ``tests/test_apps.py:532-581``'s model, 10 steps of beta/20 and bounds."""
    model = _chain3(rt, tm, j=0.1)
    prop, prop_mpos = _thermal_properties(model)
    td = rt.ThermalProp(rt.MpDm.max_entangled_ex(model),
                        evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps),
                        properties=prop)
    td.evolve(None, THERMAL_STEPS, BETA_1500K / 2j)
    assert all(len(v) == len(td.evolve_times) for v in prop.prop_res.values())
    assert set(prop.prop_res) <= set(td.get_dump_dict())

    rho, s1, rdm_d = _thermal_oracle(_chain3(rj, jm, j=0.1), BETA_1500K)
    rdm_c = np.asarray(prop.prop_res["e_rdm"][-1])
    assert np.abs(rdm_c.imag).max() < 1e-6
    assert np.abs(rdm_c.real - rdm_d).max() < 1e-4
    for key, mpo in prop_mpos.items():
        od = mpo.todense()[np.ix_(s1, s1)]
        oracle = float(np.real(np.trace(rho @ od)))
        assert abs(float(np.real(prop.prop_res[key][-1])) - oracle) < 1e-4, key
    # the periodic variant sums the same correlations over the ring
    periodic = prop_ops.e_ph_static_correlation(model, periodic=True)
    assert len(periodic) == 3
    assert set(prop_ops.x_average(model)) == {"x"}
    assert len(prop_ops.x_square_average(model)["x^2"]) == 3


def test_thermal_prop_on_the_port_expansion():
    """Imaginary-time TDVP-PS grows along the directions the expansion's
    padding holds.  Before ``compress`` resolved the 1e-10-weight
    directions and completed the exact zeros by seeded random directions,
    one Gram pass
    left them as rounding noise, and on this J = 0.2 chain the port's own
    expansion ended 8.1e-4 off the dense RDM after 10 steps of beta/20 at
    1500 K (the JAX package's 4.8e-6)."""
    model = _chain3(rt, tm)
    prop = Property(["e_rdm"], {})
    td = rt.ThermalProp(rt.MpDm.max_entangled_ex(model),
                        evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps),
                        properties=prop)
    td.evolve(None, THERMAL_STEPS, BETA_1500K / 2j)
    _, _, rdm_d = _thermal_oracle(_chain3(rj, jm), BETA_1500K)
    rdm = np.asarray(prop.prop_res["e_rdm"][-1])
    assert np.abs(rdm.imag).max() < 1e-10
    assert np.abs(rdm.real - rdm_d).max() < 1e-5


@pytest.mark.slow
def test_thermal_prop_on_the_jax_expansion_matches_jax():
    """From the JAX package's expansion, carried over, the port's 10 steps
    of beta/20 at 1500 K agree with the JAX package's (1.7e-6); the two
    expanded MpDm agree to 3e-12 as dense matrices, with the same bond
    dimensions."""
    from renormalizer_tpu.mps import MpDm as JMpDm, ThermalProp as JThermalProp
    from renormalizer_tpu.property import Property as JProperty, ops as jprop_ops

    jmodel = _chain3(rj, jm)
    jmpos = {}
    for imol in range(3):
        jmpos.update(jprop_ops.e_ph_static_correlation(jmodel, imol=imol))
    jprop = JProperty(list(jmpos) + ["e_rdm"], jmpos)
    jtd = JThermalProp(JMpDm.max_entangled_ex(jmodel),
                       evolve_config=rj.EvolveConfig(rj.EvolveMethod.tdvp_ps),
                       properties=jprop)
    carried = interop.mpdm_from_object(_chain3(rt, tm), jtd.latest_mps)
    jtd.evolve(None, THERMAL_STEPS, BETA_1500K / 2j)

    prop, _ = _thermal_properties(carried.model)
    td = rt.ThermalProp(carried, evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps),
                        properties=prop, auto_expand=False)
    td.evolve(None, THERMAL_STEPS, BETA_1500K / 2j)
    _, _, rdm_d = _thermal_oracle(jmodel, BETA_1500K)
    rdm, jrdm = (np.asarray(p.prop_res["e_rdm"][-1]).real for p in (prop, jprop))
    assert np.abs(rdm - jrdm).max() < 1e-5
    assert np.abs(rdm - rdm_d).max() < 1e-4
    for key in jmpos:
        assert abs(complex(prop.prop_res[key][-1])
                   - complex(np.asarray(jprop.prop_res[key][-1]))) < 1e-5, key


def _ti1d(pkg, m):
    basis = [m.BasisSimpleElectron("e")]
    hop = (m.Op(r"a^\dagger a", [(0, "e"), (1, "e")], -1.0)
           + m.Op(r"a^\dagger a", [(1, "e"), (0, "e")], -1.0))
    return m.TI1DModel(basis, [], hop, 4)


def test_spectral_function_ti1d():
    """G_ij(0) = -i delta_ij for the free-electron 4-cell ring
    (``tests/test_apps.py:266-282``), and G(t) against the dense
    <0|c_i exp(-i (H - E_vac) t) c^dagger_0|0> / i (E_vac = 0 here)."""
    model = _ti1d(rt, tm)
    assert [b.dof for b in model.basis] == [("cell0", "e"), ("cell1", "e"),
                                           ("cell2", "e"), ("cell3", "e")]
    job = ttransport.SpectralFunctionZT(model)
    job.evolve(0.1, 2)
    g0 = job.G_array[0]
    assert np.isclose(g0[0] * 1j, 1, atol=1e-6)
    assert np.allclose(np.abs(g0[1:]), 0, atol=1e-6)

    # the default propagate-and-compress step: order-4 Taylor, whose error
    # is ~(dt |H|)^5 / 5! = 8e-8 a step here (|H| = 2, dt 0.05)
    job = ttransport.SpectralFunctionZT(
        model, compress_config=rt.CompressConfig(rt.CompressCriteria.fixed, max_bonddim=4))
    dt, n = 0.05, 4
    job.evolve(dt, n)
    jmodel = _ti1d(rj, jm)
    h = dense_hamiltonian(jmodel)
    dim = h.shape[0]
    vac = np.zeros(dim)
    vac[0] = 1.0
    cdag = [dense_hamiltonian(jm.Model(jmodel.basis, [jm.Op(r"a^\dagger", d, 1.0)]))
            for d in jmodel.e_dofs]
    oracle = []
    for k in range(n + 1):
        ket = scipy.linalg.expm(-1j * h * dt * k) @ (cdag[0] @ vac)
        oracle.append([vac @ (c.conj().T @ ket) / 1j for c in cdag])
    np.testing.assert_allclose(job.G_array, np.array(oracle), rtol=0, atol=1e-6)
    gk = job.get_dump_dict()["Gk array"]
    assert gk.shape == (n + 1, 3)
    np.testing.assert_allclose(gk[:, 0], job.G_array.sum(axis=1), atol=1e-12)


def _holstein3(pkg, m):
    phs = [m.Phonon.simple_phonon(pkg.Quantity(w, "cm^{-1}"), pkg.Quantity(d, "a.u."), 4)
           for w, d in ((106.51, 30.1370), (1555.55, 8.7729))]
    j = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3], [-0.2, -0.3, 0.0]]) / 27.211386
    return m.HolsteinModel([m.Mol(pkg.Quantity(2.67, "eV"), phs, 15.45)] * 3, j)


HOLSTEIN = _holstein3(rt, tm)


def test_independent_identical_mpos_share_digests():
    mpo1 = rt.Mpo(HOLSTEIN, rt.Op(r"a^\dagger a", 0))
    mpo2 = rt.Mpo(HOLSTEIN, rt.Op(r"a^\dagger a", 0))
    assert all(h is not None for h in mpo1._mt_hashes)
    assert mpo1._mt_hashes == mpo2._mt_hashes
    assert mpo1._mt_hashes != rt.Mpo(HOLSTEIN, rt.Op(r"a^\dagger a", 1))._mt_hashes
    assert mpo1.copy()._mt_hashes == mpo1._mt_hashes


@pytest.mark.parametrize("complex_state", [False, True], ids=["real", "complex"])
def test_expectations_cache_matches_plain_loop(complex_state, monkeypatch):
    """The cached path against the plain loop within 1e-12, and identical
    independently built MPOs cost no extra contraction
    (``tests/test_expectations_cache.py``)."""
    mps = rt.Mps.random(HOLSTEIN, 1, 10)
    if complex_state:
        mps = mps.evolve(rt.Mpo(HOLSTEIN), 0.5)
    ops = [rt.Op(r"a^\dagger a", d) for d in HOLSTEIN.e_dofs]
    ops += [rt.Op("n", d) for d in HOLSTEIN.v_dofs]
    mpos_a = [rt.Mpo(HOLSTEIN, op) for op in ops]
    mpos_b = [rt.Mpo(HOLSTEIN, op) for op in ops]

    calls = {"n": 0}
    orig = port_mps.contract_one_site

    def counting(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(port_mps, "contract_one_site", counting)
    ref = mps.expectations(mpos_a)
    n_first = calls["n"]
    calls["n"] = 0
    both = mps.expectations(mpos_a + mpos_b)
    n_both = calls["n"]
    monkeypatch.undo()
    plain = mps.expectations(mpos_a, opt=False)
    assert np.abs(ref - plain).max() < 1e-12
    np.testing.assert_allclose(both[: len(ops)], ref, rtol=0, atol=1e-14)
    np.testing.assert_allclose(both[len(ops):], ref, rtol=0, atol=1e-14)
    assert n_both <= n_first * 1.2 + len(ops)
    # Op lists are accepted as the JAX package accepts them
    np.testing.assert_allclose(mps.expectations(ops[:2]), ref[:2], atol=1e-12)


@pytest.fixture(scope="module")
def carried_state():
    """A real-time-evolved state of the 3-molecule fixture (complex, bond
    dimension 8), built in the JAX package and carried over."""
    jmodel = _holstein3(rj, jm)
    jstate = rj.Mps.random(jmodel, 1, 8)
    jstate.evolve_config = rj.EvolveConfig(rj.EvolveMethod.tdvp_ps)
    jstate = jstate.evolve(rj.Mpo(jmodel), 20.0)
    return jstate, interop.mps_from_object(HOLSTEIN, jstate)


def test_rdms_and_entropies_match_jax(carried_state):
    jstate, state = carried_state
    assert state.is_complex
    rdm2, jrdm2 = state.calc_2site_rdm(), jstate.calc_2site_rdm()
    assert set(rdm2) == set(jrdm2)
    for key in rdm2:
        assert np.abs(rdm2[key] - np.asarray(jrdm2[key])).max() < 1e-10, key
    assert np.abs(state.calc_edof_rdm() - jstate.calc_edof_rdm()).max() < 1e-10
    rdm1, jrdm1 = state.calc_1site_rdm(), jstate.calc_1site_rdm()
    for key in rdm1:
        assert np.abs(rdm1[key] - np.asarray(jrdm1[key])).max() < 1e-10
    for kind in ("1site", "2site"):
        ent, jent = state.calc_entropy(kind), jstate.calc_entropy(kind)
        assert set(ent) == set(jent)
        for key in ent:
            assert ent[key] == pytest.approx(jent[key], abs=1e-10)
    np.testing.assert_allclose(state.calc_entropy("mutual"),
                               jstate.calc_entropy("mutual"), atol=1e-10)
    np.testing.assert_allclose(state.calc_entropy("bond"),
                               jstate.calc_entropy("bond"), atol=1e-8)
    with pytest.raises(ValueError, match="entropy type"):
        state.calc_entropy("nope")


def test_mpdm_rdm_traces_the_ancilla():
    """A density matrix's 1-site RDM (4-leg sites) is the thermal site
    occupation: at infinite temperature in the one-exciton sector each
    molecule holds the electron with probability 1/3."""
    rho = rt.MpDm.max_entangled_ex(_chain3(rt, tm))
    rho.normalize("mps_and_coeff")
    rdm = rho.calc_1site_rdm()
    e_sites = [rho.model.dof_to_siteidx[d] for d in rho.model.e_dofs]
    for i in e_sites:
        assert np.trace(rdm[i]).real == pytest.approx(1.0, abs=1e-10)
        assert rdm[i][1, 1].real == pytest.approx(1 / 3, abs=1e-10)


def test_truncation_qr_survives_underflow_range_entries():
    """Blocks of the band-limit charge diffusion in complex64 whose entries
    reach the underflow range (a relaxed start of a mode displaced by
    1e-10): the truncation's QR, computed in double precision, returns a
    finite orthonormal Q with Q R = A (in complex64 the library QR returned
    NaN on both, on the CPU and on an H100)."""
    from renormalizer_tpu_torch.mps.trunc_device import _qr

    blocks = [
        [[-1 + 3.6e-15j, 6.0e-10 + 3.1e-25j, 0, 0], [0, 0, 0, 0],
         [4.4e-31 - 2.4e-43j, 0, 0, 0], [0, 0, 0, 0]],
        [[-4.08e-4 - 9.3e-14j, 7.26e-4 + 1.6e-13j, 2.57e-3 + 5.8e-13j],
         [-2.77e-21 + 3.68e-21j, 4.92e-21 - 6.54e-21j, 1.74e-20 - 2.31e-20j],
         [-3.48e-16 + 4.2e-21j, 6.18e-16 - 7.4e-21j, 2.19e-15 - 2.6e-20j],
         [0, 0, 0]],
    ]
    for block in blocks:
        a = torch.tensor(block, dtype=torch.complex64)
        q, r = _qr(a)
        assert q.dtype == r.dtype == torch.complex64
        assert torch.isfinite(torch.view_as_real(q)).all()
        assert torch.isfinite(torch.view_as_real(r)).all()
        eye = torch.eye(q.shape[1], dtype=q.dtype)
        assert (q.mH @ q - eye).abs().max() < 1e-6
        assert (q @ r - a).abs().max() < 1e-6 * a.abs().max()
