"""The port's finite-temperature and spectra jobs, fp64 on the CPU.

Small models, a few steps.  ``TransportKubo`` on a 3-molecule model with
one phonon-assisted (Peierls) hop and ``SpectraFiniteT`` emission on the
smallest Holstein chain (2 molecules, 2 phonon levels) run with their
default ``EvolveConfig()`` (propagate and compress) at their exact bond
dimension, so every step is an order-4 Taylor polynomial that a dense
oracle takes too: C(t) within 1e-8 of |C(0)|.  The absorption,
zero-temperature and exact spectra and TDVP-PS Kubo are held against the
dense oracles of ``tests/test_apps.py``; the current operators against
the JAX package.

The same jobs run in the JAX package (M = 4, bonds cut) compile ~270 XLA
programs each, 20-30 s on the CPU; those comparisons (within 1e-8 of
|C(0)|) carry the ``slow`` marker:
``python -m pytest -m slow tests/test_torch_finitet.py``."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import dense_hamiltonian
import renormalizer_tpu as rj
import renormalizer_tpu.model as jm
import renormalizer_tpu.spectra as jspectra
import renormalizer_tpu.transport as jtransport
import renormalizer_tpu.transport.kubo as jkubo
import renormalizer_tpu_torch as rt
import renormalizer_tpu_torch.model as tm
import renormalizer_tpu_torch.spectra as tspectra
import renormalizer_tpu_torch.transport as ttransport
import renormalizer_tpu_torch.transport.kubo as tkubo
from renormalizer_tpu_torch.mps import MpDm

torch.set_num_threads(2)

CORR_TOL = 1e-8
# each package with its own model classes and jobs
SIDES = {
    "jax": (rj, jm, jspectra, jtransport),
    "port": (rt, tm, tspectra, ttransport),
}


def holstein2(pkg, m):
    """The smallest Holstein chain: 2 molecules, one 2-level phonon each."""
    ph = m.Phonon.simple_phonon(pkg.Quantity(1), pkg.Quantity(1), 2)
    return m.HolsteinModel([m.Mol(pkg.Quantity(0), [ph], 1.0)] * 2, pkg.Quantity(1), 3)


def peierls3(pkg, m):
    """3 molecules on a ring, one 2-level phonon on molecule 0 that couples
    to its site energy and modulates the 0-1 hop (a Peierls term)."""
    basis = [m.BasisSimpleElectron(0), m.BasisSHO("v0", 1.0, 2),
             m.BasisSimpleElectron(1), m.BasisSimpleElectron(2)]
    ham = [m.Op(r"a^\dagger a", i, 0.1 * i) for i in range(3)]
    ham += [m.Op(r"b^\dagger b", "v0", 1.0),
            m.Op(r"a^\dagger a", 0) * m.Op(r"b^\dagger+b", "v0") * 0.5]
    for i, j in ((0, 1), (1, 2), (2, 0)):
        ham += [m.Op(r"a^\dagger a", [i, j], 0.3), m.Op(r"a^\dagger a", [j, i], 0.3)]
    ham += [m.Op(r"a^\dagger a x", [0, 1, "v0"], 0.2),
            m.Op(r"a^\dagger a x", [1, 0, "v0"], 0.2)]
    return m.Model(basis, ham)


MODELS = {"holstein2": holstein2, "peierls3": peierls3}


@pytest.mark.parametrize("model_name", list(MODELS))
def test_current_operator_matches_jax(model_name):
    """``derive_current_terms`` splits the same terms: the dense current
    operators (bare and phonon-assisted) agree."""
    jmodel, model = MODELS[model_name](rj, jm), MODELS[model_name](rt, tm)
    np.testing.assert_array_equal(tkubo.pbc_chain_distances(3),
                                  jkubo.pbc_chain_distances(3))
    dist = tkubo.pbc_chain_distances(model.n_edofs)
    jterms = jkubo.derive_current_terms(jmodel, dist)
    terms = tkubo.derive_current_terms(model, dist)
    assert [len(t) for t in terms] == [len(t) for t in jterms]
    assert len(terms[1]) == (2 if model_name == "peierls3" else 0)
    for jt, t in zip(jterms, terms):
        if jt:
            np.testing.assert_allclose(rt.Mpo(model, t).todense(),
                                       rj.Mpo(jmodel, jt).todense(), atol=1e-14)


def _taylor4(h, x):
    """Sum_{k<=4} (x h)^k / k!: one P&C step (order-4 Taylor, the default
    ``EvolveConfig()``) of a time-independent h, exact when no bond is cut."""
    term = out = np.eye(len(h), dtype=complex)
    for k in range(1, 5):
        term = term @ (x * h) / k
        out = out + term
    return out


def _step(h, x, state):
    """A real-time P&C step as ``Mps.evolve`` takes it: the state (not
    ``coeff``) normalized afterwards."""
    out = _taylor4(h, x) @ state
    return out * (np.linalg.norm(state) / np.linalg.norm(out))


def _dense_thermal(jmodel, model, temperature):
    """``TransportKubo``'s thermal state with ``insteps=1``: one P&C step of
    exp(-beta/2 (H - E0)) from the T = inf state, normalized; its energy."""
    h = dense_hamiltonian(jmodel)
    r0 = MpDm.max_entangled_ex(model).todense()
    e0 = np.trace(r0.T @ h @ r0).real
    r = (_taylor4(h - e0 * np.eye(len(h)), -temperature.to_beta() / 2) @ r0).real
    r /= np.linalg.norm(r)
    return h, r, np.trace(r.T @ h @ r).real


def test_kubo_against_dense_oracle():
    """The whole job with its default configs on the Peierls model (a bare
    and a phonon-assisted current, two kets) at bond dimension 16, its
    exact one: thermal state by one P&C step, each current operator applied
    and compressed, two real-time P&C steps of the bra and both kets.  The
    dense oracle takes the same order-4 Taylor steps: C(t) and its four
    components within 1e-8 of |C(0)|, and the mobility."""
    model, jmodel = peierls3(rt, tm), peierls3(rj, jm)
    temperature, dt, n = rt.Quantity(0.5, "a.u."), 0.5, 2
    kubo = ttransport.TransportKubo(
        model, temperature, insteps=1,
        compress_config=rt.CompressConfig(rt.CompressCriteria.fixed, max_bonddim=16))
    kubo.evolve(evolve_dt=dt, nsteps=n)
    h, rho, energy = _dense_thermal(jmodel, model, temperature)
    assert kubo.h_mpo.offset == pytest.approx(energy, abs=1e-12)
    h = h - energy * np.eye(len(h))
    bare, assisted = tkubo.derive_current_terms(model, tkubo.pbc_chain_distances(3))
    currents = [rt.Mpo(model, terms).todense() for terms in (bare, assisted)]
    bra, kets = rho.astype(complex), [j @ rho for j in currents]
    comps = []
    for i in range(n + 1):
        if i:
            bra, kets = _step(h, -1j * dt, bra), [_step(h, -1j * dt, k) for k in kets]
        comps.append([-np.trace(bra.conj().T @ j @ k) for j in currents for k in kets])
    comps = np.array(comps)
    scale = abs(comps[0].sum())
    assert np.abs(kubo.auto_corr_decomposition - comps).max() <= CORR_TOL * scale
    assert np.abs(kubo.auto_corr - comps.sum(1)).max() <= CORR_TOL * scale
    mobility = np.trapezoid(comps.sum(1).real, kubo.evolve_times) / temperature.as_au()
    assert kubo.calc_mobility()[0] == pytest.approx(mobility, rel=CORR_TOL)
    assert all(isinstance(mp, MpDm) for pair in kubo.latest_mps for mp in pair)


def test_spectra_finite_t_emission_against_dense_oracle():
    """Finite-temperature emission on the 2-molecule chain at bond dimension
    16: thermal state by one P&C step, the dipole applied on the ancilla
    side, then odd steps move the ket forward (exact GS-space propagator on
    the ancilla, P&C step) and even steps the bra backward; emission
    reports the conjugate amplitude.  The dense oracle takes the same
    steps: within 1e-8 of |C(0)|."""
    model, jmodel = holstein2(rt, tm), holstein2(rj, jm)
    temperature, dt, n = rt.Quantity(0.5, "a.u."), 0.5, 3
    job = tspectra.SpectraFiniteT(
        model, "emi", temperature, 1, rt.Quantity(0),
        icompress_config=rt.CompressConfig(rt.CompressCriteria.fixed, max_bonddim=16))
    job.evolve(evolve_dt=dt, nsteps=n)
    h, rho, _ = _dense_thermal(jmodel, model, temperature)
    mu_dagger = _dense_op(jmodel, "a", jmodel.e_dofs).T
    h_ph = _dense_op(jmodel, r"b^\dagger b", jmodel.v_dofs)  # omega = 1
    u_gs = scipy.linalg.expm(1j * h_ph * dt)
    ket = (rho @ mu_dagger).astype(complex)
    bra = ket.copy()
    oracle = [np.conj(np.trace(bra.conj().T @ ket))]
    for i in range(1, n + 1):
        if i % 2 == 1:
            ket = _step(h, -1j * dt, ket @ u_gs)
        else:
            bra = _step(h, 1j * dt, bra @ u_gs.conj().T)
        oracle.append(np.conj(np.trace(bra.conj().T @ ket)))
    assert np.abs(job.autocorr - np.array(oracle)).max() <= CORR_TOL * abs(oracle[0])


def _kubo(side, model_name, nsteps=2, **kwargs):
    pkg, m, _, transport = SIDES[side]
    kubo = transport.TransportKubo(
        MODELS[model_name](pkg, m), pkg.Quantity(0.5, "a.u."), insteps=1,
        compress_config=pkg.CompressConfig(pkg.CompressCriteria.fixed, max_bonddim=4),
        **kwargs)
    kubo.evolve(evolve_dt=0.5, nsteps=nsteps)
    return kubo


def test_kubo_thermal_state_is_cached(tmp_path):
    """A thermal state dumped by one job is loaded by the next
    (``load_thermal_state``), which then gives the same C(t)."""
    path = str(tmp_path / "rho.npz")
    assert rt.load_thermal_state(holstein2(rt, tm), path) is None
    first = _kubo("port", "holstein2", nsteps=1, thermal_dump_path=path)
    assert rt.load_thermal_state(holstein2(rt, tm), path) is not None
    second = _kubo("port", "holstein2", nsteps=1, thermal_dump_path=path)
    np.testing.assert_allclose(second.auto_corr, first.auto_corr, atol=1e-14)


def test_kubo_rejects_properties():
    """``properties=`` is taken now (the name is kept from when it raised):
    a ``Property`` collector records one transition amplitude per recorded
    step of the real-time evolution, and the dump carries it."""
    from renormalizer_tpu_torch.property import Property

    model = holstein2(rt, tm)
    occupation = rt.Mpo(model, rt.Op(r"a^\dagger a", model.e_dofs[0]))
    prop = Property(["n0"], {"n0": occupation})
    kubo = ttransport.TransportKubo(model, rt.Quantity(0.5, "a.u."), insteps=2,
                                    properties=prop)
    kubo.evolve(evolve_dt=0.5, nsteps=2)
    assert len(prop.prop_res["n0"]) == len(kubo.evolve_times) == 3
    assert all(np.isfinite(complex(v)) for v in prop.prop_res["n0"])
    assert kubo.get_dump_dict()["n0"] is prop.prop_res["n0"]


@pytest.mark.slow
def test_kubo_matches_jax():
    """The Peierls job with its default configs in both packages, M = 4
    (bonds cut): C(t), its decomposition and the mobility agree."""
    jkubo_job, kubo = _kubo("jax", "peierls3"), _kubo("port", "peierls3")
    c, jc = kubo.auto_corr, jkubo_job.auto_corr
    scale = abs(jc[0])
    assert np.abs(c - jc).max() <= CORR_TOL * scale
    assert (np.abs(kubo.auto_corr_decomposition
                   - jkubo_job.auto_corr_decomposition).max() <= CORR_TOL * scale)
    assert kubo.calc_mobility()[0] == pytest.approx(jkubo_job.calc_mobility()[0],
                                                    rel=CORR_TOL)


def _emission(side):
    pkg, m, spectra, _ = SIDES[side]
    job = spectra.SpectraFiniteT(
        holstein2(pkg, m), "emi", pkg.Quantity(0.5, "a.u."), 1, pkg.Quantity(0),
        icompress_config=pkg.CompressConfig(pkg.CompressCriteria.fixed, max_bonddim=4))
    job.evolve(evolve_dt=0.5, nsteps=2)
    return job.autocorr


@pytest.mark.slow
def test_spectra_finite_t_emission_matches_jax():
    """Emission in both packages, M = 4 (bonds cut)."""
    ac, jac = _emission("port"), _emission("jax")
    assert np.abs(ac - jac).max() <= CORR_TOL * abs(jac[0])


def _spectra_model(pkg, m):
    """``tests/test_apps.py:495-496``: 2 molecules, dipole 1."""
    ph = m.Phonon.simple_phonon(pkg.Quantity(1.0), pkg.Quantity(0.4), 2)
    return m.HolsteinModel([m.Mol(pkg.Quantity(1.0), [ph], 1.0)] * 2, pkg.Quantity(0.2))


def _sectors(jmodel, h):
    dims = jmodel.pbond_list
    return np.array([sum(jmodel.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
                         for i in range(len(dims))) for s in range(h.shape[0])])


def _dense_op(jmodel, symbol, dofs):
    return dense_hamiltonian(jm.Model(jmodel.basis, [rj.Op(symbol, d, 1.0) for d in dofs]))


def test_spectra_finite_t_absorption_against_dense_oracle():
    """``tests/test_apps.py:487-529`` in the port: exact GS-space thermal
    state, TDVP-PS in real time, the JAX test's dense oracle and its bound
    (the JAX package meets it there)."""
    model = _spectra_model(rt, tm)
    temperature = rt.Quantity(0.2, "a.u.")
    dt, n = 0.4, 3
    job = tspectra.SpectraFiniteT(model, "abs", temperature, 1, rt.Quantity(0),
                                  evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps))
    job.evolve(evolve_dt=dt, nsteps=n)
    jmodel = _spectra_model(rj, jm)
    h = dense_hamiltonian(jmodel)
    s0 = np.nonzero(_sectors(jmodel, h) == 0)[0]
    rho_h = np.zeros_like(h)
    rho_h[np.ix_(s0, s0)] = scipy.linalg.expm(-temperature.to_beta() / 2 * h[np.ix_(s0, s0)])
    rho_h /= np.linalg.norm(rho_h)
    mu = _dense_op(jmodel, r"a^\dagger", jmodel.e_dofs)
    u = scipy.linalg.expm(-1j * h * dt)
    u_gs = scipy.linalg.expm(1j * _dense_op(jmodel, r"b^\dagger b", jmodel.v_dofs) * dt)
    ket = (mu @ rho_h).astype(complex)
    bra = ket.copy()
    oracle = [np.trace(bra.conj().T @ ket)]
    for i in range(1, n + 1):
        if i % 2 == 1:
            ket = u @ ket @ u_gs
        else:
            bra = u.conj().T @ bra @ u_gs.conj().T
        oracle.append(np.trace(bra.conj().T @ ket))
    assert np.abs(job.autocorr - np.array(oracle)).max() < 1e-8


@pytest.mark.parametrize("cls", ["SpectraOneWayPropZeroT", "SpectraTwoWayPropZeroT"])
def test_spectra_zero_t_against_dense_oracle(cls):
    """DMRG ground state of the 0-exciton sector, dipole applied, then P&C
    at the exact bond dimension: C(t) = <mu gs| e^{-iHt} |mu gs> up to the
    local error of the order-4 Taylor step, (dt |H|)^5 / 5! a step."""
    model = _spectra_model(rt, tm)
    job = getattr(tspectra, cls)(
        model, "abs", optimize_config=rt.OptimizeConfig([[4, 0.4], [4, 0], [4, 0]]),
        compress_config=rt.CompressConfig(rt.CompressCriteria.fixed, max_bonddim=16))
    dt, n = 0.1, 4
    job.evolve(dt, n)
    jmodel = _spectra_model(rj, jm)
    h = dense_hamiltonian(jmodel)
    s0 = np.nonzero(_sectors(jmodel, h) == 0)[0]
    gs = np.zeros(h.shape[0])
    gs[s0] = np.linalg.eigh(h[np.ix_(s0, s0)])[1][:, 0]
    ket0 = _dense_op(jmodel, r"a^\dagger", jmodel.e_dofs) @ gs
    oracle = [ket0 @ scipy.linalg.expm(-1j * h * dt * i) @ ket0 for i in range(n + 1)]
    taylor = n * (dt * np.linalg.norm(h, 2)) ** 5 / 120
    assert np.abs(job.autocorr - np.array(oracle)).max() < taylor * abs(oracle[0])


def test_spectra_exact_zero_t_emission_against_dense_oracle():
    """``SpectraExact`` emission at T = 0: the 1-exciton ground state, a
    applied, the 0-exciton ket evolved by the exact local propagator; there
    H is the free phonons' sum omega b^dagger b (the propagator leaves out
    the zero-point energy), so C(t) = <a gs| e^{-i H_ph t} |a gs>."""
    model = _spectra_model(rt, tm)
    job = tspectra.SpectraExact(model, "emi",
                                optimize_config=rt.OptimizeConfig([[4, 0.4], [4, 0], [4, 0]]))
    dt, n = 0.3, 3
    job.evolve(dt, n)
    jmodel = _spectra_model(rj, jm)
    h = dense_hamiltonian(jmodel)
    s1 = np.nonzero(_sectors(jmodel, h) == 1)[0]
    gs = np.zeros(h.shape[0])
    gs[s1] = np.linalg.eigh(h[np.ix_(s1, s1)])[1][:, 0]
    ket0 = _dense_op(jmodel, "a", jmodel.e_dofs) @ gs
    h_ph = _dense_op(jmodel, r"b^\dagger b", jmodel.v_dofs)  # omega = 1
    oracle = [ket0 @ scipy.linalg.expm(-1j * h_ph * dt * i) @ ket0 for i in range(n + 1)]
    assert np.abs(job.autocorr - np.array(oracle)).max() < 1e-8 * abs(oracle[0])


@pytest.mark.parametrize("spectratype", ["emi", "abs"])
def test_spectra_exact_finite_t_against_dense_oracle(spectratype):
    """``tests/test_apps.py:110-147`` in the port: one molecule, two modes,
    the thermal state by one exact step; C(t)/C(0) is a product over modes
    of Tr[rho1 e^{iH1 t} e^{-iH2 t}], within the JAX test's 1e-7."""
    phs = [rt.Phonon.simple_phonon(rt.Quantity(1.0), rt.Quantity(0.7), 8),
           rt.Phonon.simple_phonon(rt.Quantity(0.4), rt.Quantity(1.1), 10)]
    model = rt.HolsteinModel([rt.Mol(rt.Quantity(1.0), phs, 1.0)], rt.Quantity(0))
    temperature = rt.Quantity(0.5)
    job = tspectra.SpectraExact(model, spectratype, temperature=temperature)
    dt, n = 0.3, 4
    job.evolve(dt, n)
    ac = np.array(job.autocorr)
    ac = ac / ac[0]
    times = dt * np.arange(n + 1)
    oracle = np.ones(n + 1, dtype=complex)
    for ph in phs:
        levels = np.arange(ph.pbond, dtype=float)
        ladder = np.diag(np.sqrt(levels[1:]), -1) + np.diag(np.sqrt(levels[1:]), 1)
        h_gs = np.diag(ph.omega[0] * levels)
        h_ex = h_gs + ph.term10 * ladder
        h1, h2 = (h_ex, h_gs) if spectratype == "emi" else (h_gs, h_ex)
        rho = scipy.linalg.expm(-temperature.to_beta() * h1)
        rho /= np.trace(rho)
        oracle *= np.array([np.trace(rho @ scipy.linalg.expm(1j * h1 * t)
                                     @ scipy.linalg.expm(-1j * h2 * t)) for t in times])
    assert np.abs(ac - oracle).max() < 1e-7


def test_kubo_tdvp_against_dense_oracle():
    """The port alone, TDVP-PS in both imaginary and real time on the
    2-molecule chain at its exact bond dimension (16), against the dense
    Liouville oracle of ``tests/test_apps.py:437-464``.  The thermal state
    keeps the JAX package's bond dimensions (all 16 states of the middle
    bond: ``compress_factors`` spreads the zero-weight padding of the
    expansion over the sectors), and C(t) is exact, as the JAX package's."""
    model = holstein2(rt, tm)
    temperature = rt.Quantity(0.5, "a.u.")
    kubo = ttransport.TransportKubo(
        model, temperature, insteps=5,
        compress_config=rt.CompressConfig(rt.CompressCriteria.fixed, max_bonddim=16),
        ievolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps),
        evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps))
    kubo.evolve(evolve_dt=0.5, nsteps=3)
    jmodel = holstein2(rj, jm)
    h = dense_hamiltonian(jmodel)
    dims = jmodel.pbond_list
    qn = np.array([sum(jmodel.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
                       for i in range(len(dims))) for s in range(h.shape[0])])
    s1 = np.nonzero(qn == 1)[0]
    h1 = h[np.ix_(s1, s1)]
    bare, _ = jkubo.derive_current_terms(jmodel, jkubo.pbc_chain_distances(2))
    j1 = dense_hamiltonian(jm.Model(jmodel.basis, bare))[np.ix_(s1, s1)]
    rho = scipy.linalg.expm(-temperature.to_beta() * h1)
    rho /= np.trace(rho)
    energies, vecs = np.linalg.eigh(h1)
    rho_e, j_e = vecs.T @ rho @ vecs, vecs.T @ j1 @ vecs
    oracle = []
    for t in kubo.evolve_times_array:
        phase = np.exp(1j * energies * t)
        oracle.append(-np.trace(rho_e @ ((phase[:, None] * j_e) * np.conj(phase)[None, :]) @ j_e))
    oracle = np.array(oracle)
    assert kubo.latest_mps.bra_mps.bond_dims == [1, 4, 16, 4, 1]
    assert np.abs(kubo.auto_corr - oracle).max() < 1e-9 * abs(oracle[0])
