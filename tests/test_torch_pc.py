"""The port's propagate-and-compress family, fp64 on the CPU.

Start state and configs of ``tests/test_evolve.py:36-42, 71-97``: the
3-molecule, 2-level Holstein model, a^dagger_0 |gs> expanded with the
Hamiltonian as hint, the Hamiltonian offset by its energy,
``CompressCriteria.fixed`` (whose default bond dimension, 32, is past this
chain's exact one, so nothing is truncated).  A step of P&C is then exactly
the order-4 Taylor polynomial of exp(-i dt H) applied to the dense vector
(for a time-independent H, RK4 and the C_RK4 tableau are the same
polynomial), which the fixed-step methods must reproduce to 1e-10; every
method, the adaptive ones included, follows scipy.linalg.expm within
tests/test_evolve.py's bound.

The same comparisons against the JAX package from one carried start state
(state distance <= 1e-8) compile ~300 XLA programs, 20-30 s on the CPU, and
carry the ``slow`` marker: ``python -m pytest -m slow tests/test_torch_pc.py``."""

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import dense_hamiltonian, exact_model
import renormalizer_tpu as rj
import renormalizer_tpu_torch as rt
from renormalizer_tpu.model import Model as JaxModel
from renormalizer_tpu_torch import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    HolsteinModel,
    Mol,
    Mpo,
    Mps,
    Phonon,
    Quantity,
    interop,
)

torch.set_num_threads(2)

STATE_TOL = 1e-8

jmodel = exact_model()
H_DENSE = dense_hamiltonian(jmodel)
OCC_DENSE = [dense_hamiltonian(JaxModel(jmodel.basis, [rj.Op(r"a^\dagger a", dof)]))
             for dof in jmodel.e_dofs]


def port_exact_model() -> HolsteinModel:
    """``tests/fixtures.py``'s ``exact_model`` in the port."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


MODEL = port_exact_model()

# (id, EvolveConfig keyword arguments, dt, steps): test_evolve.py's cases,
# the Butcher-tableau RK also with the adaptive RKF45 pair of utils/rk.py
CASES = [
    ("pc", dict(method="prop_and_compress"), 0.2, 2),
    ("pc_adaptive", dict(method="prop_and_compress", adaptive=True, guess_dt=0.1), 0.2, 1),
    ("tdrk4", dict(method="prop_and_compress_tdrk4"), 0.2, 2),
    ("tdrk_c_rk4", dict(method="prop_and_compress_tdrk"), 0.2, 2),
    ("tdrk_rkf45_adaptive", dict(method="prop_and_compress_tdrk", adaptive=True,
                                 guess_dt=0.1, rk_solver="RKF45"), 0.2, 1),
]
IDS = [c[0] for c in CASES]


def _dense(mp):
    return mp.todense() * mp.coeff


def _configure(mps, pkg, kwargs):
    mps.compress_config = pkg.CompressConfig(pkg.CompressCriteria.fixed)
    kwargs = dict(kwargs)
    mps.evolve_config = pkg.EvolveConfig(pkg.EvolveMethod[kwargs.pop("method")], **kwargs)
    return mps


@pytest.fixture(scope="module")
def start():
    """The port's start state and its energy."""
    init = Mpo.onsite(MODEL, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(MODEL, False)
    init = init.expand_bond_dimension(hint_mpo=Mpo(MODEL))
    return init, init.expectation(Mpo(MODEL))


def _taylor4(h, dt):
    """Sum_{k<=4} (-i dt h)^k / k!, the P&C step of a time-independent h."""
    term, out = np.eye(len(h), dtype=complex), np.eye(len(h), dtype=complex)
    for k in range(1, 5):
        term = term @ (-1j * dt * h) / k
        out = out + term
    return out


@pytest.mark.parametrize("name, kwargs, dt, steps", CASES, ids=IDS)
def test_pc_family_against_dense(start, name, kwargs, dt, steps):
    """Every method follows the dense expm (mean cumulative deviation of the
    occupations below 1e-4, tests/test_evolve.py's bound); the fixed-step
    ones are the dense order-4 Taylor step to 1e-10, normalized as
    ``Mps.evolve`` normalizes (the state, not ``coeff``)."""
    init, e0 = start
    mps = _configure(init.copy(), rt, kwargs)
    mpo = Mpo(MODEL, offset=Quantity(e0))
    h = H_DENSE - e0 * np.eye(len(H_DENSE))
    psi = _dense(init).astype(complex)
    taylor = psi.copy()
    deviations = []
    for i in range(1, steps + 1):
        mps = mps.evolve(mpo, dt)
        assert mps.is_complex
        exact = scipy.linalg.expm(-1j * h * dt * i) @ psi
        occ = [np.real(exact.conj() @ o @ exact) for o in OCC_DENSE]
        deviations.append(np.abs(mps.e_occupations - occ).mean())
        taylor = _taylor4(h, dt) @ taylor
        taylor *= np.linalg.norm(psi) / np.linalg.norm(taylor)
    assert float(np.mean(deviations)) < 1e-4
    if not kwargs.get("adaptive"):
        assert np.abs(_dense(mps) - taylor).max() < 1e-10


def test_default_config_is_pc(start):
    """``EvolveConfig()`` keeps the JAX package's default, P&C, and
    ``Mps.evolve`` runs it (it raised before P&C was ported)."""
    assert EvolveConfig().method is EvolveMethod.prop_and_compress
    assert rj.EvolveConfig().method.name == EvolveConfig().method.name
    init, e0 = start
    mps = init.copy()
    mps.evolve_config = EvolveConfig()
    mps.compress_config = CompressConfig(CompressCriteria.fixed)
    out = mps.evolve(Mpo(MODEL, offset=Quantity(e0)), 0.2)
    h = H_DENSE - e0 * np.eye(len(H_DENSE))
    expected = _taylor4(h, 0.2) @ _dense(init)
    expected *= np.linalg.norm(_dense(init)) / np.linalg.norm(expected)
    assert np.abs(_dense(out) - expected).max() < 1e-10


@pytest.fixture(scope="module")
def jax_start():
    """The start state and its energy, built once in the JAX package."""
    init = rj.Mpo.onsite(jmodel, r"a^\dagger", dof_set=[0]) @ rj.Mps.ground_state(jmodel, False)
    init = init.expand_bond_dimension(hint_mpo=rj.Mpo(jmodel))
    return init, init.expectation(rj.Mpo(jmodel))


@pytest.mark.slow
@pytest.mark.parametrize("name, kwargs, dt, steps", CASES, ids=IDS)
def test_pc_family_matches_jax(jax_start, name, kwargs, dt, steps):
    init, e0 = jax_start
    jmps = _configure(init.copy(), rj, kwargs)
    mps = _configure(interop.mps_from_object(MODEL, init), rt, kwargs)
    jmpo, mpo = rj.Mpo(jmodel, offset=rj.Quantity(e0)), Mpo(MODEL, offset=Quantity(e0))
    for _ in range(steps):
        jmps = jmps.evolve(jmpo, dt)
        mps = mps.evolve(mpo, dt)
    dist = np.linalg.norm(_dense(mps) - _dense(jmps))
    assert dist <= STATE_TOL, f"{name}: state distance {dist:.3e}"


def test_distance_resolves_small_differences_in_single_precision(start):
    """The adaptive steppers' error estimate: the distance between two
    single-precision states 1e-5 apart.  l1 + l2 - 2 Re l12 in float32
    rounds to ~3e-4 of the norm; taken in double precision it keeps the
    distance to a few percent."""
    init = start[0]
    other = init.copy()
    rng = np.random.default_rng(7)
    site = other[other.qnidx]
    other[other.qnidx] = site + 1e-5 * torch.as_tensor(
        rng.standard_normal(tuple(site.shape)), dtype=site.dtype)
    exact = init.distance(other)
    assert 1e-6 < exact < 1e-4
    for mp in (init, other):
        mp_single = mp.copy()
        mp_single._mp = [mt.float() for mt in mp]
        mp_single.dtype = torch.float32
        if mp is init:
            a = mp_single
        else:
            b = mp_single
    assert a.distance(b) == pytest.approx(exact, rel=5e-2)
    assert b.mp_norm == pytest.approx(other.mp_norm, rel=1e-6)
