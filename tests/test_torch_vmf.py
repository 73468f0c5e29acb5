"""The port's two-site TDVP-PS, MU-VMF/VMF and MU-CMF, fp64 on the CPU.

Protocol of ``tests/test_evolve.py`` on the 3-molecule, 2-level Holstein
model (start state a^dagger_0 |gs> expanded with the Hamiltonian as hint,
built once in the JAX package and carried over): each method against the
dense ``scipy.linalg.expm`` to that file's bounds, and one step of each from
the carried state against the JAX package's step.  One imaginary-time
MU-VMF step of an expanded ``MpDm`` (4-leg sites) against the dense
exp(-tau H).  The one-step comparisons other than MU-VMF are ``slow``:
``python -m pytest -m slow tests/test_torch_vmf.py``."""

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
    Mpo,
    Mol,
    Phonon,
    Quantity,
    interop,
)
from renormalizer_tpu_torch.mps.mps import _mu_regularize
from renormalizer_tpu_torch.utils import profiling

torch.set_num_threads(2)

jmodel = exact_model()
H_DENSE = dense_hamiltonian(jmodel)
OCC_DENSE = [
    dense_hamiltonian(JaxModel(jmodel.basis, [rj.Op(r"a^\dagger a", dof)]))
    for dof in jmodel.e_dofs
]


def port_exact_model() -> HolsteinModel:
    """``tests/fixtures.py``'s ``exact_model`` in the port."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


def _jax_init():
    tentative_mpo = rj.Mpo(jmodel)
    init = rj.Mpo.onsite(jmodel, r"a^\dagger", dof_set=[0]) @ rj.Mps.ground_state(jmodel, False)
    init = init.expand_bond_dimension(hint_mpo=tentative_mpo)
    e0 = init.expectation(tentative_mpo)
    return init, rj.Mpo(jmodel, offset=rj.Quantity(e0)), e0


JAX_INIT, JAX_MPO, E0 = _jax_init()
MODEL = port_exact_model()
MPO = Mpo(MODEL, offset=Quantity(E0))


def _configs(pkg):
    """``tests/test_evolve.py``'s configs, and MU-CMF's with the trapezoid
    correction at MU-CMF's dt and bound: (evolve config, compress config or
    None, oracle dt, oracle final time, oracle bound, one-step dt)."""
    vmf = {}
    for method in ("tdvp_mu_vmf", "tdvp_vmf"):
        cfg = pkg.EvolveConfig(pkg.EvolveMethod[method], ivp_rtol=1e-4,
                               ivp_atol=1e-7, force_ovlp=False)
        cfg.vmf_auto_switch = False
        vmf[method] = (cfg, None, 1.0, 1.0, 1e-4, 0.2)
    # MU-CMF with the trapezoid correction of the last site
    trapz = pkg.EvolveConfig(pkg.EvolveMethod.tdvp_mu_cmf)
    trapz.tdvp_cmf_c_trapz = True
    return {
        "tdvp_ps2": (pkg.EvolveConfig(pkg.EvolveMethod.tdvp_ps2),
                     pkg.CompressConfig(threshold=1e-6), 0.2, 2.0, 1e-4, 0.2),
        **vmf,
        "tdvp_mu_cmf": (pkg.EvolveConfig(pkg.EvolveMethod.tdvp_mu_cmf), None,
                        0.02, 0.06, 5e-4, 0.02),
        "tdvp_mu_cmf_trapz": (trapz, None, 0.02, 0.06, 5e-4, 0.02),
    }


METHODS = list(_configs(rj))


def _port_state(method):
    cfg, cc, *_ = _configs(__import__("renormalizer_tpu_torch"))[method]
    mps = interop.mps_from_object(MODEL, JAX_INIT)
    mps.evolve_config = cfg
    if cc is not None:
        mps.compress_config = cc
    return mps


@pytest.mark.parametrize("method", METHODS)
def test_dense_oracle(method):
    """Mean cumulative deviation of the electronic occupations from the
    dense expm, to ``tests/test_evolve.py``'s bound for the method."""
    _, _, dt, final, bound, _ = _configs(rj)[method]
    nsteps = round(final / dt)
    mps = _port_state(method)
    psi0 = JAX_INIT.todense().astype(complex)
    h = H_DENSE - E0 * np.eye(H_DENSE.shape[0])
    deviations = []
    for i in range(1, nsteps + 1):
        mps = mps.evolve(MPO, dt)
        psit = scipy.linalg.expm(-1j * h * dt * i) @ psi0
        oracle = [np.real(psit.conj() @ o @ psit) for o in OCC_DENSE]
        deviations.append(np.abs(np.array(mps.e_occupations) - oracle).mean())
    assert np.mean(deviations) < bound
    assert mps.mp_norm == pytest.approx(1.0, abs=1e-10)


# a JAX job compiles for 10-30 s on the CPU: MU-VMF (the method the jobs and
# ``chip_smoke.py`` run) is held against it in Tier-1, the others are slow
ONE_STEP = [m if m == "tdvp_mu_vmf" else pytest.param(m, marks=pytest.mark.slow)
            for m in METHODS]


@pytest.mark.parametrize("method", ONE_STEP)
def test_one_step_matches_jax(method):
    """One step from the carried state in both packages: the same state to
    1e-8, and for VMF one RKF45 solve.

    MU-CMF integrates each site's equation of motion by RKF45 at SciPy's
    default tolerances (rtol 1e-3, atol 1e-6, as the reference); on this
    expanded state the middle site's equation is stiff (1/reg(s) ~ 1e5 for
    its 1e-13 singular values) and takes ~410 steps, and a rounding-level
    change decides a few of them differently: the JAX package's own step
    moves by 1.9e-7 when its start state is perturbed by 1e-15 (412 against
    414 accepted steps here).  So MU-CMF is held to the same state up to
    that: overlap within 1e-12 of 1, vector within 1e-6, occupations
    within 1e-8."""
    jcfg, jcc, *_, dt = _configs(rj)[method]
    jstate = JAX_INIT.copy()
    jstate.evolve_config = jcfg
    if jcc is not None:
        jstate.compress_config = jcc
    jout = jstate.evolve(JAX_MPO, dt)
    before = profiling.snapshot()
    out = _port_state(method).evolve(MPO, dt)
    assert out.bond_dims == jout.bond_dims
    vec, jvec = out.todense(), jout.todense()
    if method.startswith("tdvp_mu_cmf"):
        assert abs(abs(np.vdot(vec, jvec)) - 1) < 1e-12
        assert np.abs(vec - jvec).max() < 1e-6
        assert np.abs(np.array(out.e_occupations)
                      - np.array(jout.e_occupations)).max() < 1e-8
    else:
        assert np.abs(vec - jvec).max() < 1e-8
    if "vmf" in method:
        counts = profiling.delta(before)
        assert counts["ivp.solves"] == 1
        assert counts["ivp.nfev"] > 0


def test_imaginary_time_mu_vmf_mpdm_dense_oracle():
    """One imaginary-time MU-VMF step of an expanded infinite-temperature
    ``MpDm`` (4-leg sites: the 4-leg branches of the projector, the
    integrand and the transfer matrix; real Grams through the Jacobi
    kernel's plain version here) on the 2-molecule chain at its exact bond
    dimension: the purification is exp(-tau H) of the start one, to the
    RKF45 tolerance (rtol 1e-5)."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph], 1.0)] * 2, Quantity(1), 3)
    h = Mpo(model)
    rho = MpDm.max_entangled_ex(model)
    rho.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=16)
    rho = rho.expand_bond_dimension(h)
    assert rho.bond_dims == [1, 4, 16, 4, 1]
    assert all(mt.ndim == 4 for mt in rho)
    rho.evolve_config = EvolveConfig(EvolveMethod.tdvp_mu_vmf)
    tau = 0.005
    before = profiling.snapshot()
    out = rho.evolve(h, -1j * tau)
    assert profiling.delta(before)["ivp.solves"] == 1
    assert isinstance(out, MpDm) and not out.is_complex
    start = rho.todense()
    oracle = scipy.linalg.expm(-tau * h.todense()) @ start
    got = out.todense()
    np.testing.assert_allclose(got / np.linalg.norm(got),
                               oracle / np.linalg.norm(oracle), atol=1e-5)
    assert out.expectation(h) < rho.expectation(h)


def test_tdvp_ps2_raises_on_ofs():
    """TDVP-PS2 carries OFS, and, as in the JAX package
    (``renormalizer_tpu/mps/mp.py:929``), OFS raises on a HolsteinModel,
    whose basis order the model's own bookkeeping fixes; on a generic
    ``Model`` it swaps (``tests/test_torch_qc.py``)."""
    from renormalizer_tpu_torch.utils import OFS

    mps = _port_state("tdvp_ps2")
    mps.compress_config = CompressConfig(ofs=OFS.ofs_s)
    with pytest.raises(NotImplementedError, match="OFS on Holstein model"):
        mps.evolve(MPO, 0.2)


def test_tdvp_ps2_sends_complex_grams_to_linalg_eigh():
    """Real-time TDVP-PS2 truncates a complex 2-site tensor: its Grams go to
    ``torch.linalg.eigh`` and are counted."""
    before = profiling.snapshot()
    _port_state("tdvp_ps2").evolve(MPO, 0.2)
    assert profiling.delta(before)["trunc.linalg_eigh_grams"] > 0


def test_mu_regularize_matches_on_host_and_device():
    """``_mu_regularize`` against the closed form s + sqrt(eps) exp(-s /
    sqrt(eps)) of the reference, at its default eps = 1e-10 and another."""
    s = np.array([0.0, 1e-10, 1e-5, 0.3, 1.0])
    for eps in (1e-10, 1e-6):
        dev = _mu_regularize(torch.as_tensor(s), epsilon=eps).numpy()
        closed = s + np.sqrt(eps) * np.exp(-s / np.sqrt(eps))
        np.testing.assert_allclose(dev, closed, rtol=1e-15)
    reg = _mu_regularize(torch.as_tensor(s)).numpy()
    # padding directions (s ~ 1e-10) are damped: s / reg(s) ~ 1e-5
    assert reg[1] == pytest.approx(1e-5, rel=1e-4)
    assert (s / reg)[1] < 2e-5


_FP32_SCRIPT = r'''
import json
import numpy as np
import scipy.linalg
import torch
from renormalizer_tpu_torch import *
from renormalizer_tpu_torch.lib import solvers
from renormalizer_tpu_torch.mps import mps as port_mps

torch.set_num_threads(2)
ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
init = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
init = init.expand_bond_dimension(hint_mpo=Mpo(model))
e0 = init.expectation(Mpo(model))
mpo = Mpo(model, offset=Quantity(e0))
h = Mpo(model).todense() - e0 * np.eye(64)
psi = scipy.linalg.expm(-1j * h) @ init.todense().astype(complex)
occ = [Mpo(model, Op(r"a^\dagger a", d)).todense() for d in model.e_dofs]
dense = [np.real(psi.conj() @ o @ psi) for o in occ]


class Capped(Exception):
    pass


def step(method, narrow, cap=2000):
    # one step of 1.0; ``narrow`` integrates in single precision, and a
    # solve stops after ``cap`` right-hand sides
    config = EvolveConfig(method, ivp_rtol=1e-4, ivp_atol=1e-7, force_ovlp=False)
    config.vmf_auto_switch = False
    saved = port_mps._retype, port_mps._double_mpo_twin, solvers.solve_ivp
    if narrow:
        port_mps._retype, port_mps._double_mpo_twin = (lambda mp, dt: None), (lambda m: m)
    calls = [0]

    def capped_solve(fun, *args, **kwargs):
        def counted(t, y):
            calls[0] += 1
            if calls[0] > cap:
                raise Capped
            return fun(t, y)
        return saved[2](counted, *args, **kwargs)

    solvers.solve_ivp = capped_solve
    try:
        mps = init.copy()
        mps.evolve_config = config
        mps = mps.evolve(mpo, 1.0)
    except Capped:
        return {"nfev": None}
    finally:
        port_mps._retype, port_mps._double_mpo_twin, solvers.solve_ivp = saved
    return {"nfev": calls[0], "dtype": str(mps[0].dtype),
            "deviation": float(np.abs(np.array(mps.e_occupations) - dense).mean())}


print(json.dumps({
    "mu_vmf double": step(EvolveMethod.tdvp_mu_vmf, False),
    "vmf double": step(EvolveMethod.tdvp_vmf, False),
    "vmf single": step(EvolveMethod.tdvp_vmf, True)}))
'''


def test_vmf_integrates_in_double_precision_in_fp32():
    """In single precision (a subprocess with RENO_DTYPE=fp32) one step of
    1.0 on ``tests/test_evolve.py``'s chain: integrated in double precision
    MU-VMF and VMF take about the fp64 run's right-hand sides (212 and 314)
    and return complex64 states within that file's 1e-4; VMF integrated in
    single precision, where the regularized inverse reaches 1/reg ~ 1e10,
    turns rounding into noise of the right-hand side and its RKF45 step
    collapses: more than 2000 right-hand sides without reaching t = 1.
    (Single-precision MU-VMF took 290 once its complex Grams went to a
    double-precision eigh, and did not finish while they did not.)"""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, RENO_DTYPE="fp32", RENO_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-c", _FP32_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("mu_vmf double", "vmf double"):
        assert res[key]["dtype"] == "torch.complex64"
        assert res[key]["nfev"] < 400
        assert res[key]["deviation"] < 1e-4
    assert res["vmf single"]["nfev"] is None
