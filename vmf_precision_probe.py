"""MU-VMF in single precision: the port's double-precision integration
against integration in the working precision with only the gauge
factorizations in double precision.

The port integrates MU-VMF and VMF in double precision whatever the working
precision (``Mps._evolve_tdvp_mu_vmf``).  The narrower alternative ("grams")
keeps the state, the MPO and the RKF45 solve in complex64/float32 and casts
each right unfolding to double precision before
``trunc_device.compress_factors``, so that its Gram is formed and solved in
double precision (complex Grams by ``torch.linalg.eigh`` in complex128, real
ones by the Jacobi kernel's f64 path); the factors are cast back.

Three cases, from one start state each, the two modes taking turns (wide,
grams, grams, wide), every step between two device syncs:
  (a) ``tests/test_evolve.py``'s 3-molecule chain, one step of 1.0 against
      the dense expm (``chip_smoke.py`` phase 10(a));
  (b) ``ChargeDiffusionDynamics`` on the bench chain at M=64, one step of
      1 a.u. (phase 10(b));
  (d) ``ThermalProp`` of the bench chain's MpDm at 298 K after two TDVP-PS
      steps of beta/20, one MU-VMF step of beta/100 (phase 10(d)).
Each step prints seconds, RKF45 nfev/nsteps and its accuracy: (a) the mean
deviation of the occupations from the dense ones, (b) the <H> drift and the
norm, (d) the energy, to be compared between the modes; a step that raises
prints its error instead.

Run from the root of the repo on a CUDA card: ``python3 vmf_precision_probe.py``
(fp32).  ``--small`` runs case (a) only, which also runs on the CPU with
``RENO_PLATFORM=cpu RENO_DTYPE=fp32``.
"""

import contextlib
import json
import sys
import time

import numpy as np
import scipy.linalg

from chip_smoke import dense_operator, holstein_chain
from renormalizer_tpu_torch import (
    CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod, HolsteinModel,
    MpDm, Mol, Mpo, Mps, Op, Phonon, Quantity, ThermalProp)
from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib import solvers
from renormalizer_tpu_torch.mps import mps as port_mps, trunc_device
from renormalizer_tpu_torch.transport import ChargeDiffusionDynamics

ORDER = ("wide", "grams", "grams", "wide")


@contextlib.contextmanager
def precision(mode):
    """``wide``: the port as it is; ``grams``: integrate in the working
    precision, factorize each right unfolding in double precision."""
    if mode == "wide":
        yield
        return
    saved = port_mps._retype, port_mps._double_mpo_twin, trunc_device.compress_factors
    factors = saved[2]

    def double_factors(coef, *args):
        u, s, qnl, v, s2, qnr = factors(trunc_device._double(coef), *args)
        return u.to(coef.dtype), s, qnl, v.to(coef.dtype), s2, qnr

    port_mps._retype = lambda mp, dtype: None
    port_mps._double_mpo_twin = lambda mpo: mpo
    trunc_device.compress_factors = double_factors
    try:
        yield
    finally:
        port_mps._retype, port_mps._double_mpo_twin, trunc_device.compress_factors = saved


def run(case, step, measure):
    """``step()`` returns the evolved state; ``measure(state)`` a dict.  A
    step that raises is printed with its error, and the next one runs."""
    for mode in ORDER:
        before = dict(solvers.IVP_COUNTS)
        with precision(mode):
            backend.sync()
            t0 = time.perf_counter()
            try:
                out = step()
                backend.sync()
            except RuntimeError as err:  # torch's LinAlgError included
                out = None
                error = f"{type(err).__name__}: {str(err)[:160]}"
            seconds = time.perf_counter() - t0
        row = {"case": case, "mode": mode, "seconds": round(seconds, 4),
               "nfev": solvers.IVP_COUNTS["nfev"] - before["nfev"],
               "nsteps": solvers.IVP_COUNTS["nsteps"] - before["nsteps"]}
        row.update({"error": error} if out is None else
                   {"dtype": str(out[0].dtype), **measure(out)})
        print(json.dumps(row), flush=True)


def case_small():
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    init = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
    init = init.expand_bond_dimension(hint_mpo=Mpo(model))
    e0 = init.expectation(Mpo(model))
    mpo = Mpo(model, offset=Quantity(e0))
    h = dense_operator(model, model.ham_terms) - e0 * np.eye(2 ** 6)
    psi = scipy.linalg.expm(-1j * h) @ init.todense().astype(complex)
    dense = [np.real(psi.conj() @ dense_operator(model, [Op(r"a^\dagger a", d)]) @ psi)
             for d in model.e_dofs]
    init.evolve_config = EvolveConfig(EvolveMethod.tdvp_mu_vmf, ivp_rtol=1e-4,
                                      ivp_atol=1e-7, force_ovlp=False)
    init.evolve_config.vmf_auto_switch = False
    run("a", lambda: init.copy().evolve(mpo, 1.0), lambda out: {
        "deviation": float(np.abs(np.array(out.e_occupations) - dense).mean()),
        "norm": out.mp_norm})


def case_charge(m=64, dt=1.0):
    job = ChargeDiffusionDynamics(
        holstein_chain(6), compress_config=CompressConfig(CompressCriteria.fixed, max_bonddim=m),
        evolve_config=EvolveConfig(EvolveMethod.tdvp_mu_vmf), stop_at_edge=False)
    e0 = job.latest_mps.expectation(job.mpo)
    run("b", lambda: job.evolve_single_step(dt), lambda out: {
        "drift": abs(float(np.real(out.expectation(job.mpo))) - e0), "norm": out.mp_norm})


def case_thermal(m=64, div=100):
    model = holstein_chain(6)
    beta = Quantity(298, "K").to_beta()
    rho = MpDm.max_entangled_ex(model)
    rho.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=m)
    tp = ThermalProp(rho, evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
    tp.evolve(None, 2, beta / 20j)
    tp.latest_mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_mu_vmf)
    run("d", lambda: tp.evolve_single_step(beta / div / 1j), lambda out: {
        "energy": float(np.real(out.expectation(tp.h_mpo)))})


def main():
    print(f"[precision] {backend.device} {backend.complex_dtype}", flush=True)
    case_small()
    if "--small" not in sys.argv[1:]:
        case_charge()
        case_thermal()


if __name__ == "__main__":
    main()
