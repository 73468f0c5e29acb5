"""The RKF45 right-hand sides of the MU-VMF ThermalProp steps of
``chip_smoke.py`` phase 10(d), by package and by the factorization of the
constructor's ``compress``.

The case is phase 10(d)'s: ``MpDm.max_entangled_ex`` of the bench chain
(6 molecules x 2 modes of 6 levels) at M=64, ``ThermalProp`` at 298 K, two
TDVP-PS steps of beta/20 from the expanded start, then MU-VMF steps of
beta/100.  Each MU-VMF step prints its right-hand sides (``nfev``) and
accepted RKF45 steps.

``port`` runs the PyTorch port; ``--factor`` puts another factorization in
the place of ``trunc_device._resolved_range`` (which only ``compress``
calls, so only the constructor's expansion changes), with the choices of
``padding_seed_probe.py``: ``deflate`` leaves the port's own (a full SVD per
sector block on the device), ``svd`` numpy's SVD on the host, ``svd-floor``
the SVD's directions above 64 eps |a| and seeded completions below (how the
deflation before the SVD chose the padding), ``gram`` one Gram pass.
``--gauge svd`` also factors MU-VMF's gauge sweep (inside every right-hand
side) by that full SVD, where the port takes one Gram pass.  ``jax`` runs
the JAX package on the same case, its ``compress`` on the host (``svd_qn``,
LAPACK).

Run from the root of the repo:
``RENO_PLATFORM=cpu RENO_DTYPE=fp32 python3 vmf_rhs_probe.py port --factor svd-floor``,
``JAX_PLATFORMS=cpu RENO_DTYPE=fp32 python3 vmf_rhs_probe.py jax``
(on the card: ``python3 vmf_rhs_probe.py port``).
"""

import argparse
import time

M = 64
WARM_STEPS = 2
VMF_DIV = 100


def _chain(pkg):
    ph_list = [pkg.Phonon.simple_phonon(pkg.Quantity(w, "cm-1"), pkg.Quantity(d), 6)
               for w, d in zip([106.51, 1555.55], [30.1370, 8.7729])]
    mol = pkg.Mol(pkg.Quantity(2.67, "eV"), ph_list)
    return pkg.HolsteinModel([mol] * 6, pkg.Quantity(-0.1, "eV"))


def run(pkg, count, steps):
    """``count()`` reads the (right-hand sides, accepted steps) so far."""
    model = _chain(pkg)
    beta = pkg.Quantity(298, "K").to_beta()
    rho = pkg.MpDm.max_entangled_ex(model)
    rho.compress_config = pkg.CompressConfig(pkg.CompressCriteria.fixed, max_bonddim=M)
    t0 = time.perf_counter()
    tp = pkg.ThermalProp(rho, evolve_config=pkg.EvolveConfig(pkg.EvolveMethod.tdvp_ps))
    tp.evolve(None, WARM_STEPS, beta / 20j)
    print(f"constructor and {WARM_STEPS} TDVP-PS steps {time.perf_counter() - t0:.2f} s; "
          f"bond dims {tp.latest_mps.bond_dims}", flush=True)
    tp.latest_mps.evolve_config = pkg.EvolveConfig(pkg.EvolveMethod.tdvp_mu_vmf)
    for _ in range(steps):
        before = count()
        t0 = time.perf_counter()
        tp.evolve(None, 1, beta / VMF_DIV / 1j)
        after = count()
        print(f"MU-VMF step of beta/{VMF_DIV}: nfev {after[0] - before[0]}, accepted "
              f"steps {after[1] - before[1]}, {time.perf_counter() - t0:.2f} s; energy "
              f"{float(tp.energies[-1]):.9f}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("package", choices=["port", "jax"])
    parser.add_argument("--factor", default="deflate",
                        choices=["deflate", "gram", "svd", "svd-floor", "svd-zero"])
    parser.add_argument("--gauge", default="gram", choices=["gram", "svd"])
    parser.add_argument("--steps", type=int, default=1)
    args = parser.parse_args()
    if args.package == "port":
        import renormalizer_tpu_torch as pkg
        from padding_seed_probe import _factor
        from renormalizer_tpu_torch.backend import backend
        from renormalizer_tpu_torch.mps import trunc_device
        from renormalizer_tpu_torch.utils.profiling import COUNTERS

        _factor(args.factor)
        if args.gauge == "svd":
            compress_factors = trunc_device.compress_factors
            trunc_device.compress_factors = lambda *a, resolve=False: compress_factors(
                *a, resolve=True)
        print(f"port, factor={args.factor}, gauge={args.gauge}, {backend.device}, "
              f"{backend.real_dtype}", flush=True)
        run(pkg, lambda: (COUNTERS["ivp.nfev"], COUNTERS["ivp.nsteps"]), args.steps)
        return
    import renormalizer_tpu as pkg
    from renormalizer_tpu.mps import mps as jmps

    counts = [0, 0]
    solve_ivp = jmps.solve_ivp

    def counting(*a, **k):
        sol = solve_ivp(*a, **k)
        counts[0] += sol.nfev
        counts[1] += sol.nsteps
        return sol

    jmps.solve_ivp = counting
    print("JAX package", flush=True)
    run(pkg, lambda: tuple(counts), args.steps)


if __name__ == "__main__":
    main()
