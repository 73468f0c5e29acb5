"""H2O/STO-3G on the CPU in both packages: the seconds and bond dimensions
of ``Mpo(model)`` (the MPO compiler's host time on the 1140 Jordan-Wigner
terms), and with ``--dmrg`` the 2-site QC-DMRG of ``chip_smoke.py`` phase
13 (M=50, [5, 5] electrons) with each package's lowest energy against the
published FCI energy.

Run from the root of the repo, on the CPU, once per precision:
``JAX_PLATFORMS=cpu RENO_PLATFORM=cpu RENO_DTYPE=fp32 python3 qc_host_probe.py --dmrg``.
``--seeds 2019 0 1`` runs only the port's DMRG, once at each seed of its
generator (the start ``Mps.random`` draws).
"""

import argparse
import time

import numpy as np

H2O_FCIDUMP = "tests/data/h2o_fcidump.txt"
H2O_FCI = -75.008697516450
M = 50


def run(name, pkg, h_qc, optimize_mps, dmrg):
    h1e, h2e, nuc = h_qc.read_fcidump(H2O_FCIDUMP, 7)
    t0 = time.perf_counter()
    basis, ham_terms = h_qc.qc_model(h1e, h2e)
    model = pkg.Model(basis, ham_terms)
    mpo = pkg.Mpo(model)
    print(f"{name}: Mpo(model) of {len(ham_terms)} terms {time.perf_counter() - t0:.2f} s "
          f"(CPU); bond dims {mpo.bond_dims}", flush=True)
    if not dmrg:
        return
    mps = pkg.Mps.random(model, [5, 5], M, percent=1.0)
    mps.optimize_config.procedure = [[M, 0.4], [M, 0.2], [M, 0.1]] + [[M, 0]] * 6
    mps.optimize_config.method = "2site"
    t0 = time.perf_counter()
    energies, _ = optimize_mps(mps, mpo)
    e = [float(np.min(np.asarray(x))) + nuc for x in energies]
    print(f"{name}: {len(e)} sweeps in {time.perf_counter() - t0:.2f} s (CPU, compilation "
          f"included); energies {[round(x, 12) for x in e]}; lowest - FCI "
          f"{min(e) - H2O_FCI:+.3e}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dmrg", action="store_true")
    parser.add_argument("--seeds", type=int, nargs="+")
    args = parser.parse_args()
    import renormalizer_tpu_torch as rt
    from renormalizer_tpu_torch.model import h_qc as t_h_qc

    name = f"port fp{64 if not rt.backend.is_32bits else 32}"
    if args.seeds:
        for seed in args.seeds:
            rt.backend._seed = seed
            run(f"{name} seed {seed}", rt, t_h_qc, rt.optimize_mps, True)
        return
    run(name, rt, t_h_qc, rt.optimize_mps, args.dmrg)
    import renormalizer_tpu as rj
    from renormalizer_tpu.model import h_qc as j_h_qc
    from renormalizer_tpu.mps.gs import optimize_mps

    run("JAX package", rj, j_h_qc, optimize_mps, args.dmrg)


if __name__ == "__main__":
    main()
