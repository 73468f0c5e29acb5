#!/usr/bin/env python3
"""Energy witness of the port's DMRG main path on one GPU.

Runs the main path of chip_smoke.py (the bench model, M=256, 2-site) in the
precision RENO_DTYPE selects, and prints the lowest sweep energy and
<psi|H|psi> of the result.  It tells apart what moves the converged energy
at the 1e-7 level: the Gram eigensolver, the start state, the precision.

    python3 energy_witness.py [--eigh kernel|plain|plain-relative]
                              [--seed S ...] [--save PREFIX] [--eval FILE ...]

--eigh    the truncation's Gram eigh: the CUDA kernel (default), its plain
          torch twin (same algorithm and stop test, other rounding), or the
          plain twin with the relative stop test alone (no eps ||A||_F / n
          part in the rotation threshold);
--seed    start-state and sketch seeds, one run each (default 2019, the
          backend's);
--save    writes each result's site tensors to PREFIX_<seed>.npz;
--eval    first evaluates <psi|H|psi> of saved results in this run's
          precision: RENO_DTYPE=fp64 evaluates fp32 results in fp64.

Each result is one line starting with [witness].  The script imports
chip_smoke.py from its own directory, so a copy of it placed in another
checkout of the repository runs that checkout's package.
"""

import argparse
import sys
import time

import numpy as np

from chip_smoke import M, PROCEDURE, bench_model


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eigh", choices=("kernel", "plain", "plain-relative"),
                    default="kernel")
    ap.add_argument("--seed", type=int, nargs="+", default=[2019])
    ap.add_argument("--save")
    ap.add_argument("--eval", nargs="*", default=[])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("energy_witness: no CUDA device visible")
    from renormalizer_tpu_torch import Mpo, Mps, optimize_mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops import jacobi

    prec = "fp32" if backend.is_32bits else "fp64"
    model = bench_model()
    mpo = Mpo(model)
    for path in args.eval:
        sites = np.load(path)
        mps = Mps.random(model, 1, M, percent=1.0)
        for i in range(len(mps)):
            mps[i] = sites[f"arr_{i}"]
        print(f"[witness] {path}: <psi|H|psi> in {prec} "
              f"{mps.expectation(mpo):.10f}", flush=True)

    if args.eigh != "kernel":
        trunc_device.jacobi_eigh = jacobi.jacobi_eigh_reference
    if args.eigh == "plain-relative":
        jacobi._floor = lambda norm2, n: torch.full_like(
            norm2, torch.finfo(norm2.dtype).tiny)
    for seed in args.seed:
        backend._seed = seed
        mps = Mps.random(model, 1, M, percent=1.0)
        mps.optimize_config.procedure = PROCEDURE
        mps.optimize_config.method = "2site"
        t0 = time.perf_counter()
        energies, opt = optimize_mps(mps, mpo)
        backend.sync()
        seconds = time.perf_counter() - t0
        e_min = float(min(energies))
        e_exp = opt.expectation(mpo)
        print(f"[witness] {prec} eigh={args.eigh} seed={seed}: lowest energy "
              f"{e_min:.10f}, <psi|H|psi> {e_exp:.10f} (gap "
              f"{e_exp - e_min:+.3e}), {seconds:.2f} s", flush=True)
        if args.save:
            np.savez(f"{args.save}_{seed}.npz",
                     *[t.detach().cpu().numpy() for t in opt])


if __name__ == "__main__":
    main()
