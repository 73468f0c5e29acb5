"""The Lanczos tridiagonals of a TDVP-PS benchmark cell, and what their solve
does to the step.

    python3 tridiag_probe.py [--workload holstein-mps-tdvp] [--seed N ...]

Card only.  For each seed the cell's runner sets up as the benchmark does
(the random start and the warm-up steps, on the main path: CUDA graphs from
a key's second sighting).  From the state so reached one step runs in each
mode, every one from the same state:

* ``graphs``: the main path (replays);
* ``kernel``: eager, each tridiagonal on the Jacobi kernel (default sweeps);
* ``kernel+4``: eager, the kernel with four more base sweeps;
* ``cusolver``: eager, ``torch.linalg.eigh`` in the tridiagonal's precision;
* ``f64``: eager, ``torch.linalg.eigh`` of the tridiagonal in double
  precision, its eigenpairs cast back.

Each mode prints the step's ``step_dist`` against the benchmark's double
precision reference step (``portbench/reference/judge.py``).  The eager
modes also print, over the step's tridiagonals, the sweeps the kernel took,
its largest residual, and each solve's errors against ``torch.linalg.eigh``
in double precision: eigenvalues / ||T||_F, |U^T U - I|, and the exponential's
coefficients u exp(-i dt/2 w) u^T e_1.  The last line is a JSON object of
all of it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODES = ("graphs", "kernel", "kernel+4", "cusolver", "f64")


def _errors(t, w, u, dt):
    import torch

    w_ref, u_ref = torch.linalg.eigh(t.double())
    wd, ud = w.double(), u.double()
    norm = float(torch.linalg.matrix_norm(t.double()).clamp(min=1e-300))
    eye = torch.eye(t.shape[-1], dtype=torch.float64, device=t.device)
    phase, phase_ref = torch.exp(-0.5j * dt * wd), torch.exp(-0.5j * dt * w_ref)
    coef = (ud * ud[0]).to(phase.dtype) @ phase
    coef_ref = (u_ref * u_ref[0]).to(phase_ref.dtype) @ phase_ref
    return (float((wd - w_ref).abs().max()) / norm, float((ud.mT @ ud - eye).abs().max()),
            float((coef - coef_ref).abs().max()))


def _solver(mode, kept):
    import torch

    from renormalizer_tpu_torch.ops import jacobi

    def solve(t):
        if mode == "kernel":
            out = jacobi.kernel_eigh(t, return_resid=True, return_sweeps=True)
        elif mode == "kernel+4":
            out = jacobi.kernel_eigh(t, jacobi.default_sweeps(t.dtype) + 4,
                                     return_resid=True, return_sweeps=True)
        elif mode == "cusolver":
            out = tuple(torch.linalg.eigh(t)) + (None, None)
        else:
            w, u = torch.linalg.eigh(t.double())
            out = (w.to(t.dtype), u.to(t.dtype), None, None)
        kept.append((t.clone(),) + tuple(x.clone() if x is not None else None for x in out))
        return out

    return solve


def probe(workload, seed):
    sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]
    import torch
    from harness import spec as spec_mod
    from harness import workloads
    from reference import judge

    from renormalizer_tpu_torch.lib import solvers
    from renormalizer_tpu_torch.ops.jacobi import MAX_EXTRA_SWEEPS, default_sweeps

    spec = spec_mod.Spec(workload)
    runner = workloads.KINDS[spec.traffic["kind"]](spec.config, spec.traffic, seed, 1)
    t0 = time.perf_counter()
    runner.setup()
    torch.cuda.synchronize()
    print(f"[probe] seed {seed}: set-up {time.perf_counter() - t0:.2f} s", flush=True)
    state, dt = runner.state, runner.dt
    before = [t.clone() for t in state]
    first_to_right = bool(state.to_right)
    get, solve = solvers._DeviceGraphs.get, solvers._tridiag_eigh
    out = {}
    for mode in MODES:
        kept = []
        if mode != "graphs":
            solvers._DeviceGraphs.get = lambda self, *args: None
            solvers._tridiag_eigh = _solver(mode, kept)
        try:
            after = state.evolve(runner.operator, dt)
            torch.cuda.synchronize()
        finally:
            solvers._DeviceGraphs.get, solvers._tridiag_eigh = get, solve
        numbers = judge.tdvp_step(spec.config, runner.labels, before,
                                  [t.clone() for t in after], dt, first_to_right)
        row = {"step_dist": numbers["step_dist"]}
        if kept:
            errs = [_errors(t, w, u, dt) for t, w, u, _, _ in kept]
            row.update(solves=len(kept),
                       eig=max(e[0] for e in errs), orth=max(e[1] for e in errs),
                       coef=max(e[2] for e in errs))
            if kept[0][3] is not None:
                sweeps = [int(k[4]) for k in kept]
                row.update(sweeps={s: sweeps.count(s) for s in sorted(set(sweeps))},
                           at_cap=sum(s >= default_sweeps(torch.float32) + MAX_EXTRA_SWEEPS
                                      for s in sweeps),
                           resid=max(float(k[3]) for k in kept))
        print(f"[probe] seed {seed} {mode}: {row}", flush=True)
        out[mode] = row
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="holstein-mps-tdvp")
    parser.add_argument("--seed", type=int, nargs="+", default=[2 ** 31 + 11])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tridiag_probe.py runs on a card")
    rows = {seed: probe(args.workload, seed) for seed in args.seed}
    print(json.dumps({"workload": args.workload, "seeds": rows}), flush=True)


if __name__ == "__main__":
    main()
