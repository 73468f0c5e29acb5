#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (renormalizer_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit; the port's device is CUDA;
  2. build: compiles csrc/*.cu with nvcc for sm_90a (first use);
  3. kernel versus plain: the block-Jacobi eigensolver kernel and its plain
     torch version on the same seeded matrices, both held against
     torch.linalg.eigh (tolerances relative to ||A||_F: eigenvalues 1e-5 f32
     / 1e-11 f64, |V^T V - I| 1e-4 / 1e-12, |AV - VL| 1e-4 / 1e-11, up to
     n = 288; past n = 288 the f32 tolerances grow as n / 288), the ten
     (1, n, n) shapes that phase 6(d) solves among them; then, at the DMRG
     path's shapes (2, 288, 288) and (1, 544, 544) and the evolution path's
     (1, 48, 48), f32, the kernel, the plain version and torch.linalg.eigh
     timed in turns, the sweeps each timed solve took, and the kernel's
     bound;
  4. main path: 2-site DMRG of the 6-molecule Holstein chain (18 sites) at
     M=256 in fp32, through Mps.random / Mpo / optimize_mps; the energy must be
     within 1e-6 of 0.11503887 and the truncation's Gram eigh must have gone
     through the kernel.  Each Gram eigh's residual and sweep count are kept
     on the device and read once at the end: the script prints how many
     launches ran to the sweep cap and the (batch, n) histogram.
  5. evolution against a dense oracle (fp32/complex64): 10 TDVP-PS steps of
     0.2 on the 3-molecule, 2-level Holstein model (electronic occupations)
     and on a 3-mode spin-boson model through SpinBosonDynamics (sigma_z),
     against scipy.linalg.expm of a kron-assembled dense Hamiltonian: mean
     cumulative deviation < 1e-4, norm within 1e-5 of 1, all finite;
  6. the evolution path at full width, one first step and 4 timed steps of
     TDVP-PS (dt 0.2) each: (a) the 32-site spin-boson chain at M=48 from a
     random state, (b) the qn-structured 6-molecule, 4-level Holstein chain
     at M=48, (c) the DMRG path's 6-level chain at M=256, (d) the
     SpinBosonDynamics job on the 32-site chain at M=48, whose constructor
     compresses real states (Jacobi kernel launches > 0, no real Gram eigh
     elsewhere; the (batch, n) of every launch, its sweeps and residual are
     printed, none may run to the sweep cap or have a shape that phase 3 did
     not hold, and every one of these Grams is solved again by the plain
     version and compared).  After every step: norm within 1e-4 of 1, <psi|H|psi>
     constant within ENERGY_RTOL * max(1, |E|), all tensors finite; in (d)
     sigma_z(0) = 1 and |sigma_z| <= 1 + 1e-5.  Prints seconds per step, bond
     dimensions and the site visits by branch (fused / unfused).
A [summary] line repeats the run's times as JSON, so that the end of the
output carries them.  The line before the last holds the kernel record as
JSON; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.

    python3 chip_smoke.py --profile

runs the DMRG main path under torch.profiler and adds its device time per
kernel and the card's busy share of that run's wall time; then (phase 7) it
does the same for one more TDVP-PS step of each of 6(a)-(d) and counts that
step's host synchronisations.
"""

import collections
import contextlib
import json
import subprocess
import sys
import time

E_REF = 0.11503887      # converged bench energy, M=256, fp32
E_TOL = 1e-6
M = 256
PROCEDURE = [[M, 0.4], [M, 0.2]] + [[M, 0]] * 6
JACOBI_SOURCE = "renormalizer_tpu_torch/csrc/jacobi.cu"
JACOBI_REPLACES = "renormalizer_tpu/ops/jacobi.py:238"
# Energy drift allowed per phase-6 run, relative to max(1, |E|).  One-site
# TDVP-PS conserves <H> exactly (each Krylov propagation is unitary inside its
# space and commutes with the projected H), so the drift is rounding only: a
# CPU fp64 run of the same four configurations at M=16 (M=8 for (c)) drifts
# by at most 8e-15 of that scale over 5 steps, the same runs in fp32 by at
# most 2.9e-6 (each <psi|H|psi> is itself a sum of ~1e3 fp32 terms); 5e-5
# leaves a factor of 17 over that and is 20x tighter than 1e-3.
ENERGY_RTOL = 5e-5
NORM_TOL = 1e-4
# n of the (1, n, n) f32 Grams that the SpinBosonDynamics constructor of phase
# 6(d) solves (32 sites, M=48); phase 3 holds the kernel against its plain
# version at each, and 6(d) fails if it solves a shape that is not listed
EVOLVE_PATH_GRAMS = (2, 3, 8, 9, 12, 27, 32, 39, 48, 75)
# published H100 SXM peaks at 700 W (NVIDIA data sheet): FP32 outside the
# tensor cores, HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_times_in_turns(fns, reps):
    """Median milliseconds of each ``fns[name]()`` by CUDA events, after one
    warm-up each; the functions take turns, ``reps[name]`` times each."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for i in range(max(reps.values())):
        for name, fn in fns.items():
            if i >= reps[name]:
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def jacobi_bound_ms(bsz, n, itemsize):
    """Least time of a (bsz, n, n) symmetric eigendecomposition with
    eigenvectors on the card, and what sets it: the textbook ~9 n^3
    operations per matrix (symmetric QR with eigenvectors, Golub & Van Loan
    §8.3; about one sweep of scalar Jacobi, 9 n^2 (n - 1)) over the FP32
    peak, against each input read once and each output (V, w) written once
    over the HBM rate.  It does not depend on the sweeps a solver takes."""
    flops = 9.0 * n ** 3 * bsz
    nbytes = itemsize * bsz * (2 * n * n + n)
    ms_ops, ms_bytes = 1e3 * flops / FP32_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ms_ops, "operations") if ms_ops >= ms_bytes else (ms_bytes, "bytes")


def phase_environment():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    from renormalizer_tpu_torch.backend import backend

    check(backend.device.type == "cuda", f"port device is {backend.device}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name} "
          f"count {torch.cuda.device_count()} port {backend.device} "
          f"fp{32 if backend.is_32bits else 64}", flush=True)
    return name, card


def phase_build():
    from renormalizer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    print(f"[build] {_build.build_info['path']} in {seconds:.2f} s "
          f"(nvcc {_build.build_info['seconds']:.2f} s)", flush=True)
    for line in _build.build_info["log"].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"[build] {line.strip()}", flush=True)


def _symmetric(rng, shape, dtype):
    import numpy as np
    import torch

    a = rng.standard_normal(shape)
    a = (a + np.swapaxes(a, -1, -2)) / 2
    return torch.tensor(a, dtype=dtype, device="cuda")


def _eigh_errors(a, w, v):
    """Errors of (w, v) relative to ||A||_F (the norm of the Jacobi
    convergence rule): eigenvalues against torch.linalg.eigvalsh in f64,
    |V^T V - I| and |AV - V diag(w)|, each as a max over entries."""
    import torch

    a3, w2, v3 = (a, w, v) if a.ndim == 3 else (a[None], w[None], v[None])
    ad, wd, vd = a3.double(), w2.double(), v3.double()
    norm = torch.linalg.matrix_norm(ad)[:, None]
    err_w = float(((wd - torch.linalg.eigvalsh(ad)).abs() / norm).max())
    eye = torch.eye(a3.shape[-1], dtype=torch.float64, device=a.device)
    err_o = float((vd.mT @ vd - eye).abs().max())
    err_r = float(((ad @ vd - vd * wd[:, None, :]).abs() / norm[:, :, None]).max())
    return err_w, err_o, err_r


def _check_eigh(tag, errors, tol):
    err_w, err_o, err_r = errors
    check(err_w < tol["eig"], f"{tag}: eigenvalues off by {err_w:.2e}·|A|")
    check(err_o < tol["orth"], f"{tag}: |V^T V - I| = {err_o:.2e}")
    check(err_r < tol["resid"], f"{tag}: |AV - VL| = {err_r:.2e}·|A|")


def phase_kernels():
    import numpy as np
    import torch

    from renormalizer_tpu_torch.ops.jacobi import (
        MAX_EXTRA_SWEEPS, default_sweeps, jacobi_eigh, jacobi_eigh_reference)

    tols = {torch.float32: dict(eig=1e-5, orth=1e-4, resid=1e-4),
            torch.float64: dict(eig=1e-11, orth=1e-12, resid=1e-11)}
    rng = np.random.default_rng(2019)
    # (shape, dtype, seed): cases added after the first runs draw from their
    # own seeds (None: the shared stream), so the draws after them (the
    # clustered case, the timed input) stay those of earlier runs
    cases = [((n, n), dt, None) for dt in (torch.float32, torch.float64)
             for n in (16, 24, 96, 250, 288)]
    # batches at the masked path's width; 544 = l1 + l2 of a growth sweep's
    # per-sector Gram at M=256, the widest the main path solves
    cases += [((2, 288, 288), torch.float32, None),
              ((8, 288, 288), torch.float32, None),
              ((544, 544), torch.float32, 544)]
    # every (batch, n) that the SpinBosonDynamics constructor of phase 6(d)
    # solves: n below one block of 16, and n that the wrapper pads to 32, to
    # 64 (39, 48) and to 96 (75)
    cases += [((1, n, n), torch.float32, 6000 + n) for n in EVOLVE_PATH_GRAMS]
    main_err = None
    for shape, dt, seed in cases:
        a = _symmetric(rng if seed is None else np.random.default_rng(seed),
                       shape, dt)
        w, v = jacobi_eigh(a)
        w_p, v_p = jacobi_eigh_reference(a)
        torch.cuda.synchronize()
        tag = f"{tuple(shape)} {str(dt)[6:]}"
        grow = max(1.0, shape[-1] / 288) if dt == torch.float32 else 1.0
        tol = {k: t * grow for k, t in tols[dt].items()}
        errs, errs_p = _eigh_errors(a, w, v), _eigh_errors(a, w_p, v_p)
        err = float((w - w_p).abs().max())
        unscaled = all(e < t for found in (errs, errs_p)
                       for e, t in zip(found, tols[dt].values()))
        print(f"[kernel] {tag}: kernel eig/orth/resid "
              f"{' '.join(f'{e:.2e}' for e in errs)}; plain "
              f"{' '.join(f'{e:.2e}' for e in errs_p)}; |w - w_plain| {err:.2e}"
              + ("" if grow == 1.0 else
                 f"; within the unscaled n <= 288 tolerances: {unscaled}"),
              flush=True)
        _check_eigh(tag + " kernel", errs, tol)
        _check_eigh(tag + " plain", errs_p, tol)
        # both are within tol of the oracle, so within 2 tol of each other
        scale = float(torch.linalg.matrix_norm(a).min())
        check(err < 2 * tol["eig"] * scale,
              f"{tag}: kernel and plain eigenvalues differ by {err:.2e}")
        if tuple(shape) == (2, 288, 288):
            main_err = err
    # clustered spectrum over 12 decades with a low base sweep count: the
    # kernel must extend the sweeps and report a small residual
    lam_true = np.repeat(10.0 ** np.arange(-6, 6), 8)
    q, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    a = (q * lam_true) @ q.T
    a = torch.tensor((a + a.T) / 2, dtype=torch.float64, device="cuda")
    w, v, resid, nsweeps = jacobi_eigh(a, sweeps=2, return_resid=True,
                                       return_sweeps=True)
    lam = torch.tensor(np.sort(lam_true), dtype=torch.float64, device="cuda")
    rel = float(((w - lam).abs() / lam).max())
    absd = float((w - lam).abs().max())
    print(f"[kernel] clustered f64 sweeps=2: {int(nsweeps)} sweeps (cap "
          f"{2 + MAX_EXTRA_SWEEPS}), resid {float(resid):.2e} "
          f"eig rel {rel:.2e} abs {absd:.2e}", flush=True)
    check(float(resid) < 1e-7, f"clustered: resid {float(resid):.2e}")
    check(bool(torch.all((w - lam).abs() <= 1e-8 * lam + 1e-10)),
          "clustered: eigenvalues off")

    timed = {}
    cap = default_sweeps(torch.float32) + MAX_EXTRA_SWEEPS
    # the DMRG path's two widest shapes, and the evolution path's most
    # frequent one (78 of the 403 launches of phase 6(d))
    for shape in ((2, 288, 288), (1, 544, 544), (1, 48, 48)):
        # the first timed input is drawn after the clustered case, as in
        # earlier runs; the others from their own seeds
        a = _symmetric(rng if shape[-1] == 288
                       else np.random.default_rng(10 * shape[-1]),
                       shape, torch.float32)
        ms = cuda_times_in_turns({
            "kernel": lambda: jacobi_eigh(a),
            "torch.linalg.eigh": lambda: torch.linalg.eigh(a),
            "plain": lambda: jacobi_eigh_reference(a)},
            {"kernel": 10, "torch.linalg.eigh": 10, "plain": 3})
        sweeps = jacobi_eigh(a, return_sweeps=True)[2].tolist()
        sweeps_p = jacobi_eigh_reference(a, return_sweeps=True)[2].tolist()
        capped = sum(s >= cap for s in sweeps + sweeps_p)
        bound, bound_by = jacobi_bound_ms(shape[0], shape[-1], 4)
        print(f"[kernel] {shape} f32 median ms: kernel {ms['kernel']:.3f} "
              f"plain {ms['plain']:.3f} torch.linalg.eigh "
              f"{ms['torch.linalg.eigh']:.3f}; sweeps kernel {sweeps} plain "
              f"{sweeps_p} (cap {cap}), {capped} timed solves at the cap; "
              f"bound {bound:.6f} ms ({bound_by})", flush=True)
        check(capped == 0, f"{shape}: {capped} timed solves ran to the sweep cap")
        timed[shape] = dict(ms, bound_ms=bound, bound_by=bound_by)
    return dict(max_abs_err=main_err, timed=timed, tol_f32=tols[torch.float32])


class GramRecord:
    """Stands in for ``trunc_device.jacobi_eigh`` while a path runs: the
    shape of every Gram eigh, its residual and sweep count left on the device
    (no sync per launch), and with ``keep_grams`` every Gram with the
    eigenpairs the kernel gave for it."""

    def __init__(self, keep_grams=False):
        self.grams, self.kept, self.keep_grams = [], {}, keep_grams

    def __call__(self, g, *args, **kwargs):
        from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

        key = (g.shape[0] if g.ndim == 3 else 1, g.shape[-1])
        copy = g.clone() if self.keep_grams else None
        w, v, resid, nsweeps = jacobi_eigh(g, *args, return_resid=True,
                                           return_sweeps=True, **kwargs)
        self.grams.append(key + (resid.reshape(-1), nsweeps.reshape(-1)))
        if self.keep_grams:
            n = key[1]
            self.kept.setdefault(n, []).append(
                (copy.reshape(-1, n, n), w.reshape(-1, n), v.reshape(-1, n, n)))
        return w, v

    def report(self, tag, launches):
        """Read the record back (one sync), print it and fail on a launch
        that ran to the sweep cap; returns the (batch, n) histogram."""
        import torch

        from renormalizer_tpu_torch.ops.jacobi import (
            MAX_EXTRA_SWEEPS, default_sweeps)

        cap = default_sweeps(torch.float32) + MAX_EXTRA_SWEEPS
        sweeps = [t[3].tolist() for t in self.grams]
        resid_max = (float(torch.cat([t[2] for t in self.grams]).max())
                     if self.grams else 0.0)
        at_cap = sum(max(s) >= cap for s in sweeps)
        hist = collections.Counter((b, n) for b, n, _, _ in self.grams)
        sweep_hist = collections.Counter(x for s in sweeps for x in s)
        print(f"{tag} Gram eigh launches at the sweep cap ({cap}): {at_cap} of "
              f"{len(self.grams)}; sweeps per solve "
              f"{dict(sorted(sweep_hist.items()))}; largest resid "
              f"{resid_max:.2e}", flush=True)
        print(f"{tag} (batch, n) of the launches: {dict(sorted(hist.items()))}",
              flush=True)
        check(len(self.grams) == launches,
              f"{tag} {len(self.grams)} recorded Grams, {launches} launches")
        check(at_cap == 0, f"{tag} {at_cap} launches ran to the sweep cap")
        return hist

    def check_against_plain(self, tag, tol):
        """Every kept Gram, with the eigenpairs the kernel gave the path,
        against the plain version on the same Gram (one batch per n): both
        inside the phase-3 tolerances (relative to ||A||_F), and their
        eigenvalues within twice the eigenvalue tolerance of each other."""
        import torch

        from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh_reference

        worst, count = 0.0, 0
        for n, kept in sorted(self.kept.items()):
            g, w, v = (torch.cat(parts) for parts in zip(*kept))
            w_p, v_p = jacobi_eigh_reference(g)
            _check_eigh(f"{tag} n={n} kernel", _eigh_errors(g, w, v), tol)
            _check_eigh(f"{tag} n={n} plain", _eigh_errors(g, w_p, v_p), tol)
            scale = torch.linalg.matrix_norm(g)[:, None]
            err = float(((w - w_p).abs() / scale).max())
            check(err < 2 * tol["eig"], f"{tag} n={n}: kernel and plain "
                  f"eigenvalues differ by {err:.2e}·|A|")
            worst, count = max(worst, err), count + len(g)
        print(f"{tag} the path's own {count} Grams: kernel (as the path got "
              f"it) and plain inside the phase-3 tolerances; largest "
              f"|w - w_plain| {worst:.2e}·|A|", flush=True)


def phase_main_path(card):
    import numpy as np
    import torch

    from renormalizer_tpu_torch import Mpo, Mps, optimize_mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

    model = holstein_chain(6)
    check(model.nsite == 18, f"bench model has {model.nsite} sites")
    mpo = Mpo(model)
    mps = Mps.random(model, 1, M, percent=1.0)
    mps.optimize_config.procedure = PROCEDURE
    mps.optimize_config.method = "2site"

    sweep_times = []
    single_sweep = gs.single_sweep

    def timed_sweep(*args, **kwargs):
        backend.sync()
        t0 = time.perf_counter()
        out = single_sweep(*args, **kwargs)
        backend.sync()
        sweep_times.append(time.perf_counter() - t0)
        return out

    grams = GramRecord()
    gs.single_sweep = timed_sweep
    trunc_device.jacobi_eigh = grams
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        t0 = time.perf_counter()
        energies, opt = optimize_mps(mps, mpo)
        backend.sync()
        total = time.perf_counter() - t0
        launches = jacobi_eigh.launches
        elsewhere = trunc_device.LINALG_EIGH_GRAMS
    finally:
        gs.single_sweep = single_sweep
        trunc_device.jacobi_eigh = jacobi_eigh
    e_min = float(min(energies))
    print(f"[main] energies per sweep: {[float(e) for e in energies]}", flush=True)
    print(f"[main] sweep seconds ({card}): "
          f"{[round(t, 4) for t in sweep_times]}; total {total:.2f} s", flush=True)
    print(f"[main] lowest energy {e_min:.10f} (reference {E_REF}, "
          f"diff {e_min - E_REF:+.3e}); bond dims {opt.bond_dims}", flush=True)
    print(f"[main] jacobi launches {launches}; Gram eigh elsewhere {elsewhere}",
          flush=True)
    grams.report("[main]", launches)
    check(abs(e_min - E_REF) < E_TOL,
          f"energy {e_min} not within {E_TOL} of {E_REF}")
    check(launches > 0, "the main path never launched the Jacobi kernel")
    check(elsewhere == 0, f"{elsewhere} Gram eigh went around the kernel")
    check(max(opt.bond_dims) <= M and len(opt) == 18, "bad result shape")
    check(all(bool(torch.isfinite(t).all()) for t in opt), "non-finite MPS")
    e_exp = opt.expectation(mpo)
    print(f"[main] <psi|H|psi> of the result {e_exp:.10f}", flush=True)
    check(abs(e_exp - e_min) < 1e-5, f"expectation {e_exp} vs energy {e_min}")
    return launches, total


def dense_operator(model, terms):
    """Dense matrix of a sum of ``Op`` terms, kron-assembled from
    ``basis.op_mat`` (independent of the port's MPO compiler)."""
    import numpy as np

    dim = int(np.prod(model.pbond_list))
    dense = np.zeros((dim, dim), dtype=complex)
    for op in terms:
        elem_ops, factor = op.split_elementary(model.dof_to_siteidx)
        site_mats = {
            model.dof_to_siteidx[e.dofs[0]]: model.dof_to_basis[e.dofs[0]].op_mat(e)
            for e in elem_ops
        }
        full = np.eye(1)
        for i, b in enumerate(model.basis):
            full = np.kron(full, site_mats.get(i, np.eye(b.nbas)))
        dense = dense + factor * full
    return dense


def _all_finite(mps):
    import torch

    return all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all())
               for t in mps)


def phase_oracle(nsteps=10, dt=0.2):
    """Phase 5: TDVP-PS against scipy.linalg.expm on two small models."""
    import numpy as np
    import scipy.linalg

    from renormalizer_tpu_torch import (
        EvolveConfig, EvolveMethod, HolsteinModel, Mol, Mpo, Mps, Op, Phonon,
        Quantity)
    from renormalizer_tpu_torch.sbm import SpinBosonDynamics, param2mollist

    def propagate(h, psi0, observables):
        out = []
        for i in range(1, nsteps + 1):
            psi = scipy.linalg.expm(-1j * dt * i * h) @ psi0
            out.append([np.real(psi.conj() @ o @ psi) for o in observables])
        return np.array(out)

    # the 3-molecule, 2-level Holstein model: a^dagger_0 |gs>, expanded with
    # the Hamiltonian as hint, H offset by the initial energy
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    mps = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
    mps = mps.expand_bond_dimension(hint_mpo=Mpo(model))
    e0 = mps.expectation(Mpo(model))
    mpo = Mpo(model, offset=Quantity(e0))
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    h = dense_operator(model, model.ham_terms)
    h = h - e0 * np.eye(len(h))
    occ = [dense_operator(model, [Op(r"a^\dagger a", dof)]) for dof in model.e_dofs]
    oracle = propagate(h, mps.todense().astype(complex), occ)
    deviations = []
    for i in range(nsteps):
        mps = mps.evolve(mpo, dt)
        deviations.append(float(np.abs(mps.e_occupations - oracle[i]).mean()))
        check(abs(mps.mp_norm - 1) < 1e-5, f"[oracle] holstein norm {mps.mp_norm}")
        check(_all_finite(mps), "[oracle] holstein: non-finite MPS")
    mcd = float(np.mean(deviations))
    print(f"[oracle] holstein 3x2: e_occupations mean cumulative deviation "
          f"{mcd:.3e} over {nsteps} steps of {dt} (bond dims {mps.bond_dims})",
          flush=True)
    check(mcd < 1e-4, f"[oracle] holstein deviation {mcd}")

    # a 3-mode spin-boson model through the job class
    model = param2mollist(0.05, Quantity(1), Quantity(20), 1, 3)
    job = SpinBosonDynamics(model, evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
    job.evolve(evolve_dt=dt, nsteps=nsteps)
    h = dense_operator(model, model.ham_terms)
    psi0 = np.zeros(len(h), dtype=complex)
    psi0[0] = 1.0  # spin up, bath vacuum
    oracle = propagate(h, psi0, [dense_operator(model, [Op("sigma_z", "spin")])])[:, 0]
    sigma_z = np.array(job.sigma_z)
    mcd = float(np.abs(sigma_z[1:] - oracle).mean())
    norm = job.latest_mps.mp_norm
    print(f"[oracle] spin-boson 3 modes: sigma_z mean cumulative deviation "
          f"{mcd:.3e}; sigma_z(t) {[round(float(x), 6) for x in sigma_z]}; "
          f"norm {norm:.7f}", flush=True)
    check(sigma_z[0] == 1.0, f"[oracle] sigma_z(0) = {sigma_z[0]}")
    check(mcd < 1e-4, f"[oracle] spin-boson deviation {mcd}")
    check(abs(norm - 1) < 1e-5, f"[oracle] spin-boson norm {norm}")
    check(_all_finite(job.latest_mps) and np.isfinite(sigma_z).all(),
          "[oracle] spin-boson: non-finite result")


def holstein_chain(levels):
    """The bench.py chain: 6 molecules x 2 modes of ``levels`` levels."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity

    ph_list = [Phonon.simple_phonon(Quantity(w, "cm-1"), Quantity(d), levels)
               for w, d in zip([106.51, 1555.55], [30.1370, 8.7729])]
    mol = Mol(Quantity(2.67, "eV"), ph_list)
    return HolsteinModel([mol] * 6, Quantity(-0.1, "eV"))


class StepChecks:
    """The per-step checks of phase 6: norm, energy against the first
    reading, finiteness."""

    def __init__(self, tag, mpo, state_of=lambda state: state):
        self.tag, self.mpo, self.state_of = tag, mpo, state_of
        self.energies, self.norms = [], []

    def __call__(self, state):
        mps = self.state_of(state)
        energy, norm = mps.expectation(self.mpo), mps.mp_norm
        self.energies.append(float(complex(energy).real))
        self.norms.append(norm)
        check(abs(complex(energy).imag) <= ENERGY_RTOL * max(1.0, abs(energy)),
              f"{self.tag}: <H> = {energy} is not real")
        check(_all_finite(mps), f"{self.tag}: non-finite MPS")
        check(abs(norm - 1) < NORM_TOL, f"{self.tag}: norm {norm}")
        e0 = self.energies[0]
        check(abs(self.energies[-1] - e0) <= ENERGY_RTOL * max(1.0, abs(e0)),
              f"{self.tag}: <H> moved from {e0} to {self.energies[-1]}")

    def report(self):
        e0 = self.energies[0]
        drift = max(abs(e - e0) for e in self.energies)
        print(f"{self.tag} <H> {e0:.8f}, largest drift {drift:.3e} "
              f"({drift / max(1.0, abs(e0)):.2e} of max(1, |E|), allowed "
              f"{ENERGY_RTOL:.0e}); norms {[round(x, 7) for x in self.norms]}",
              flush=True)


def run_steps(tag, card, step, state, checks, nsteps=5):
    """One first step (bond growth, plan caching) and ``nsteps - 1`` timed
    ones, each between two device syncs.  ``step(state)`` returns the next
    state; ``checks(state)`` runs outside the timed region."""
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import mps as mps_module

    visits0 = dict(mps_module.TDVP_PS_VISITS)
    seconds = []
    for _ in range(nsteps):
        backend.sync()
        t0 = time.perf_counter()
        state = step(state)
        backend.sync()
        seconds.append(time.perf_counter() - t0)
        checks(state)
    visits = {k: v - visits0[k] for k, v in mps_module.TDVP_PS_VISITS.items()}
    print(f"{tag} ({card}) first step {seconds[0]:.4f} s; timed steps "
          f"{[round(t, 4) for t in seconds[1:]]} s; site visits {visits}",
          flush=True)
    checks.report()
    return state, seconds


def phase_evolution(card, profile, gram_tol, m_small=48, m_large=256, nph=31):
    """Phase 6 (and 7 with ``profile``): TDVP-PS at full width.  ``gram_tol``
    are phase 3's f32 tolerances, for the Grams that (d) solves."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch import (
        CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod, Mpo, Mps,
        Quantity)
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.sbm import SpinBosonDynamics, param2mollist

    dt = 0.2
    tdvp = EvolveConfig(EvolveMethod.tdvp_ps, adaptive=False)
    sbm_model = param2mollist(0.05, Quantity(1), Quantity(20), 1, nph)
    timed = {}
    for tag, model, qntot, m in (
            ("[evolve a] spin-boson %d sites M=%d" % (nph + 1, m_small),
             sbm_model, 0, m_small),
            ("[evolve b] holstein 6x(1+2) 4 levels qntot=1 M=%d" % m_small,
             holstein_chain(4), 1, m_small),
            ("[evolve c] holstein 6x(1+2) 6 levels qntot=1 M=%d" % m_large,
             holstein_chain(6), 1, m_large)):
        mpo = Mpo(model)
        mps = Mps.random(model, qntot, m, percent=1.0)
        mps.evolve_config = tdvp
        checks = StepChecks(tag, mpo)
        checks(mps)
        mps, seconds = run_steps(tag, card, lambda s: s.evolve(mpo, dt), mps, checks)
        print(f"{tag} bond dims {mps.bond_dims}; complex {mps.is_complex}",
              flush=True)
        check(mps.is_complex and max(mps.bond_dims) <= m, f"{tag}: bad result")
        timed[tag[8]] = seconds[1:]
        if profile:
            phase_profile_step(card, tag[:10], lambda: mps.evolve(mpo, dt))

    # (d) the job entry point: ground_state -> expand_bond_dimension ->
    # process_mps on a real state, then steps whose measurements compress a
    # complex state
    tag = "[evolve d] SpinBosonDynamics %d sites M=%d" % (nph + 1, m_small)
    grams = GramRecord(keep_grams=True)
    trunc_device.jacobi_eigh = grams
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        backend.sync()
        t0 = time.perf_counter()
        job = SpinBosonDynamics(
            sbm_model, compress_config=CompressConfig(CompressCriteria.fixed,
                                                      max_bonddim=m_small),
            evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
        backend.sync()
        construct_s = time.perf_counter() - t0
        launches, elsewhere = jacobi_eigh.launches, trunc_device.LINALG_EIGH_GRAMS
    finally:
        trunc_device.jacobi_eigh = jacobi_eigh
    print(f"{tag} constructor {construct_s:.3f} s: jacobi launches {launches}, "
          f"Gram eigh elsewhere {elsewhere}; start bond dims "
          f"{job.latest_mps.bond_dims}; real {not job.latest_mps.is_complex}",
          flush=True)
    check(launches > 0, f"{tag}: the constructor never launched the Jacobi kernel")
    hist = grams.report(tag[:10], launches)
    if (nph, m_small) == (31, 48):
        unheld = sorted(set(hist) - {(1, n) for n in EVOLVE_PATH_GRAMS})
        check(not unheld, f"{tag}: Gram shapes {unheld} are not among the "
              f"phase-3 cases (EVOLVE_PATH_GRAMS)")
    grams.check_against_plain(tag[:10], gram_tol)
    check(elsewhere == 0, f"{tag}: {elsewhere} real Gram eigh went around the kernel")
    check(not job.latest_mps.is_complex, f"{tag}: the start state is complex")
    check(max(job.latest_mps.bond_dims) == m_small, f"{tag}: bonds did not expand")
    checks = StepChecks(tag, job.h_mpo, state_of=lambda j: j.latest_mps)
    checks(job)
    _, seconds = run_steps(
        tag, card, lambda j: j.evolve(evolve_dt=dt, nsteps=1), job, checks)
    complex_grams = trunc_device.LINALG_EIGH_GRAMS
    sigma_z = np.array(job.sigma_z)
    print(f"{tag} jacobi launches {jacobi_eigh.launches}, complex Gram eigh "
          f"through torch.linalg.eigh {complex_grams}; sigma_z(t) "
          f"{[round(float(x), 6) for x in sigma_z]}; bond dims "
          f"{job.latest_mps.bond_dims}", flush=True)
    check(sigma_z[0] == 1.0, f"{tag}: sigma_z(0) = {sigma_z[0]}")
    check(np.isfinite(sigma_z).all() and np.abs(sigma_z).max() <= 1 + 1e-5,
          f"{tag}: sigma_z out of range: {sigma_z}")
    check(complex_grams > 0, f"{tag}: no complex Gram was counted")
    timed["d"] = seconds[1:]
    if profile:
        phase_profile_step(card, tag[:10],
                           lambda: job.evolve(evolve_dt=dt, nsteps=1))
    return launches, timed


def phase_profile_step(card, tag, step):
    """Phase 7: one more TDVP-PS step (``step()``) under torch.profiler."""
    import torch

    from renormalizer_tpu_torch.backend import backend

    backend.sync()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        backend.sync()
        wall_s = time.perf_counter() - t0
    print(f"[profile] one more step of {tag}, {wall_s:.3f} s under the "
          f"profiler", flush=True)
    print_device_breakdown(prof, wall_s, card, top=6)
    # host synchronisations: the runtime calls that wait for the device, and
    # the device-to-host copies (a .item() is one copy and one wait)
    waits = collections.Counter(
        e.name for e in prof.events()
        if "Synchronize" in e.name or "Memcpy DtoH" in e.name)
    print(f"[profile] ({card}) host synchronisations in the step: "
          f"{dict(sorted(waits.items()))}; "
          f"{sum(v for k, v in waits.items() if 'Synchronize' in k)} waits, the "
          f"closing backend.sync() included", flush=True)


def print_device_breakdown(prof, wall_s, card, top=10):
    """Device time per kernel of a torch.profiler run, and the card's busy
    share of ``wall_s``: the union of the device intervals over the wall."""
    from torch.autograd import DeviceType

    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        us, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + end - start, calls + 1)
    check(spans, "the profiler recorded no device activity")
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    total = sum(us for us, _ in per_name.values())
    print(f"[profile] ({card}) device time {total / 1e6:.3f} s in "
          f"{len(spans)} device events; busy {busy / 1e6:.3f} s of "
          f"{wall_s:.3f} s wall ({100 * busy / 1e6 / wall_s:.1f} %)", flush=True)
    jacobi = [v for name, v in per_name.items() if "jacobi_kernel" in name]
    jac_us, jac_calls = sum(us for us, _ in jacobi), sum(c for _, c in jacobi)
    print(f"[profile] ({card}) Jacobi kernel: {jac_us / 1e6:.3f} s in "
          f"{jac_calls} launches, {100 * jac_us / total:.1f} % of device time",
          flush=True)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for kname, (us, calls) in ranked[:top]:
        print(f"[profile] {us / 1e6:9.3f} s {100 * us / total:5.1f} % "
              f"{calls:6d} calls {us / calls / 1e3:9.3f} ms/call  {kname[:90]}",
              flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device visible")
    profile = "--profile" in sys.argv[1:]
    name, card = phase_environment()
    phase_build()
    record = phase_kernels()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile else contextlib.nullcontext()
    with prof:
        launches, wall_s = phase_main_path(card)
    if profile:
        print_device_breakdown(prof, wall_s, card)
    phase_oracle()
    evolve_launches, steps = phase_evolution(card, profile, record["tol_f32"])
    steady = record["timed"][(2, 288, 288)]
    # the numbers of this run once more, so that the end of the output
    # carries them when its beginning is cut
    print("[summary] " + json.dumps({
        "card": card, "dmrg_seconds": round(wall_s, 4),
        "tdvp_ps_timed_step_seconds": {
            k: [round(t, 4) for t in v] for k, v in steps.items()},
        "jacobi_ms": {str(k): round(v["kernel"], 3)
                      for k, v in record["timed"].items()},
        "eigh_ms": {str(k): round(v["torch.linalg.eigh"], 3)
                    for k, v in record["timed"].items()}}), flush=True)
    print(f"[kernels] jacobi_eigh launches: DMRG path {launches}, "
          f"SpinBosonDynamics constructor {evolve_launches}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "jacobi_eigh", "route": "cuda", "source": JACOBI_SOURCE,
        "replaces": JACOBI_REPLACES, "launches": launches,
        "max_abs_err": record["max_abs_err"], "ms": steady["kernel"],
        "plain_ms": steady["plain"], "bound_ms": steady["bound_ms"],
        "bound_by": steady["bound_by"],
        "library_ms": steady["torch.linalg.eigh"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
