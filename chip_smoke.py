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
     n = 288; past n = 288 the f32 tolerances grow as n / 288); then, at the
     main path's shapes (2, 288, 288) and (1, 544, 544) f32, the kernel, the
     plain version and torch.linalg.eigh timed in turns, the sweeps each
     timed solve took, and the kernel's bound;
  4. main path: 2-site DMRG of the 6-molecule Holstein chain (18 sites) at
     M=256 in fp32, through Mps.random / Mpo / optimize_mps; the energy must be
     within 1e-6 of 0.11503887 and the truncation's Gram eigh must have gone
     through the kernel.  Each Gram eigh's residual and sweep count are kept
     on the device and read once at the end: the script prints how many
     launches ran to the sweep cap and the (batch, n) histogram.
The line before the last holds the kernel record as JSON; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.

    python3 chip_smoke.py --profile

runs the main path under torch.profiler and adds its device time per
kernel and the card's busy share of that run's wall time.
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
    cases = [((n, n), dt) for dt in (torch.float32, torch.float64)
             for n in (16, 24, 96, 250, 288)]
    # batches at the masked path's width; 544 = l1 + l2 of a growth sweep's
    # per-sector Gram at M=256, the widest the main path solves
    cases += [((2, 288, 288), torch.float32), ((8, 288, 288), torch.float32),
              ((544, 544), torch.float32)]
    main_err = None
    for shape, dt in cases:
        # the n = 544 case draws from its own seed, so the draws after it
        # (the clustered case, the timed input) stay those of earlier runs
        a = _symmetric(np.random.default_rng(544) if shape[-1] == 544 else rng,
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
    for shape in ((2, 288, 288), (1, 544, 544)):
        # the first timed input is drawn after the clustered case, as in
        # earlier runs; the second from its own seed
        a = _symmetric(rng if shape[-1] == 288 else np.random.default_rng(5440),
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
    return dict(max_abs_err=main_err, timed=timed)


def bench_model():
    """The bench.py model: 6 molecules x 2 modes of 6 levels (18 sites)."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity

    ph_list = [Phonon.simple_phonon(Quantity(w, "cm-1"), Quantity(d), 6)
               for w, d in zip([106.51, 1555.55], [30.1370, 8.7729])]
    mol = Mol(Quantity(2.67, "eV"), ph_list)
    return HolsteinModel([mol] * 6, Quantity(-0.1, "eV"))


def phase_main_path(card):
    import numpy as np
    import torch

    from renormalizer_tpu_torch import Mpo, Mps, optimize_mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.ops.jacobi import (
        MAX_EXTRA_SWEEPS, default_sweeps, jacobi_eigh)

    model = bench_model()
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

    # every Gram eigh of the truncation: its shape, and its residual and
    # sweep count left on the device (no sync per launch)
    grams = []

    def recorded_eigh(g, *args, **kwargs):
        w, v, resid, nsweeps = jacobi_eigh(g, *args, return_resid=True,
                                           return_sweeps=True, **kwargs)
        grams.append((g.shape[0] if g.ndim == 3 else 1, g.shape[-1],
                      resid.reshape(-1), nsweeps.reshape(-1)))
        return w, v

    gs.single_sweep = timed_sweep
    trunc_device.jacobi_eigh = recorded_eigh
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
    cap = default_sweeps(torch.float32) + MAX_EXTRA_SWEEPS
    sweeps = [t[3].tolist() for t in grams]
    resid_max = float(torch.cat([t[2] for t in grams]).max()) if grams else 0.0
    at_cap = sum(max(s) >= cap for s in sweeps)
    hist = collections.Counter((b, n) for b, n, _, _ in grams)
    sweep_hist = collections.Counter(x for s in sweeps for x in s)
    print(f"[main] Gram eigh launches at the sweep cap ({cap}): {at_cap} of "
          f"{len(grams)}; sweeps per solve {dict(sorted(sweep_hist.items()))}; "
          f"largest resid {resid_max:.2e}", flush=True)
    print(f"[main] (batch, n) of the launches: {dict(sorted(hist.items()))}",
          flush=True)
    check(len(grams) == launches, f"{len(grams)} recorded Grams, {launches} launches")
    check(at_cap == 0, f"{at_cap} main-path launches ran to the sweep cap")
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
    steady = record["timed"][(2, 288, 288)]
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
