#!/usr/bin/env python3
"""The benchmark of renormalizer_tpu_torch on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run sets up the cell (imports, the kernel
library, the model and its operator, a warm-up of the cell's own shapes),
runs whole units of work until their summed time reaches ``--seconds``
(with ``--trace 1``: the traffic's ``trace_units`` units under
``torch.profiler``), checks the outputs of the units the seed picks against
the plain reference in ``portbench/reference/``, and prints one JSON line
last.  With ``--trace 0`` the line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy seconds and a
breakdown.  ``--control tf32`` runs the program with TF32 matrix products
(the precision below the configuration's float32), for the check's control.

A run without a CUDA device, or with fewer devices than the cell asks for,
exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with one host thread: the host paces much of each unit, and
# BLAS or OpenMP threads that compete for the machine's shared cores spread
# the runs (set before numpy or torch is loaded)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "renormalizer_tpu")
# every build and kernel cache of the program stays inside the checkout
CACHE = ROOT / "renormalizer_tpu_torch" / "_build"


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None)
    return p.parse_args(argv)


def card_report(chips):
    """Fail unless CUDA shows ``chips`` devices; the card's name and count."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} devices, "
                         f"{torch.cuda.device_count()} are visible")
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    print(f"[portbench] device {name}; {torch.cuda.device_count()} visible, "
          f"{chips} used; power limit {limit}", flush=True)
    return name


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def compare(numbers, limits):
    """Every number's worst reading over the checked units against its
    limit; a missing or non-finite reading fails."""
    if not numbers:
        raise RuntimeError("no unit was checked")
    checks, failed = {}, 0
    for name, limit in limits.items():
        values = [n[name] for n in numbers if name in n]
        worst = max(values) if values else float("nan")
        checks[name] = {"value": worst, "limit": limit}
    for n in numbers:
        if any(not (n.get(k, math.nan) <= lim) for k, lim in limits.items()):
            failed += 1
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, failed, checks


def run_cell(args, require_card=True):
    """Run one cell; returns the result line's object."""
    for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import spec as spec_mod
    from harness import window, workloads
    from harness.probe import Probe, Trace

    spec = spec_mod.Spec(args.workload)
    chips = int(spec.cell["chips"])
    import torch

    device_name = card_report(chips) if require_card else "cpu"
    torch.set_num_threads(1)
    import renormalizer_tpu_torch  # noqa: F401  (the program under test)

    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    traffic = spec.traffic
    trace_units = int(traffic["trace_units"]) if args.trace else None
    planned = trace_units if args.trace else int(traffic["check"]["within_first"])
    runner = workloads.KINDS[traffic["kind"]](spec.config, traffic, args.seed, planned)
    runner.setup()
    on_card = torch.cuda.is_available() and require_card
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s")

    probe = Probe()
    prof = None
    if args.trace:
        readers = {m["name"]: spec.metric_module(m["name"]) for m in spec.per_layer()}
        for reader in readers.values():
            if hasattr(reader, "install"):
                reader.install(probe)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    traced = []

    def before(i):
        runner.before(i)
        if prof is not None and not traced:
            # the trace starts after the first unit's preparation (a ground
            # state's start draw), which lies outside the window
            prof.__enter__()
            traced.append(i)

    try:
        times = window.run(runner.unit, args.seconds, sync, max_units=trace_units,
                           whole=runner.whole, before=before, after=runner.after)
    finally:
        if traced:
            prof.__exit__(None, None, None)
        probe.restore()
    window_s = sum(times)
    log(f"{len(times)} units in {window_s:.3f} s: "
        f"{' '.join(f'{t:.3f}' for t in times)}")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: {found}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics, device = {}, {"platform": "gpu", "kind": device_name, "count": chips,
                           "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        probe.units, probe.window_s = len(times), window_s
        probe.harness_syncs = 2 * len(times)
        probe.trace = Trace(prof)
        prof = None
        for m in spec.per_layer():
            value = readers[m["name"]].read(probe)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = probe.trace.busy_s()
        device["window_s"] = window_s
        breakdown = {"device_ops": probe.trace.device_ops(),
                     "idle_gaps": probe.trace.idle_gaps()}
        probe.trace = None
    else:
        values = {"setup_s": setup_s, traffic["unit_metric"]: window_s / len(times)}
        for m in spec.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # the check: after the window, with the program's state freed
    runner.release()
    missing = runner.picked - set(runner.kept)
    if missing:
        raise RuntimeError(f"units {sorted(missing)} picked for the check did not run")
    t0 = time.perf_counter()
    numbers = runner.judge()
    ok, failed, checks = compare(numbers, spec.limits)
    log(f"reference check of units {sorted(runner.kept)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, c in checks.items():
        log(f"check {name} {c['value']:.6e} limit {c['limit']:.6e}")
    result = {"correct": ok, "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    args = parse(argv)
    try:
        result = run_cell(args)
    except SystemExit as exc:
        log(f"no result: {exc}")
        return 1
    except Exception as exc:  # a boundary: report and fail without a result
        import traceback

        traceback.print_exc()
        log(f"no result: {type(exc).__name__}: {exc}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
