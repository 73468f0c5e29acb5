#!/usr/bin/env python3
"""The cost of the port's tracer (``renormalizer_tpu_torch.utils.profiling``)
on one cell of the benchmark, without a profiler: the cell's units timed
with tracing off, with spans only (``COUNT_WAITS`` false) and with spans
and the host-wait hook, the three in turns on the same inputs.

    python3 tracing_cost.py --workload holstein-mps-dmrg [--rounds 4] [--seed 7]

from the root of a checkout, on the card.  Prints one JSON line per unit
(``mode``, seconds, spans and host waits it recorded) and a last line with
each mode's median and its ratio to tracing off.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parent
BENCH_DIR = ROOT / "portbench"
MODES = ("off", "spans", "spans+waits")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    cache = ROOT / "renormalizer_tpu_torch" / "_build"
    for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch

    from harness import spec as spec_mod
    from harness import workloads
    from renormalizer_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tracer's cost is measured on the card")
    torch.set_num_threads(1)
    spec = spec_mod.Spec(args.workload)
    traffic = spec.traffic
    runner = workloads.KINDS[traffic["kind"]](spec.config, traffic, args.seed, 1)
    runner.setup()
    torch.cuda.synchronize()
    print(f"# {torch.cuda.get_device_name(0)}; {args.workload}", flush=True)
    seconds = {m: [] for m in MODES}
    for r in range(args.rounds):
        # rotate the order so that no mode always runs first
        for mode in MODES[r % 3:] + MODES[:r % 3]:
            profiling.TRACING = mode != "off"
            profiling.COUNT_WAITS = mode == "spans+waits"
            profiling.clear()
            before = profiling.snapshot()
            runner.before(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.unit(r)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            profiling.TRACING = False
            runner.after(r)
            waits = sum(n for k, n in profiling.delta(before).items()
                        if k.startswith("waits."))
            seconds[mode].append(took)
            print(json.dumps({"round": r, "mode": mode, "seconds": took,
                              "spans": len(profiling.SPANS), "waits": waits}), flush=True)
    profiling.COUNT_WAITS = True
    profiling.clear()
    off = statistics.median(seconds["off"])
    print(json.dumps({"workload": args.workload, "median_s": {
        m: statistics.median(v) for m, v in seconds.items()},
        "ratio_to_off": {m: statistics.median(v) / off for m, v in seconds.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
