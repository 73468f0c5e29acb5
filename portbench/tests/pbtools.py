"""Helpers of the benchmark's CPU tests: a copy of the benchmark with its
configurations cut to a size the CPU holds, and a run of one of its cells
in a child process with the harness's look for a card skipped."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# what a child process runs: the harness as run.py runs it, without the card
_CHILD = """
import json, sys
sys.path.insert(0, {bench!r})
import run
{patch}
args = run.parse({argv!r})
result = run.run_cell(args, require_card=False)
print("RESULT " + json.dumps(result))
"""


def tiny_copy(dest, n_mol=2, levels=3, m_chain=8, m_tree=4):
    """``dest``/portbench and ``dest``/BENCHMARK.json with every
    configuration cut to ``n_mol`` molecules of ``levels`` levels."""
    dest = Path(dest)
    shutil.copytree(BENCH_DIR, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = dest / entry["file"]
        config = json.loads(path.read_text())
        config["n_mol"] = n_mol
        for mode in config["modes"]:
            mode["levels"] = levels
        config["m"] = m_chain if config["ansatz"] == "mps" else m_tree
        path.write_text(json.dumps(config))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def run_cell(copy, cell, seed=2147483905, seconds=1.0, trace=0, patch="",
             extra=(), timeout=600):
    """Run ``cell`` of the benchmark in ``copy`` on the CPU in fp64; returns
    the result line's object (None if the run printed none) and the child's
    standard error."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), *extra]
    code = _CHILD.format(bench=str(Path(copy) / "portbench"), patch=patch, argv=argv)
    env = dict(os.environ, RENO_PLATFORM="cpu", RENO_DTYPE="fp64",
               PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    result = json.loads(lines[-1][len("RESULT "):]) if lines else None
    return result, proc.stderr
