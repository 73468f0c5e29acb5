"""Nothing that run.py runs loads JAX or the JAX package, and the reference
loads nothing of the measured package either; without a card run.py fails
and prints no result."""

import json
import os
import subprocess
import sys

import pbtools

FORBIDDEN = {"jax", "jaxlib", "flax", "renormalizer_tpu"}

_LOADED = """
import json, sys
print("MODULES " + json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _child(code, cwd):
    env = dict(os.environ, RENO_PLATFORM="cpu", RENO_DTYPE="fp64",
               PYTHONPATH=str(pbtools.ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("MODULES ")]
    assert lines, proc.stderr[-3000:]
    return set(json.loads(lines[-1][len("MODULES "):])), proc


def test_a_whole_run_loads_no_jax(tmp_path):
    copy = pbtools.tiny_copy(tmp_path)
    code = (pbtools._CHILD.format(
        bench=str(copy / "portbench"), patch="",
        argv=["--workload", "holstein-mps-tdvp", "--seed", "7", "--seconds", "0.5",
              "--trace", "1"]) + _LOADED)
    loaded, proc = _child(code, copy)
    assert "RESULT " in proc.stdout, proc.stderr[-3000:]
    assert "renormalizer_tpu_torch" in loaded  # the port ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(pbtools.BENCH_DIR)!r})
import torch
from reference import holstein, judge, network, tdvp
config = {{"model": "holstein_chain", "n_mol": 2, "elocalex_ev": 2.67, "j_ev": -0.1,
    "modes": [{{"omega_cm": 106.51, "displacement_au": 30.137, "levels": 3}}],
    "m": 4, "qntot": 1}}
sites, terms = holstein.chain(config)
ops = tdvp.chain_operator(sites, terms, torch.complex128, "cpu")
g = torch.Generator().manual_seed(0)
dims = [1] + [min(4, 3 ** min(i + 1, len(sites) - i - 1)) for i in range(len(sites) - 1)] + [1]
state = [torch.randn(dims[i], d, dims[i + 1], generator=g, dtype=torch.complex128)
         for i, (_, d) in enumerate(sites)]
judge.tdvp_step(config, [lab for lab, _ in sites], state, state, 0.2, False)
""" + _LOADED
    loaded, _ = _child(code, pbtools.ROOT)
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"renormalizer_tpu_torch", "harness"})


def test_no_card_no_result():
    env = dict(os.environ, RENO_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(pbtools.BENCH_DIR / "run.py"), "--workload",
         "holstein-mps-dmrg", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=pbtools.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    copy = pbtools.tiny_copy(tmp_path)
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "holstein-mps-dmrg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=copy, env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
