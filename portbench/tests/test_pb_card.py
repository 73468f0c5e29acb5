"""On the card: each cell runs correct at its own load, and its control
(the program with TF32 products) comes out not correct on three seeds.  The
window is short, long enough for the units the check picks (a ground-state
cell runs whole rounds of its pool; four TDVP steps); the load is the
cell's own.  Skips without a card; run with

    python -m pytest -m cuda -rP portbench/tests/test_pb_card.py
"""

import json
import subprocess
import sys

import pytest

import pbtools

# seconds of a short window that still holds the units the check picks
SECONDS = {"holstein-mps-dmrg": 1, "holstein-ttns-dmrg": 1, "holstein-mps-tdvp": 25}
CELLS = tuple(SECONDS)


def _run(cell, seed, *extra):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    seconds = SECONDS[cell]
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", "0", *extra],
        cwd=pbtools.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(cell, extra, result["checks"])
    return result


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_the_card(cell):
    result = _run(cell, 2147483911)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (2147483912, 2147483913, 2147483914))
@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_on_the_card(cell, seed):
    result = _run(cell, seed, "--control", "tf32")
    assert not result["correct"], result["checks"]
