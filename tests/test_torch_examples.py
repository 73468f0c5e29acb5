"""The examples runner of the port (``renormalizer_tpu_torch.run_examples``)
on the CPU in fp64.

Every ``examples/*.py``, rewritten, parses and imports nothing of the JAX
package; ``holstein_gs.py`` runs in this process and prints the last sweep
energy of the JAX package's own run of it (CPU fp64) within 1e-10; the
subprocess runner applies ``examples/run.sh``'s rule (exit 0, or still
running at the limit) and brings back the numbers an example leaves."""

import ast
import os
import sys

import pytest
import torch

from renormalizer_tpu_torch import run_examples

torch.set_num_threads(2)

# the last sweep energy that the JAX package's examples/holstein_gs.py
# printed on the CPU in fp64
HOLSTEIN_GS_E = 0.0952461758565709

EXAMPLE_NAMES = [os.path.basename(p) for p in run_examples.example_paths()]


def test_every_example_is_found():
    assert len(EXAMPLE_NAMES) == 9 and "holstein_gs.py" in EXAMPLE_NAMES
    assert run_examples.example_paths(["fmo"]) == run_examples.example_paths(["fmo.py"])
    with pytest.raises(SystemExit, match="no such example: nope.py"):
        run_examples.example_paths(["nope"])


def test_rewrite_leaves_port_names_alone():
    src = ("import renormalizer_tpu\nfrom renormalizer_tpu.mps import Mps\n"
           "import renormalizer_tpu_torch.mps\nx = 'renormalizer_tpu_tests'\n")
    assert run_examples.rewrite(src) == (
        "import renormalizer_tpu_torch\nfrom renormalizer_tpu_torch.mps import Mps\n"
        "import renormalizer_tpu_torch.mps\nx = 'renormalizer_tpu_tests'\n")


@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_rewritten_example_imports_only_the_port(name):
    with open(os.path.join(run_examples.EXAMPLES, name)) as f:
        tree = ast.parse(run_examples.rewrite(f.read()), name)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    ours = [m for m in imported if m.split(".")[0].startswith("renormalizer")]
    assert ours, name
    assert all(m.split(".")[0] == "renormalizer_tpu_torch" for m in ours), ours


def test_holstein_gs_runs_in_process_and_prints_the_jax_energy():
    argv = list(sys.argv)
    text, seconds = run_examples.run_example(
        os.path.join(run_examples.EXAMPLES, "holstein_gs.py"))
    assert sys.argv == argv and seconds > 0
    line = [ln for ln in text.splitlines() if ln.startswith("sweep energies:")][-1]
    last = float(line.rsplit(",", 1)[-1].strip(" ]"))
    assert last == pytest.approx(HOLSTEIN_GS_E, abs=1e-10)


@pytest.mark.parametrize("case", ["ok", "failed", "timeout"])
def test_subprocess_runner_follows_run_sh(case, tmp_path):
    """Exit 0 passes and brings back the real numbers and arrays of the
    module; a non-zero exit fails; a script still running at the limit is
    killed and reported as such (run.sh counts it as passed)."""
    body = {"ok": "import numpy as np\nx = 2.5\nocc = np.eye(2)\nname = 'a'\nprint('done')\n",
            "failed": "raise SystemExit(3)\n",
            "timeout": "import time\ntime.sleep(600)\n"}[case]
    script = tmp_path / "example.py"
    script.write_text(body)
    dump = str(tmp_path / "numbers.json")
    limit = 3 if case == "timeout" else 120
    res = run_examples.run_in_subprocess(str(script), timeout=limit, dump=dump)
    assert res["status"] == {"ok": "ok", "failed": "failed (3)", "timeout": "timeout"}[case]
    if case == "ok":
        assert "done" in res["output"]
        assert res["numbers"] == {"x": 2.5, "occ": [[1.0, 0.0], [0.0, 1.0]]}
    else:
        assert res["numbers"] is None
    if case == "timeout":
        assert res["seconds"] >= limit
