"""The PyTorch port imports every module and runs its DMRG and evolution
slices with jax unimportable."""

import ast
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

_SCRIPT = r"""
import json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(2)
import importlib, pkgutil
import renormalizer_tpu_torch as rt
from renormalizer_tpu_torch.utils import constant

modules = [m.name for m in pkgutil.walk_packages(rt.__path__, "renormalizer_tpu_torch.")]
for name in modules:
    importlib.import_module(name)

q = rt.Quantity
j = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3], [-0.2, -0.3, 0.0]]) / constant.au2ev
phs = [rt.Phonon([w, w], [q(0), d], 4) for w, d in
       zip([q(106.51, "cm^{-1}"), q(1555.55, "cm^{-1}")],
           [q(30.1370, "a.u."), q(8.7729, "a.u.")])]
model = rt.HolsteinModel([rt.Mol(q(2.67, "eV"), phs, 15.45)] * 3, j)
mpo = rt.Mpo(model)
mps = rt.Mps.random(model, 1, 10, percent=1.0)
mps.optimize_config.procedure = [[10, 0.4], [10, 0]]
energies, _ = rt.optimize_mps(mps, mpo)

from renormalizer_tpu_torch.sbm import SpinBosonDynamics, param2mollist
sbm = SpinBosonDynamics(param2mollist(0.05, q(1), q(20), 1, 3),
                        evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps))
sbm.evolve(evolve_dt=0.2, nsteps=2)
print(json.dumps({
    "modules": modules,
    "sigma_z": sbm.sigma_z,
    "jax_modules": sorted(m for m, mod in sys.modules.items()
                          if mod is not None and m.split(".")[0] in ("jax", "jaxlib")),
    "renormalizer_tpu": [m for m in sys.modules
                         if m.split(".")[0] == "renormalizer_tpu"],
    "mpo_bond_dims": mpo.bond_dims,
    "energy": min(energies),
    "gs_zpe": model.gs_zpe,
}))
"""


def test_port_runs_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RENO_PLATFORM="cpu", RENO_DTYPE="fp64",
               PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                          text=True, env=env, cwd=repo, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_modules"] == []
    assert out["renormalizer_tpu"] == []
    for name in ("sbm.sbm", "sbm.lib", "utils.tdmps", "utils.rk", "lib.solvers",
                 "interop", "mps.tda", "cv.spectra_cv", "cv.zerot", "cv.finitet",
                 "vibration.vscf", "vibronic.vibronic", "tn.node", "tn.treebase",
                 "tn.symbolic_ttno", "tn.tree", "tn.hop_expr", "tn.gs",
                 "tn.time_evolution", "tn.utils_eph", "model.pyrazine",
                 "mps.offload", "utils.profiling"):
        assert "renormalizer_tpu_torch." + name in out["modules"]
    # 0.76317132 is the dense expm value of sigma_z(0.4) for this model
    assert out["sigma_z"][0] == 1.0 and abs(out["sigma_z"][2] - 0.76317132) < 1e-6
    assert out["mpo_bond_dims"][0] == out["mpo_bond_dims"][-1] == 1
    assert len(out["mpo_bond_dims"]) == 10
    # two sweeps at M=10 already sit within 1e-4 of the regression value
    gs_e = 0.08401412 + out["gs_zpe"]
    assert abs(out["energy"] - gs_e) < 1e-4 * gs_e


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_INITS = sorted(
    os.path.relpath(os.path.join(root, "__init__.py"), os.path.join(_REPO, "renormalizer_tpu"))
    for root, _, files in os.walk(os.path.join(_REPO, "renormalizer_tpu"))
    if "__init__.py" in files)


def _bound_names(path):
    """The public names a module binds at its top level, from its syntax
    tree (so the JAX package is read, never imported)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.asname for a in node.names if a.asname)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("init", _JAX_INITS)
def test_port_package_binds_every_name_of_the_jax_package(init):
    """Each ``__init__.py`` of the port binds every name its counterpart in
    the JAX package binds, by its own import statements: a submodule that
    another import happened to load does not count."""
    names = _bound_names(os.path.join(_REPO, "renormalizer_tpu", init))
    port_init = os.path.join(_REPO, "renormalizer_tpu_torch", init)
    assert os.path.exists(port_init), port_init
    missing = names - _bound_names(port_init)
    assert not missing, (init, sorted(missing))
    parts = os.path.dirname(init).split(os.sep) if os.path.dirname(init) else []
    mod = importlib.import_module(".".join(["renormalizer_tpu_torch"] + parts))
    assert all(hasattr(mod, n) for n in names)


def _port_sources():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, name) for name in
             ("chip_smoke.py", "energy_witness.py", "vmf_precision_probe.py",
              "padding_seed_probe.py", "eigh_precision_probe.py")]
    for root, dirs, files in os.walk(os.path.join(repo, "renormalizer_tpu_torch")):
        if "_build" in dirs:
            dirs.remove("_build")  # build output, not source
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_no_port_source_imports_jax_or_the_jax_package():
    """Every import statement of the port, the chip smoke script, the
    energy witness, the MU-VMF precision probe, the padding seed probe and
    the eigh precision probe, read from the syntax tree."""
    paths = _port_sources()
    assert len(paths) > 30
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "renormalizer_tpu"), (
                    path, name)
