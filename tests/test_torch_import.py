"""The PyTorch port imports and runs its DMRG slice with jax unimportable."""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

_SCRIPT = r"""
import json, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(2)
import renormalizer_tpu_torch as rt
from renormalizer_tpu_torch.utils import constant

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
print(json.dumps({
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
    assert out["mpo_bond_dims"][0] == out["mpo_bond_dims"][-1] == 1
    assert len(out["mpo_bond_dims"]) == 10
    # two sweeps at M=10 already sit within 1e-4 of the regression value
    gs_e = 0.08401412 + out["gs_zpe"]
    assert abs(out["energy"] - gs_e) < 1e-4 * gs_e
