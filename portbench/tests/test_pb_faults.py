"""The check catches a broken timed path: each cell's run, with the card's
look skipped and the program broken underneath, comes out not correct; the
same run unbroken comes out correct.  Faults: a step that returns its state
unchanged, an answer altered where it is produced, a solve that keeps half
the configuration's bond dimension, and a solve in another electron sector.
(No cell has a batch or an exchange between chips.)"""

import pytest

import pbtools

UNCHANGED = {
    # the solve runs, but hands back its start state
    "holstein-mps-dmrg": """
import renormalizer_tpu_torch as rt
solve = rt.optimize_mps
def unchanged(mps, mpo, omega=None):
    start = mps.copy()
    energies, _ = solve(mps, mpo, omega)
    return energies, start
rt.optimize_mps = unchanged
""",
    "holstein-ttns-dmrg": """
from renormalizer_tpu_torch.tn import gs
solve = gs.optimize_ttns
gs.optimize_ttns = lambda ttns, ttno, procedure=None: solve(ttns.copy(), ttno, procedure)
""",
    # the step returns its state unchanged
    "holstein-mps-tdvp": """
from renormalizer_tpu_torch.mps.mps import Mps
Mps.evolve = lambda self, mpo, dt, normalize=True: self.copy()
""",
}

ALTERED = {
    # the reported ground-state energy one part in a thousand off
    "holstein-mps-dmrg": """
import renormalizer_tpu_torch as rt
solve = rt.optimize_mps
def altered(mps, mpo, omega=None):
    energies, out = solve(mps, mpo, omega)
    return [e * (1 + 1e-3) for e in energies], out
rt.optimize_mps = altered
""",
    "holstein-ttns-dmrg": """
from renormalizer_tpu_torch.tn import gs
solve = gs.optimize_ttns
def altered(ttns, ttno, procedure=None):
    return [e * (1 + 1e-3) for e in solve(ttns, ttno, procedure)]
gs.optimize_ttns = altered
""",
    # one site of each new state moved by a thousandth of its norm
    "holstein-mps-tdvp": """
import torch
from renormalizer_tpu_torch.mps.mps import Mps
step = Mps.evolve
def altered(self, mpo, dt, normalize=True):
    out = step(self, mpo, dt, normalize)
    site = out[2]
    noise = torch.ones_like(site) * (1e-3 * torch.linalg.vector_norm(site) / site.numel() ** 0.5)
    out[2] = site + noise
    return out
Mps.evolve = altered
""",
}

CAPPED = {
    # the solve runs at half the configuration's bond dimension
    "holstein-mps-dmrg": """
import renormalizer_tpu_torch as rt
solve = rt.optimize_mps
def capped(mps, mpo, omega=None):
    mps.optimize_config.procedure = [[m // 2, p] for m, p in mps.optimize_config.procedure]
    return solve(mps, mpo, omega)
rt.optimize_mps = capped
""",
    "holstein-ttns-dmrg": """
from renormalizer_tpu_torch.tn import gs
solve = gs.optimize_ttns
gs.optimize_ttns = lambda ttns, ttno, procedure: solve(ttns, ttno,
                                                      [[m // 2, p] for m, p in procedure])
""",
}

SECTOR = {
    # the start, and so the solve, holds one electron too many
    "holstein-mps-dmrg": """
from renormalizer_tpu_torch import Mps
draw = Mps.random.__func__
Mps.random = classmethod(lambda cls, model, qntot, m_max, percent=1.0:
                         draw(cls, model, qntot + 1, m_max, percent))
""",
}

FAULTS = {"unchanged": UNCHANGED, "altered": ALTERED, "capped": CAPPED, "sector": SECTOR}
CASES = [(cell, kind) for cell in UNCHANGED
         for kind in ["sound"] + [k for k, f in FAULTS.items() if cell in f]]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return pbtools.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell, kind", CASES)
def test_a_broken_path_is_not_correct(copy, cell, kind):
    patch = FAULTS[kind][cell] if kind in FAULTS else ""
    result, err = pbtools.run_cell(copy, cell, seconds=1.0, patch=patch)
    assert result is not None, err[-3000:]
    assert result["correct"] is (kind == "sound"), result["checks"]
