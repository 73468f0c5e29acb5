"""Device <-> host tiering (RENO_HOST_OFFLOAD) in the port, fp64 on the CPU,
with the port of ``tests/test_offload.py``: on the CPU the tiers share one
memory, so the tensors stay as they are and only the bookkeeping moves; the
results must equal the untiered route's.  Also the profiling and log
helpers of ``utils/``."""

import json
import logging

import numpy as np
import pytest
import torch

from fixtures import GS_E
from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
from renormalizer_tpu_torch.model import Op
from renormalizer_tpu_torch.mps import Mpo, Mps, offload, optimize_mps
from renormalizer_tpu_torch.mps.lib import Environ
from renormalizer_tpu_torch.utils import EvolveConfig, EvolveMethod, log, profiling
from renormalizer_tpu_torch.utils.profiling import maybe_profile
from test_torch_dmrg import port_model
from test_torch_tn import port_exact_model

torch.set_num_threads(2)


@pytest.fixture
def tiering(monkeypatch):
    monkeypatch.setenv("RENO_HOST_OFFLOAD", "2")
    offload.hot_window.cache_clear()
    yield monkeypatch
    offload.hot_window.cache_clear()


def test_environ_tiered_store_roundtrip(tiering):
    model = port_model()
    mps = Mps.random(model, 1, 10)
    mpo = Mpo(model)
    environ = Environ(mps, mpo)
    store = environ._store
    assert isinstance(store, offload.TieredStore)
    # building both domains with a 2-entry hot window evicts
    assert store.n_evicted > 0
    tiering.setenv("RENO_HOST_OFFLOAD", "0")
    offload.hot_window.cache_clear()
    plain = Environ(mps, mpo)
    assert isinstance(plain._store, dict)
    for key, tensor in plain._store.items():
        assert torch.equal(environ.read(*key), tensor)
    assert store.n_restored > 0


def test_dmrg_with_offload_matches_regression(tiering):
    model = port_model()
    mpo = Mpo(model)
    mps = Mps.random(model, 1, 10, percent=1.0)
    # force site-tensor offload of everything beyond the window
    mps.compress_config.dump_matrix_size = 1
    mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]
    energies, _ = optimize_mps(mps.copy(), mpo)
    assert min(energies) == pytest.approx(GS_E, rel=1e-5)


@pytest.mark.parametrize("access", ["getitem", "iter"])
def test_cold_site_transparent_restore(tiering, access):
    model = port_model()
    mps = Mps.random(model, 1, 10, percent=1.0)
    mps.compress_config.dump_matrix_size = 1
    mpo = Mpo(model)
    e_before = mps.expectation(mpo)
    hot = [t.clone() for t in mps._mp]
    mps._offload_cold_sites(0)
    cold = sorted(mps._cold_sites)
    assert cold == list(range(3, len(mps)))
    if access == "getitem":
        tensors = [mps[i] for i in cold]
    else:
        tensors = list(mps)[cold[0]:]
    assert not mps._cold_sites
    for i, t in zip(cold, tensors):
        assert torch.equal(t, hot[i])
    mps._offload_cold_sites(0)
    assert mps.expectation(mpo) == pytest.approx(e_before, rel=1e-12)
    assert not mps._cold_sites


def test_tdvp_with_offload_matches(tiering):
    """TDVP-PS with the tiering reproduces the untiered dynamics."""
    model = port_exact_model()
    mpo = Mpo(model)

    def run():
        mps = Mps.hartree_product_state(model, {model.e_dofs[0]: 1})
        mps = mps.expand_bond_dimension(hint_mpo=mpo)
        mps.compress_config.dump_matrix_size = 1  # offload everything cold
        mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
        for _ in range(3):
            mps = mps.evolve(mpo, 0.2)
        return np.array(mps.expectations([Op(r"a^\dagger a", d) for d in model.e_dofs]))

    with_tiering = run()
    tiering.setenv("RENO_HOST_OFFLOAD", "0")
    offload.hot_window.cache_clear()
    without = run()
    np.testing.assert_allclose(with_tiering, without, atol=1e-10, rtol=0)


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    """``optimize_mps`` under ``RENO_PROFILE`` writes a Chrome trace with its
    spans on the profile's timeline, as complete events, and leaves no
    span recorded behind it."""
    monkeypatch.setenv("RENO_PROFILE", str(tmp_path))
    # the smallest chain: the profile holds every torch operator of the call
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 2, Quantity(1), 3)
    mps = Mps.random(model, 1, 2)
    mps.optimize_config.procedure = [[2, 0], [2, 0]]
    optimize_mps(mps, Mpo(model))
    trace = tmp_path / "dmrg" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    sweeps = [e for e in events if e.get("name") == "dmrg.sweep"]
    assert sweeps and all(e["ph"] == "X" and e["dur"] > 0 for e in sweeps)
    solve = [e for e in events if e.get("name") == "dmrg.solve"]
    assert len(solve) == 1
    anchors = sorted(e["ts"] + e["dur"] / 2 for e in events if e.get("name") == profiling.ANCHOR)
    # on the profile's clock the solve opens just after its own anchor, and
    # holds its sweeps
    assert 0 <= solve[0]["ts"] - anchors[0] < 5e4
    assert solve[0]["ts"] <= min(e["ts"] for e in sweeps)
    assert profiling.SPANS == [] and not profiling.TRACING
    monkeypatch.delenv("RENO_PROFILE")
    with maybe_profile("off"):
        pass
    assert not (tmp_path / "off").exists()


def test_log_helpers(tmp_path):
    path = tmp_path / "run.log"
    handler = log.register_file_output(str(path), level=logging.INFO)
    levels = [h.level for h in log.package_logger.handlers]
    try:
        log.set_stream_level(logging.WARNING)
        assert all(h.level == logging.WARNING for h in log.package_logger.handlers)
        handler.setLevel(logging.INFO)
        log.getLogger("renormalizer_tpu_torch.test").info("tiered")
    finally:
        log.package_logger.removeHandler(handler)
        handler.close()
        for h, level in zip(log.package_logger.handlers, levels):
            h.setLevel(level)
    assert "tiered" in path.read_text()
    assert log.getLogger("x") is logging.getLogger("x")
    root = logging.getLogger()
    kept = list(root.handlers)
    stream = logging.StreamHandler()
    root.addHandler(stream)
    try:
        log.disable_stream_output()
        assert stream not in root.handlers
    finally:
        root.handlers[:] = kept
