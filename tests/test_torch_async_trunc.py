"""The site update's host-hiding machinery in the port, fp64 on the CPU.

The asynchronous static-plan selection (``RENO_ASYNC_TRUNC``), its staggered
revalidation and hysteresis, the masked and per-sector candidate routes,
the sketched threshold mode with its exact retry, the device index cache and the
tree's plan reuse.  Held against the JAX package's asynchronous DMRG (one
JAX job) and its ``trunc_device.candidates``, the JAX tests' constants, or
the port's own synchronous route."""

import collections

import numpy as np
import pytest
import torch

from fixtures import GS_E, holstein_model
from renormalizer_tpu.mps import Mpo as JaxMpo
from renormalizer_tpu.mps import Mps as JaxMps
from renormalizer_tpu.mps import trunc_device as jax_trunc
from renormalizer_tpu.mps.gs import optimize_mps as jax_optimize_mps
from renormalizer_tpu_torch.mps import Mpo, Mps, optimize_mps, trunc_device
from renormalizer_tpu_torch.mps.lib import select_indices
from renormalizer_tpu_torch.mps.mp import MatrixProduct
from renormalizer_tpu_torch.mps.svd_qn import _sector_indices
from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree, optimize_ttns
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria, profiling
from test_torch_dmrg import port_model
from test_torch_tn import port_exact_model

torch.set_num_threads(2)

ASYNC_PROCEDURE = [[10, 0.4], [20, 0.2], [30, 0.1]] + [[40, 0]] * 3
# tests/test_trunc_device.py::test_async_trunc_qn_drift_stress's growth
# into percent 0 at M=128, with two more percent-0 sweeps so that a plan is
# visited three times (the revalidation case)
DRIFT_PROCEDURE = [[32, 0.5], [64, 0.3], [128, 0]] + [[128, 0]] * 5


def _plan_stats(counts):
    """The selection paths in a counter delta, by path (``static`` ...)."""
    return collections.Counter({k[len("trunc.plan."):]: v for k, v in counts.items()
                                if k.startswith("trunc.plan.")})


def test_async_dmrg_matches_jax(monkeypatch):
    """tests/test_trunc_device.py::test_dmrg_async_trunc_regression's
    protocol in both packages from one start state."""
    monkeypatch.setenv("RENO_DEVICE_TRUNC", "1")
    monkeypatch.setenv("RENO_ASYNC_TRUNC", "1")
    jmps = JaxMps.random(holstein_model, 1, 10, percent=1.0)
    jmps.optimize_config.procedure = ASYNC_PROCEDURE
    e_jax, _ = jax_optimize_mps(jmps.copy(), JaxMpo(holstein_model))
    model = port_model()
    mps = Mps.random(model, 1, 10, percent=1.0)
    mps.optimize_config.procedure = ASYNC_PROCEDURE
    e_port, _ = optimize_mps(mps, Mpo(model))
    assert min(e_port) == pytest.approx(GS_E, rel=1e-5)
    assert min(e_port) == pytest.approx(min(e_jax), rel=1e-6)


@pytest.fixture(scope="module")
def drift_runs():
    """The drift procedure on one start state: synchronous, asynchronous,
    and asynchronous with a revalidation every 2 static visits.  Convergence is never
    declared, so every sweep runs."""
    model = port_model()
    mpo = Mpo(model)
    seed = Mps.random(model, 1, 32, percent=1.0)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, flag, revalidate in (("sync", "0", 24), ("async", "1", 24),
                                       ("revalidate", "1", 2)):
            mp.setenv("RENO_ASYNC_TRUNC", flag)
            mp.setattr(trunc_device, "STATIC_REVALIDATE", revalidate)
            before = profiling.snapshot()
            mps = seed.copy()
            mps.optimize_config.procedure = DRIFT_PROCEDURE
            mps.optimize_config.e_rtol = mps.optimize_config.e_atol = 0
            energies, opt = optimize_mps(mps, mpo)
            counts = profiling.delta(before)
            runs[name] = dict(e=np.array(energies), shapes=[t.shape for t in opt],
                              stats=_plan_stats(counts),
                              reads=counts["trunc.spectrum_reads"])
    return runs


@pytest.mark.parametrize("name", ["async", "revalidate"])
def test_async_selection_matches_sync_under_qn_drift(drift_runs, name):
    """Growth sweeps jump into percent-0 sweeps, so the qn patterns shift
    while the plans are in use: each shift must be caught by the pattern
    digest, and the lowest energies and bond shapes equal the synchronous
    route's.  Static updates read no spectrum; with revalidation every
    second or third visit, the stale path runs."""
    sync, run = drift_runs["sync"], drift_runs[name]
    assert min(run["e"]) == pytest.approx(GS_E, rel=1e-5)
    assert min(run["e"]) == pytest.approx(min(sync["e"]), rel=1e-9)
    assert run["shapes"] == sync["shapes"]
    stats = run["stats"]
    assert stats["static"] > 0 and stats["sync"] > 0
    assert sync["stats"]["static"] == sync["stats"]["sync"] == 0
    # every update reads one spectrum but the static ones
    assert run["reads"] == sync["reads"] - stats["static"]
    if name == "revalidate":
        assert stats["stale"] > 0
    else:
        assert stats["stale"] == 0


@pytest.mark.parametrize("gain, kept", [(0.0, "frozen"), (1e-3, "fresh")])
def test_hysteresis_compares_kept_weight(gain, kept):
    """Two sectors of four slots with a tie between their second states:
    the plan's frozen counts (2, 1) survive a flip to (1, 2) that gains no
    weight, and give way to one that gains 1e-3."""
    sigma = np.array([1.0, 0.5, 0.3, -1.0, 1.0, 0.5 * np.sqrt(1 + gain), 0.3, -1.0])
    fresh = [0, 4, 5]
    frozen = [0, 1, 4]
    out = MatrixProduct._hysteresis(fresh, sigma, (2, 1), (2, 4))
    assert out == (frozen if kept == "frozen" else fresh)


def _multi_sector(seed=7, m=150, n=130):
    rng = np.random.default_rng(seed)
    qnl = rng.integers(0, 3, (m, 1))
    qnr = rng.integers(0, 3, (n, 1))
    qntot = np.array([2])
    c = rng.standard_normal((m, n)) * ((qnl + qnr.T) == qntot)
    return c, qnl, qnr, qntot


@pytest.mark.parametrize("system", ["L", "R"])
def test_masked_batch_matches_loop_svd_and_jax(system, monkeypatch):
    """At full rank the masked batch (within the mask budget) gives the
    per-sector path's (a zero budget), a numpy SVD's of each sector and the
    JAX package's spectrum; its layout is (nsec_p, l1p) with each sector's
    lambda descending and the sentinels last, the per-sector path's None."""
    c, qnl, qnr, qntot = _multi_sector()
    m, n = c.shape
    cap = min(m, n)

    def run():
        out = trunc_device.candidates(c, qnl, qnr, qntot, system, cap,
                                      want_complement=False, return_layout=True)
        return out[1], out[3], out[2]

    sig_masked, layout, qn_list = run()
    monkeypatch.setattr(trunc_device, "MASK_BUDGET", 0)
    sig_loop, lay_loop, _ = run()
    assert lay_loop is None

    secs = _sector_indices(qnl, qnr, qntot)
    nsec_p, l1p = layout
    assert nsec_p == -(-len(secs) // 2) * 2 and len(sig_masked) == nsec_p * l1p
    by_sector = sig_masked.reshape(nsec_p, l1p)
    for row in by_sector:
        valid = row[row >= 0]
        assert np.all(np.diff(valid) <= 0) and np.all(row[len(valid):] < 0)
    svd = np.concatenate([np.linalg.svd(c[np.ix_(lset, rset)], compute_uv=False)
                          for _, lset, rset in secs])
    _, sig_jax, _ = jax_trunc.candidates(c, qnl, qnr, qntot, system, cap,
                                         want_complement=False)

    def top(s):
        return np.sort(s[s >= 0])[::-1][:len(svd)]

    ref = np.sort(svd)[::-1]
    for s in (sig_masked, sig_loop, np.asarray(sig_jax)):
        np.testing.assert_allclose(top(s), ref, atol=1e-10)
    # each sector's slots carry that sector's label
    labels = [tuple(qntot - nl) if system == "R" else tuple(nl) for nl, _, _ in secs]
    for i, label in enumerate(labels):
        assert set(qn_list[i * l1p:(i + 1) * l1p]) == {label}


def test_sketched_threshold_retries_exactly(monkeypatch):
    """tests/test_trunc_device.py::test_threshold_sketch_dmrg in the port:
    threshold criteria past an exact cap of 4 sketch to 48 states,
    normalized by the exact ||C||_F, and reach the exact route's energy.
    The starved sketch (1 state, and no oversampling: with 32 oversampled
    columns no sector of this model holds enough states to saturate) fails
    the saturation check and takes exact candidates on the device again,
    to the same energy."""
    model = port_model()
    mpo = Mpo(model)
    seed = Mps.random(model, 1, 16, percent=1.0)

    def cc(thr):
        return CompressConfig(CompressCriteria.threshold, threshold=thr)

    procedure = [[cc(1e-3), 0.4], [cc(1e-4), 0.2], [cc(1e-5), 0], [cc(1e-5), 0]]
    calls = {"frob": 0}
    frob = trunc_device.frob_norm

    def spy(arr):
        calls["frob"] += 1
        return frob(arr)

    monkeypatch.setattr(trunc_device, "frob_norm", spy)

    def run(caps=None):
        if caps is not None:
            monkeypatch.setattr(trunc_device, "EXACT_CAP", caps[0])
            monkeypatch.setattr(trunc_device, "SKETCH_CAP", caps[1])
        calls["frob"] = 0
        before = profiling.snapshot()
        mps = seed.copy()
        mps.optimize_config.procedure = procedure
        energies, _ = optimize_mps(mps, mpo)
        return (min(energies), calls["frob"],
                profiling.delta(before)["trunc.sketch_retries"])

    e_exact, frob_exact, retry_exact = run()
    assert frob_exact == 0 and retry_exact == 0
    e_sketch, frob_sketch, _ = run((4, 48))
    assert frob_sketch > 0
    assert e_sketch == pytest.approx(e_exact, rel=1e-6)
    monkeypatch.setattr(trunc_device, "OVERSAMPLE", 0)
    e_starved, _, retry_starved = run((4, 1))
    assert retry_starved > 0
    assert e_starved == pytest.approx(e_exact, rel=1e-6)


def test_verify_update_checks_the_kept_basis(monkeypatch):
    """Verify level 2: the kept basis of a blocked matrix passes (its
    spectrum against LAPACK's, complement slots beyond the rank as zeros);
    a basis that is not orthonormal fails."""
    monkeypatch.setattr(trunc_device, "VERIFY_LEVEL", 2)
    c, qnl, qnr, qntot = _multi_sector(seed=3, m=40, n=30)
    parts, sigma, qn_list = trunc_device.candidates(c, qnl, qnr, qntot, "L", 30,
                                                    want_complement=True)
    sidx = select_indices(sigma, qn_list, 36, 0.5)
    ms, _ = trunc_device.apply_selection(c, parts, sidx, 40, 30, "L")
    assert trunc_device.verify_update(ms, c, sigma, sidx, 40, 30)
    assert not trunc_device.verify_update(ms * 1.1, c, sigma, sidx, 40, 30)


def test_device_idx_is_keyed_by_content(monkeypatch):
    """One tensor for equal content; another for another dtype, shape or
    device; the cache is emptied past 4096 entries."""
    monkeypatch.setattr(trunc_device, "_IDX_CACHE", {})
    a = np.arange(6, dtype=np.int64)
    t = trunc_device._device_idx(a)
    assert trunc_device._device_idx(a.copy()) is t
    assert torch.equal(t, torch.arange(6))
    assert trunc_device._device_idx(a.astype(np.int32)) is not t
    assert trunc_device._device_idx(a.reshape(2, 3)) is not t
    assert trunc_device._device_idx(a, "meta").device.type == "meta"
    assert trunc_device._device_idx(a + 1) is not t
    for i in range(4100):
        trunc_device._device_idx(np.array([i]))
    assert len(trunc_device._IDX_CACHE) <= 4097
    assert trunc_device._device_idx(a) is not t


def test_tree_plan_reuse_matches_sync(monkeypatch):
    """Tree DMRG on exact_model's binary tree: the asynchronous route
    selects from the previous visit's spectrum where the pattern matches,
    to the synchronous route's energies."""
    model = port_exact_model()
    tree = BasisTree.binary(model.basis)
    ttno = TTNO(tree, model.ham_terms)
    procedure = [[16, 0.4]] + [[16, 0]] * 3
    energies = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("RENO_ASYNC_TRUNC", flag)
        before = profiling.snapshot()
        energies[flag] = optimize_ttns(TTNS.random(tree, 1, 16), ttno, procedure)
        stats = _plan_stats(profiling.delta(before))
    assert stats["tree_stale"] > 0
    np.testing.assert_allclose(energies["1"], energies["0"], atol=1e-8, rtol=0)
