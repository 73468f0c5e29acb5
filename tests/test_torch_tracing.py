"""The port's tracer (``renormalizer_tpu_torch.utils.profiling``): spans,
the counter registry, the host-wait hook and the clock anchors, on the CPU
in fp64 at tiny sizes."""

import warnings

import numpy as np
import pytest
import torch

from renormalizer_tpu_torch import EvolveConfig, EvolveMethod, HolsteinModel, Mol, Phonon, Quantity
from renormalizer_tpu_torch.mps import Mpo, Mps, gs, trunc_device
from renormalizer_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, with empty span and anchor records."""
    monkeypatch.setattr(profiling, "TRACING", True)
    profiling.clear()
    yield profiling
    profiling.clear()


def two_molecule_model() -> HolsteinModel:
    """Two molecules of the fixture's Holstein molecule (two modes of 4
    levels): at M = 16 the middle 2-site updates (1024 and 2048 elements)
    go to Davidson, the others to the dense eigensolver."""
    omegas = [Quantity(106.51, "cm^{-1}"), Quantity(1555.55, "cm^{-1}")]
    disps = [Quantity(30.1370, "a.u."), Quantity(8.7729, "a.u.")]
    ph_list = [Phonon.simple_phonon(w, d, 4) for w, d in zip(omegas, disps)]
    return HolsteinModel([Mol(Quantity(2.67, "eV"), ph_list)] * 2, Quantity(-0.1, "eV"))


def test_span_records_nothing_with_tracing_off(monkeypatch):
    monkeypatch.setattr(profiling, "TRACING", False)
    profiling.clear()
    first, second = profiling.span("dmrg.solve"), profiling.span("eig")
    assert first is second  # one shared no-op: nothing is allocated
    with first:
        with second:
            pass
    assert profiling.SPANS == [] and profiling.ANCHORS == []


def test_spans_nest_with_their_parents(tracing):
    with profiling.span("dmrg.solve"):
        with profiling.span("dmrg.sweep"):
            with profiling.span("eig"):
                pass
            with profiling.span("trunc"):
                with profiling.span("trunc.jacobi"):
                    pass
    parents = {name: parent for name, parent, _, _ in profiling.SPANS}
    assert parents == {"dmrg.solve": None, "dmrg.sweep": "dmrg.solve",
                       "eig": "dmrg.sweep", "trunc": "dmrg.sweep",
                       "trunc.jacobi": "trunc"}
    # recorded as they close; each lies inside its parent
    assert [s[0] for s in profiling.SPANS] == ["eig", "trunc.jacobi", "trunc",
                                               "dmrg.sweep", "dmrg.solve"]
    times = {name: (start, end) for name, _, start, end in profiling.SPANS}
    for name, parent in parents.items():
        assert times[name][0] <= times[name][1]
        if parent is not None:
            assert times[parent][0] <= times[name][0] <= times[name][1] <= times[parent][1]
    assert profiling.ANCHORS == []  # no profiler, no anchor


def test_dmrg_counters_match_the_sweeps_and_davidson(tracing, monkeypatch):
    model = two_molecule_model()
    mps = Mps.random(model, 1, 16, percent=1.0)
    mps.optimize_config.procedure = [[16, 0.4], [16, 0.2], [16, 0], [16, 0]]
    sweeps, niters = [], []
    single_sweep, davidson_fused = gs.single_sweep, gs.davidson_fused

    def counted_sweep(*args, **kwargs):
        sweeps.append(1)
        return single_sweep(*args, **kwargs)

    def counted_davidson(*args, **kwargs):
        out = davidson_fused(*args, **kwargs)
        niters.append(int(out[2]))
        return out

    monkeypatch.setattr(gs, "single_sweep", counted_sweep)
    monkeypatch.setattr(gs, "davidson_fused", counted_davidson)
    before = profiling.snapshot()
    gs.optimize_mps(mps, Mpo(model))
    counts = profiling.delta(before)
    assert niters, "no update reached Davidson"
    assert counts["dmrg.sweeps"] == len(sweeps) >= 2
    assert counts["davidson.iterations"] == sum(niters)
    names = [s[0] for s in profiling.SPANS]
    assert names.count("dmrg.solve") == 1
    assert names.count("dmrg.sweep") == len(sweeps)
    assert names.count("dmrg.update") == counts["dmrg.updates"]
    assert names.count("eig") == counts["dmrg.updates"]
    assert names.count("trunc") >= counts["dmrg.updates"]
    assert "env" in names


def test_one_tdvp_ps_step_counts_its_visits_and_lanczos(tracing):
    model = two_molecule_model()
    mps = Mps.random(model, 1, 8, percent=1.0)
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    mpo = Mpo(model)
    before = profiling.snapshot()
    mps.evolve(mpo, 0.2)
    counts = profiling.delta(before)
    fused, unfused = counts["tdvp.visits.fused"], counts["tdvp.visits.unfused"]
    assert fused + unfused == 2 * len(mps) and unfused >= 2
    # a fused visit propagates the site and the bond; an unfused one the
    # site, and the bond too unless it ends a half-sweep (two per step)
    assert counts["lanczos.calls"] == 2 * fused + unfused + (unfused - 2)
    assert counts["lanczos.steps"] > 0
    names = [s[0] for s in profiling.SPANS]
    assert names.count("tdvp.step") == 1
    assert names.count("tdvp.visit") == 2 * len(mps)
    assert names.count("lanczos") == counts["lanczos.calls"]
    assert {p for n, p, _, _ in profiling.SPANS if n == "lanczos"} <= {"tdvp.visit"}


def test_spectrum_reads_keep_their_module_name():
    before = trunc_device.SPECTRUM_READS
    assert before == profiling.COUNTERS["trunc.spectrum_reads"]
    trunc_device._read_spectrum(torch.tensor([4.0, 1.0, -1.0]))
    assert trunc_device.SPECTRUM_READS == before + 1
    assert trunc_device.SPECTRUM_READS == profiling.COUNTERS["trunc.spectrum_reads"]
    with pytest.raises(AttributeError):
        trunc_device.PLAN_STATS  # noqa: B018


def test_anchor_is_a_top_level_profiler_event(tracing):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("tdvp.step"):
            with profiling.span("tdvp.visit"):
                with profiling.span("lanczos"):
                    torch.ones(4) @ torch.ones(4)
    anchors = [e for e in prof.events() if e.name == profiling.ANCHOR]
    # the outermost span and its child each emit one; the grandchild none
    assert len(anchors) == len(profiling.ANCHORS) == 2
    assert all(e.cpu_parent is None for e in anchors)
    offsets = profiling.anchor_offsets_us(
        [(e.time_range.start + e.time_range.end) / 2 for e in anchors])
    # one clock: the two anchors give the same offset, up to the anchors'
    # own lengths and the two clocks' rounding
    assert offsets is not None and len(offsets) == 2
    slack = sum(e.time_range.end - e.time_range.start for e in anchors) + 1e3
    assert abs(offsets[1] - offsets[0]) < slack
    assert profiling.anchor_offsets_us([1.0], [1, 2]) is None


def test_wait_hook_counts_and_swallows_sync_warnings(tracing, monkeypatch):
    """The hook's bookkeeping, with torch's sync debug mode stubbed (this
    build has no CUDA): a sync warning under a span counts as a wait of the
    innermost span and is not shown; other warnings are; the mode and the
    warnings state come back when the outermost span closes."""
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning", lambda *a, **k: shown.append(str(a[0])))
    filters = list(warnings.filters)
    before = profiling.snapshot()
    with profiling.span("tdvp.step"):
        assert modes[-1] == "warn"
        with profiling.span("lanczos"):
            for _ in range(3):
                warnings.warn("called a synchronizing CUDA operation (at eigh)")
            profiling.count_wait()
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
    counts = profiling.delta(before)
    assert counts["waits.lanczos"] == 4 and counts["waits.tdvp.step"] == 1
    assert shown == ["something else"]
    assert modes[-1] == 0 and warnings.filters == filters
    profiling.count_wait()  # outside any span: not counted
    assert profiling.delta(before) == counts
    # spans without the hook leave torch's mode alone
    monkeypatch.setattr(profiling, "COUNT_WAITS", False)
    with profiling.span("tdvp.step"):
        assert modes[-1] == 0
    assert profiling.delta(before) == counts


def test_counters_count_with_tracing_off(monkeypatch):
    monkeypatch.setattr(profiling, "TRACING", False)
    before = profiling.snapshot()
    trunc_device._read_spectrum(np.array([1.0]))
    assert profiling.delta(before) == {"trunc.spectrum_reads": 1}
