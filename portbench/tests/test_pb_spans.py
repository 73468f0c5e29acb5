"""The program-span readers (``harness/spans.py``) on synthetic traces: the
idle gaps split by the innermost open span, the anchor's offset applied,
and None without device time; and a traced CPU run in which every new
reader finds no device time and reads nothing."""

import collections
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import pbtools  # noqa: E402
from harness import spans  # noqa: E402
from harness.probe import Probe  # noqa: E402


class FakeTrace:
    """A reduced profile: device operations and top-level host operators,
    in microseconds of the profile's clock."""

    def __init__(self, busy, top=()):
        self.kernels = [("k", a, b) for a, b in busy]
        self._top = sorted(top)
        self._busy = [list(iv) for iv in busy]

    def busy_intervals(self):
        return self._busy

    def busy_s(self):
        return sum(b - a for a, b in self._busy) / 1e6


def fake_tracer(span_list, anchors_ns, counters=None):
    return types.SimpleNamespace(
        TRACING=False, SPANS=list(span_list), ANCHORS=list(anchors_ns),
        COUNTERS=collections.Counter(counters or {}),
        clear=lambda: None, snapshot=lambda: {},
        delta=lambda before: collections.Counter(counters or {}))


def probe_for(tracer, trace, units=1, window_s=1.0):
    probe = Probe()
    probe.state["spans"] = tracer
    probe.state["spans.counters"] = {}
    probe.trace, probe.units, probe.window_s = trace, units, window_s
    return probe


# one solve of 0..100 us on the span clock: a sweep 10..90 with an eig
# 20..40 and a trunc 50..80 holding a trunc.jacobi 60..70
SOLVE = [("eig", "dmrg.sweep", 20_000, 40_000),
         ("trunc.jacobi", "trunc", 60_000, 70_000),
         ("trunc", "dmrg.sweep", 50_000, 80_000),
         ("dmrg.sweep", "dmrg.solve", 10_000, 90_000),
         ("dmrg.solve", None, 0, 100_000)]


def test_segments_follow_the_innermost_span():
    pieces = spans.segments(SOLVE)
    assert [(a, b, name) for a, b, name, _ in pieces] == [
        (0, 10_000, "dmrg.solve"), (10_000, 20_000, "dmrg.sweep"),
        (20_000, 40_000, "eig"), (40_000, 50_000, "dmrg.sweep"),
        (50_000, 60_000, "trunc"), (60_000, 70_000, "trunc.jacobi"),
        (70_000, 80_000, "trunc"), (80_000, 90_000, "dmrg.sweep"),
        (90_000, 100_000, "dmrg.solve")]
    assert {root for *_, root in pieces} == {"dmrg.solve"}


def test_gaps_are_split_by_overlap_with_the_anchor_offset_applied():
    # the profile's clock runs 1000 us ahead of the span clock: the anchor
    # noted at 0 ns on the span clock is the event at 999..1001 us
    top = [(999.0, 1001.0, spans.ANCHOR), (1030.0, 1031.0, "aten::mm")]
    # busy on the profile's clock 1015..1025 (span clock 15..25 us) and
    # 1055..1065 (55..65 us): the rest of 0..100 us is idle
    trace = FakeTrace([(1015.0, 1025.0), (1055.0, 1065.0)], top)
    probe = probe_for(fake_tracer(SOLVE, [0]), trace, units=2)
    idle = spans.idle_by_span(probe)
    expect = {"dmrg.solve": 20e-6, "dmrg.sweep": 25e-6, "eig": 15e-6,
              "trunc": 15e-6, "trunc.jacobi": 5e-6}
    assert set(idle) == {("dmrg.solve", name) for name in expect}
    for name, seconds in expect.items():
        assert idle[("dmrg.solve", name)] == pytest.approx(seconds, abs=1e-12)
    # per unit; the four ground-state readers add up to the idle in the solve
    eig = spans.idle_per_unit(probe, "dmrg.solve", names=("eig",))
    trunc = spans.idle_per_unit(probe, "dmrg.solve", names=("trunc", "trunc.jacobi"))
    rest = spans.idle_per_unit(probe, "dmrg.solve", exclude=("eig", "trunc", "trunc.jacobi"))
    assert eig == pytest.approx(7.5e-6) and trunc == pytest.approx(10e-6)
    assert eig + trunc + rest == pytest.approx(80e-6 / 2)
    assert spans.idle_per_unit(probe, "tdvp.step") == 0


def test_the_nearest_anchor_gives_each_gap_its_offset():
    # two anchors whose offsets differ by 4 us (clock drift): a gap near
    # each is moved by that anchor's offset
    solve = [("dmrg.solve", None, 0, 2_000_000)]
    top = [(1000.0, 1000.0, spans.ANCHOR), (3004.0, 3004.0, spans.ANCHOR)]
    trace = FakeTrace([(1000.0, 1010.0), (2990.0, 3004.0)], top)
    probe = probe_for(fake_tracer(solve, [0, 2_000_000]), trace)
    offsets, mids = spans.anchor_offsets(probe, [0, 2_000_000])
    assert offsets == [1000.0, 1004.0] and mids == [1000.0, 3004.0]
    assert spans.to_span_clock(1010.0, mids, offsets) == pytest.approx(10_000)
    assert spans.to_span_clock(2990.0, mids, offsets) == pytest.approx(1_986_000)
    # idle in the solve (0..2000 us): from the first busy interval's end
    # (10 us) to the second's start (1986 us); the second ends at 2000 us
    idle = spans.idle_by_span(probe)
    assert idle[("dmrg.solve", "dmrg.solve")] == pytest.approx(1976e-6)


def test_none_without_device_time_tracer_or_anchors():
    no_device = probe_for(fake_tracer(SOLVE, [0]), FakeTrace([], [(0, 1, spans.ANCHOR)]))
    assert spans.idle_by_span(no_device) is None
    assert spans.counter_delta(no_device) is None
    busy = FakeTrace([(10.0, 20.0)], [(0, 1, spans.ANCHOR)])
    assert spans.idle_by_span(probe_for(None, busy)) is None
    assert spans.counter_delta(probe_for(None, busy)) is None
    # anchors recorded that the profile does not hold
    assert spans.idle_by_span(probe_for(fake_tracer(SOLVE, [0, 5]), busy)) is None


def test_install_switches_the_program_tracer_once(monkeypatch):
    monkeypatch.syspath_prepend(str(pbtools.ROOT))
    from renormalizer_tpu_torch.utils import profiling

    probe = Probe()
    spans.install(probe)
    spans.install(probe)
    assert profiling.TRACING and probe.state["spans"] is profiling
    probe.restore()
    assert not profiling.TRACING


def test_traced_cpu_run_reads_none(tmp_path):
    """A traced run of the TDVP cell on the CPU: the program's spans are
    recorded, but without device time no new metric is reported."""
    copy = pbtools.tiny_copy(tmp_path)
    result, err = pbtools.run_cell(copy, "holstein-mps-tdvp", trace=1)
    assert result is not None, err[-3000:]
    for name in ("lanczos_idle_s_per_step", "visit_idle_s_per_step",
                 "lanczos_waits_per_step"):
        assert name not in result["metrics"]
    assert "host_syncs_per_step" in result["metrics"]
