"""``lanczos_graph_replay_pct`` on synthetic counters: the replays' share of
the window's Lanczos calls, and None for a program that counts no graphs,
for a window without Lanczos calls or without device time."""

import collections
import importlib.util
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness.probe import Probe  # noqa: E402


def _reader():
    spec = importlib.util.spec_from_file_location(
        "lanczos_graph_replay_pct", BENCH / "metrics" / "lanczos_graph_replay_pct.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _probe(counts, device=True):
    tracer = types.SimpleNamespace(delta=lambda before: collections.Counter(counts))
    probe = Probe()
    probe.state["spans"], probe.state["spans.counters"] = tracer, {}
    probe.trace = types.SimpleNamespace(kernels=[("k", 0.0, 1.0)] if device else [])
    probe.units = 2
    return probe


@pytest.mark.parametrize("counts, device, expected", [
    ({"lanczos.calls": 140, "lanczos.graph.replays": 140}, True, 100.0),
    ({"lanczos.calls": 140, "lanczos.graph.replays": 105,
      "lanczos.graph.eager.budget": 35}, True, 75.0),
    ({"lanczos.calls": 140, "lanczos.graph.eager.first_sighting": 140}, True, 0.0),
    ({"lanczos.calls": 140, "waits.lanczos": 280}, True, None),
    ({"tdvp.visits.fused": 34}, True, None),
    ({"lanczos.calls": 140, "lanczos.graph.replays": 140}, False, None),
], ids=["all", "budget", "eager", "no-graphs", "no-calls", "no-device"])
def test_replay_share(counts, device, expected):
    assert _reader().read(_probe(counts, device)) == expected
