"""A configuration, a cell and a per-layer metric added as new files run
without an edit to any file the benchmark has; the last line's schema."""

import json

import pbtools

DUMMY_METRIC = '''
def install(probe):
    probe.state["dummy_units_seen"] = 0

def read(probe):
    return float(probe.units)
'''

NUMBER = (int, float)


def _add_dummy(copy):
    """New files only, and new entries in BENCHMARK.json."""
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    config = json.loads((copy / "portbench/configs/holstein6-mps-m512.json").read_text())
    config.update(name="dummy-chain", m=6)
    (copy / "portbench/configs/dummy-chain.json").write_text(json.dumps(config))
    (copy / "portbench/traffic/dummy-mix.json").write_text(json.dumps({
        "kind": "ground_state", "unit_metric": "gs_solve_s", "method": "2site",
        "procedure_percent": [0.4, 0, 0], "pool": {"size": 1, "seed": 1},
        "warmup_units": 1, "trace_units": 1,
        "check": {"count": 1, "within_first": 1}}))
    (copy / "portbench/limits/dummy-cell.json").write_text(
        json.dumps({"e_gap": 1e-6, "sigma_rel": 1e-1}))
    (copy / "portbench/metrics/dummy_units.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy-chain", "source": "https://example.org",
                             "file": "portbench/configs/dummy-chain.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-chain",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "gs_solve_s":
            metric["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_units", "unit": "units", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "gs_solve_s", "workloads": ["dummy-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))


def _check_schema(result, trace):
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert isinstance(result["attempted"], int) and result["attempted"] >= 1
    assert isinstance(result["failed"], int)
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert isinstance(device["memory_peak_bytes"], int)
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
        assert isinstance(metric["value"], NUMBER)
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    if trace:
        assert isinstance(device["busy_s"], NUMBER) and device["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10


def test_added_files_run_without_edits(tmp_path):
    copy = pbtools.tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*") if p.is_file()}
    _add_dummy(copy)
    for path, content in before.items():
        assert path.read_bytes() == content
    result, err = pbtools.run_cell(copy, "dummy-cell", trace=0)
    assert result is not None, err[-3000:]
    _check_schema(result, trace=0)
    assert set(result["metrics"]) == {"gs_solve_s", "setup_s"}
    assert result["correct"], result["checks"]
    result, err = pbtools.run_cell(copy, "dummy-cell", trace=1)
    assert result is not None, err[-3000:]
    _check_schema(result, trace=1)
    # the new reader reports; the CPU records no device time, so the
    # device's readers return nothing and are left out
    assert result["metrics"]["dummy_units"]["value"] == 1.0
    assert "device_idle_pct.gs" not in result["metrics"]
    assert "sweeps_per_solve" not in result["metrics"]  # lists other cells
