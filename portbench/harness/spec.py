"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root,
``configs/`` (the file a configuration entry names), ``traffic/<mix>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py`` under the benchmark's
folder."""

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    """One cell's configuration, traffic, limits and metrics."""

    def __init__(self, cell_name):
        self.bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell_name not in cells:
            raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        self.cell = cells[cell_name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[self.cell["config"]]
        self.config = json.loads((ROOT / entry["file"]).read_text())
        self.traffic = self._json("traffic", self.cell["traffic"])
        self.limits = self._json("limits", cell_name)

    def _json(self, folder, name):
        return json.loads((BENCH_DIR / folder / f"{name}.json").read_text())

    def _applies(self, metric):
        return "workloads" not in metric or self.cell["name"] in metric["workloads"]

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def metric_module(self, name):
        path = BENCH_DIR / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
