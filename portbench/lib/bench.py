"""What the harness finds by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``portbench/`` one file for each configuration
(``configs/``, named by ``BENCHMARK.json``), each traffic mix
(``traffic/<name>.json``), each traffic recipe (``recipes/<generator>.py``,
named by a mix) and each metric (``metrics/<name>.py``).  A
cell, configuration, traffic mix or metric is added with new files and
new entries alone."""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench_dir = self.root / BENCH_DIR.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.recipes = self.bench_dir / "recipes"
        self._readers: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The entries of ``kind`` (``end_to_end`` or ``per_layer``) that
        ``cell`` reports: those that list it, and those that list no
        cells."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The ``read(run)`` function of metric ``name``
        (``metrics/<name>.py``)."""
        if name not in self._readers:
            path = self.bench_dir / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]

    def peaks(self) -> dict:
        return json.loads((self.bench_dir / "peaks.json").read_text())
