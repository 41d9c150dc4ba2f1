"""The shape of BENCHMARK.json: names, units, keys,
the files it names, and which cells report which metric."""

import json
import math
import re

import pytest

from portbench.lib.bench import Benchmark
from portbench.tests.helpers import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], e
            if kind in ("configs", "workloads"):
                assert "workloads" not in e
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths)


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metrics = [n for m, n in names if m]
    assert len(metrics) == len(set(metrics))
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[kind]}) == len(SPEC[kind])
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in SPEC["workloads"]]
    bench = Benchmark()
    for c in cells:
        reported = {m["name"] for m in bench.metrics(c, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics(c, "per_layer")


def test_per_layer_moves_a_metric_of_each_cell():
    bench = Benchmark()
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
        for cell in m.get("workloads",
                          [w["name"] for w in SPEC["workloads"]]):
            bench.cell(cell)
            moved = {e["name"] for e in bench.metrics(cell, "end_to_end")}
            assert m["moves"] in moved, (m["name"], cell)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_files_named_exist():
    bench = Benchmark()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert {"params", "block_bytes", "lanes_per_device",
                "warmup_block_bytes", "check_blocks"} <= set(cfg)
    for w in SPEC["workloads"]:
        assert bench.traffic(w["traffic"])["generator"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (bench.bench_dir / "metrics" / f"{m['name']}.py").exists()


def test_run_seconds_fit_a_full_check():
    """A check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90
    s a cell to compile, 1200 s spare, within 43200 s."""
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_four_chip_cells():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, math.floor(len(SPEC["workloads"]) / 4))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_names_its_files(cell):
    bench = Benchmark()
    w = bench.cell(cell)
    assert bench.config(w["config"])
    assert bench.traffic(w["traffic"])
