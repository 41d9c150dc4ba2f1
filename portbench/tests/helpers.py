"""Shared set-up of the benchmark's tests: a temporary checkout with more
configurations, traffic mixes, a traffic recipe, cells and metrics,
added as files and ``BENCHMARK.json`` entries only, at a size the CPU
runs in seconds."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "x3-tiny",
    "source": "a size for the CPU tests",
    "params": {"max_match_count": 15, "window": 1024, "magic_factor1": 4,
               "magic_factor2": 0, "nl_remap": False},
    "block_bytes": 256,
    "lanes_per_device": 2,
    "warmup_block_bytes": 128,
    "check_blocks": 4,
    "assumed": {},
    "reduced": [],
}
SEEDED_CONFIG = {**TINY_CONFIG, "name": "x3-tiny-seeded",
                 "compress_options": {"dict_seed": True, "seed_k": 8,
                                      "seed_sample": 256}}
TINY_TRAFFIC = {"generator": "zipf_text", "source": "tests",
                "layout_seed": 5, "vocab": 500,
                "word_letters": [2, 8], "zipf_exponent": 1.0,
                "sentence_words": [5, 25], "enders": ".,;!?",
                "line_width": 70, "pool_bytes": 1024}
ROWS_TRAFFIC = {"generator": "tiny_rows", "source": "tests", "width": 24,
                "layout_seed": 1, "pool_bytes": 4096}
ROWS_RECIPE = '''"""tiny_rows: rows of ``width`` letters, a line each."""

import numpy as np


def make(p, nbytes, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(97, 101, (nbytes // p["width"] + 1, p["width"]),
                        dtype=np.uint8)
    rows[:, -1] = 10
    return rows.tobytes()[:nbytes]
'''
CALLS_METRIC = '''"""calls (calls): compress calls in the window."""


def read(run):
    return float(sum(1 for c in run.calls if c.kind == "compress"))
'''
SPANS_METRIC = '''"""spans.compress (spans): compress spans, traced window."""


def read(run):
    if run.view is None:
        return None
    return float(len(run.view.calls("compress")))
'''


def tiny_checkout(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``tmp`` with
    the cells ``tiny-text`` (configuration ``x3-tiny``, traffic
    ``tinytext``), ``tiny-mesh`` (``x3-tiny`` over four devices, traffic
    ``tinyrows`` of the recipe ``tiny_rows``) and ``tiny-seeded``
    (``x3-tiny-seeded``, dictionary seeds on), the end-to-end metric
    ``calls`` and the per-layer metric ``spans.compress``."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = [("tiny-text", "x3-tiny", "tinytext", 1),
             ("tiny-mesh", "x3-tiny", "tinyrows", 4),
             ("tiny-seeded", "x3-tiny-seeded", "tinytext", 1)]
    for name in ("x3-tiny", "x3-tiny-seeded"):
        spec["configs"].append({"name": name, "source": "tests",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "tests"})
    for name, config, traffic, chips in cells:
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": chips,
                                  "why": "tests"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [c[0] for c in cells]
    spec["end_to_end"].append({"name": "calls", "unit": "calls",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": [c[0] for c in cells]})
    spec["per_layer"].append({"name": "spans.compress", "unit": "spans",
                              "better": "lower", "source": "device_trace",
                              "layer": "runtime", "moves": "calls",
                              "workloads": ["tiny-text"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (root / "portbench/configs/x3-tiny.json").write_text(
        json.dumps(TINY_CONFIG))
    (root / "portbench/configs/x3-tiny-seeded.json").write_text(
        json.dumps(SEEDED_CONFIG))
    (root / "portbench/traffic/tinytext.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (root / "portbench/traffic/tinyrows.json").write_text(
        json.dumps(ROWS_TRAFFIC))
    (root / "portbench/recipes/tiny_rows.py").write_text(ROWS_RECIPE)
    (root / "portbench/metrics/calls.py").write_text(CALLS_METRIC)
    (root / "portbench/metrics/spans.compress.py").write_text(SPANS_METRIC)
    return root
