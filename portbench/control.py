#!/usr/bin/env python3
"""The control of ``correct``, at a cell's own size: the plain reference
put in the program's place, its mode choice computed in bfloat16 (the
next precision below the format's float32).  For each seed it makes that
seed's pool, frames the control's streams of every wave in the
container, samples the blocks a run of that seed compares, encodes them
with the sound reference, and prints the numbers a run compares.  It
runs on the CPU (one process a core); the benchmark's runs do not run
it.

    python3 portbench/control.py --workload c16k-text --seeds 1 2 3

The last line is one JSON object: for each seed the control's numbers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, generate  # noqa: E402
from portbench.lib.bench import Benchmark  # noqa: E402
from portbench.reference import container  # noqa: E402


def readings(bench: Benchmark, cell: dict, seed: int,
             precision: str = "bf16") -> dict:
    """The numbers a run of ``seed`` compares, with the reference's
    streams in ``precision`` in the program's place."""
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    block = cfg["block_bytes"]
    lanes = cfg["lanes_per_device"] * cell["chips"]
    nwaves = max(1, traffic["pool_bytes"] // (block * lanes))
    blocks = generate.pool(traffic, nwaves, lanes, block, seed,
                           bench.recipes)
    t0 = time.perf_counter()
    flat = [b for wave in blocks for b in wave]
    streams = iter(check.reference_streams(flat, cfg["params"], precision))
    outcome = check.Outcome()
    for w, wave in enumerate(blocks):
        blob = container.pack([next(streams) for _ in wave],
                              [len(b) for b in wave], block)
        outcome.containers[w] = {blob: 1}
    t1 = time.perf_counter()
    picks = check.sample(blocks, outcome, cfg["check_blocks"], seed)
    want = check.reference_streams([blocks[w][b] for w, b in picks],
                                   cfg["params"])
    checks = check.compare(blocks, block, cfg["params"], outcome, picks,
                           want)
    print(f"seed {seed}: {len(flat)} blocks in {precision} in "
          f"{t1 - t0:.1f} s, {len(picks)} in f32 in "
          f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return {k: c["value"] for k, c in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = Benchmark()
    cell = bench.cell(args.workload)
    result = {"workload": args.workload, "seeds": {}}
    for s in args.seeds:
        result["seeds"][s] = readings(bench, cell, s)
        print(f"seed {s}: control {result['seeds'][s]}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
