#!/usr/bin/env python3
"""The benchmark of ``x3tpu_torch``: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  The cell
names a configuration (``portbench/configs/``) and a traffic mix
(``portbench/traffic/<name>.json``).  The run:

1. refuses to start (exit 2, no result) without as many CUDA cards as
   the cell asks for; it never falls back to the CPU;
2. set-up: makes the cell's pool of waves from ``--seed``
   (``lib/generate.py``), loads the program's kernels (built once into
   the checkout's ``build/``), and warms up the cell's shapes with one
   call each way;
3. the window: one caller in a closed loop, for ``--seconds``:
   ``x3tpu_torch.compress`` on the pool's next wave, then
   ``x3tpu_torch.decompress`` of the container it returned, each timed on
   the host clock from call to return (both return bytes on the host, so
   the cards' work is inside), in one process, whose PyTorch host pool
   has the configuration's ``host_threads`` (PyTorch's default where it
   names none);  with ``--trace 1`` the window runs under
   ``torch.profiler`` with a span around each call;
4. reads the peak device memory, frees the program's state, and exits 1
   without a result if ``jax``, ``jaxlib``, ``flax`` or ``x3tpu`` is
   loaded;
5. decides ``correct`` against the plain reference (``lib/check.py``,
   ``reference/``; ``--seed`` draws the blocks whose streams are
   compared) and prints each number compared beside its limit as
   the last lines on standard error;
6. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
   per-layer ones, each read by ``metrics/<name>.py``), ``device``,
   ``breakdown`` (traced runs), and last ``checks``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, generate  # noqa: E402
from portbench.lib.bench import Benchmark  # noqa: E402
from portbench.lib.trace import TraceView, breakdown  # noqa: E402
from portbench.reference import container  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "x3tpu"}
TRACE_DIR = ROOT / "build" / "portbench"


@dataclasses.dataclass
class Call:
    """One timed call of the window."""

    kind: str            # "compress" or "decompress"
    wave: int            # the pool's wave it ran on
    seconds: float       # host clock, call to return
    in_bytes: int        # input bytes (data, or the container)
    out_bytes: int       # returned bytes
    stream_bytes: int    # the blocks' streams in the container
    lanes: int           # blocks of the wave


@dataclasses.dataclass
class Run:
    """What a metric's reader gets."""

    setup_s: float
    calls: list
    view: Optional[TraceView]
    device_kind: str
    peaks: dict


@dataclasses.dataclass
class Program:
    """The system under test: its two entries."""

    compress: Callable
    decompress: Callable


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def run_cell(bench: Benchmark, cell: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             program: Optional[Program] = None,
             started: float = T0) -> Optional[dict]:
    """One run of ``cell``; returns the result line's object, or None
    where the JAX package was loaded."""
    import torch

    import x3tpu_torch
    from x3tpu_torch.parallel import mesh as meshmod
    from x3tpu_torch.parallel import runtime

    marks = [("imports", time.perf_counter())]
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if "host_threads" in cfg:
        # a deployment that gives the process this many host threads
        torch.set_num_threads(cfg["host_threads"])
    if program is None:
        program = Program(x3tpu_torch.compress, x3tpu_torch.decompress)
    on_card = torch.device(device).type == "cuda"
    params = x3tpu_torch.X3Params(**cfg["params"])
    # the configuration's further keywords of compress (dict_seed,
    # warm_start, seed_k, ...), the same in every call
    options = cfg.get("compress_options", {})
    # a cell on more than one chip runs over a mesh of that many devices
    # (on the CPU, as many "cpu" entries); one chip, the plain device
    mesh = None
    if cell["chips"] > 1:
        mesh = (meshmod.make_mesh(cell["chips"]) if on_card else
                meshmod.make_mesh(devices=[device] * cell["chips"]))
    used = mesh.devices if mesh else (torch.device(device),)
    block, lanes = cfg["block_bytes"], cfg["lanes_per_device"]
    wave_lanes = lanes * len(used)
    nwaves = max(1, traffic["pool_bytes"] // (block * wave_lanes))
    blocks = generate.pool(traffic, nwaves, wave_lanes, block, seed,
                           bench.recipes)
    waves = [b"".join(b) for b in blocks]
    marks.append(("pool", time.perf_counter()))

    def sync():
        if on_card:
            for d in used:
                torch.cuda.synchronize(d)

    if on_card:
        for d in used:
            torch.zeros(1, device=d)
        sync()
        marks.append(("CUDA context", time.perf_counter()))

    # warm-up: one call each way at the cell's capacities and lane count
    # (blocks of warmup_block_bytes: shorter blocks allocate the same
    # scratch in less time)
    caps = runtime.caps_for_block(block, window=params.window)
    wb = cfg["warmup_block_bytes"]
    warm = program.compress(waves[0][: wb * wave_lanes], params=params,
                            block_bytes=wb, caps=caps,
                            lanes_per_device=lanes, device=device,
                            mesh=mesh, **options)
    program.decompress(warm, caps=caps, lanes_per_device=lanes,
                       device=device, mesh=mesh)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - started

    calls, outcome = [], check.Outcome()
    frame = container.HEADER.size
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    def span(name):
        if trace:
            return torch.profiler.record_function("portbench." + name)
        return contextlib.nullcontext()

    end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < end:
        w = i % nwaves
        i += 1
        try:
            with span("compress"):
                t0 = time.perf_counter()
                blob = program.compress(waves[w], params=params,
                                        block_bytes=block,
                                        lanes_per_device=lanes, device=device,
                                        mesh=mesh, **options)
                t1 = time.perf_counter()
        except Exception as e:  # a failed call is counted, not fatal
            outcome.failed_calls += 1
            print(f"compress of wave {w} failed: {e!r}", file=sys.stderr)
            continue
        nblk = len(blocks[w])
        streams = len(blob) - frame - container.ENTRY.size * nblk
        calls.append(Call("compress", w, t1 - t0, len(waves[w]), len(blob),
                          streams, nblk))
        seen = outcome.containers.setdefault(w, {})
        seen[blob] = seen.get(blob, 0) + 1
        try:
            with span("decompress"):
                t0 = time.perf_counter()
                out = program.decompress(blob, lanes_per_device=lanes,
                                         device=device, mesh=mesh)
                t1 = time.perf_counter()
        except Exception as e:
            outcome.failed_calls += 1
            print(f"decompress of wave {w} failed: {e!r}", file=sys.stderr)
            continue
        calls.append(Call("decompress", w, t1 - t0, len(blob), len(out),
                          streams, nblk))
        if out != waves[w]:
            outcome.decode_mismatch += 1
        del blob, out
    view = None
    if trace:
        sync()
        prof.__exit__(None, None, None)
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / f"{cell['name']}.trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        view = TraceView.from_chrome(path, calls, len(used))
        path.unlink()
        print(f"trace: {view.tied[0]} of {view.tied[1]} device activities "
              f"tied to the host call that issued them", file=sys.stderr)

    # the peak of the fullest chip
    peak = max(torch.cuda.max_memory_allocated(d) for d in used) \
        if on_card else 0
    kind = torch.cuda.get_device_name(used[0]) if on_card else "cpu"
    del warm, mesh
    if on_card:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return None

    # the comparison, once the window has closed and the state is freed
    t_ref = time.perf_counter()
    picks = check.sample(blocks, outcome, cfg["check_blocks"], seed)
    want = check.reference_streams([blocks[w][b] for w, b in picks],
                                   cfg["params"])
    checks = check.compare(blocks, block, cfg["params"], outcome, picks,
                           want)
    correct = check.passed(checks, picks)
    t_ref = time.perf_counter() - t_ref

    run = Run(setup_s, calls, view, kind, bench.peaks())
    level = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell["name"], level):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": len(used), "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": len(calls) + outcome.failed_calls,
              "failed": outcome.failed_calls + outcome.decode_mismatch,
              "metrics": metrics, "device": dev}
    if view is not None:
        t0, t1 = view.window()
        dev["busy_s"] = sum(view.busy(s) for s in view.spans)
        dev["window_s"] = t1 - t0
        result["breakdown"] = breakdown(view)

    comp = [c for c in calls if c.kind == "compress"]
    ratio = (sum(c.stream_bytes for c in comp) / sum(c.in_bytes for c in comp)
             if comp else float("nan"))
    print(f"cell {cell['name']} seed {seed}: {len(comp)} compress and "
          f"{len(calls) - len(comp)} decompress calls in the window; "
          f"set-up {setup_s:.3f} s; ratio {ratio:.6f}; "
          f"{len(picks)} blocks compared with the reference in "
          f"{t_ref:.1f} s", file=sys.stderr)
    at = started
    print("set-up: " + ", ".join(
        f"{name} {t - at:.3f} s" for (name, t), at in
        zip(marks, [started] + [t for _, t in marks[:-1]])), file=sys.stderr)
    for k in ("compress", "decompress"):
        ms = [c.seconds * 1e3 for c in calls if c.kind == k]
        if ms:
            q = sorted(ms)
            by_wave = {w: sorted(c.seconds * 1e3 for c in calls
                                 if c.kind == k and c.wave == w)
                       for w in range(nwaves)}
            medians = [round(v[len(v) // 2], 3)
                       for v in by_wave.values() if v]
            print(f"{k} ms: first {ms[0]:.3f}, min {q[0]:.3f}, median "
                  f"{q[len(q) // 2]:.3f}, max {q[-1]:.3f}; first calls "
                  f"{[round(x, 3) for x in ms[:6]]}; median by wave "
                  f"{medians}", file=sys.stderr)
    if on_card:
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Benchmark()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()} "
              f"(torch.cuda.is_available() is "
              f"{torch.cuda.is_available()})", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
