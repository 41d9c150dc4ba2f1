#!/usr/bin/env python3
"""Where one lane of kernel K1 spends its cycles: per-phase ``clock64()``
counters, on one NVIDIA GPU.

    python3 tools/k1_phases.py [TREE ...]

For each checkout TREE of the port (default: this one), in a process of
its own that imports that tree's ``x3tpu_torch``: builds its
``csrc/x3_encoder.cu`` once more with ``-DX3_PHASES`` (the main path's
library never has the counters) into a library of its own, encodes 32
blocks of 16 KiB of this checkout's ``chip_smoke.corpus`` (the same bytes
for every tree) at ``caps_for_block(16 KiB)`` and ``X3Params()``, checks
that the counted kernel gives the main path's words, and prints for the
slowest lane the cycles per event of each phase, the leader thread's
share, and the events; then one JSON line.  The leader reads the clock right after each of the
CTA's barriers, so a phase's cycles are the whole CTA's time in it.  Cycles
convert to time at the counted kernel's own rate (its CUDA-event time over
the slowest lane's cycles).
"""

import ctypes
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCK = 16 * 1024
# x3_core.cuh PH_* slots, in order
# (in the redesigned K1 slot 0 is the leader's whole pass 1: its warp's
# ctx-row job, then the wait for the scan; "probe" and "window scan" are
# the first scanning thread's share of pass 1, so the slots overlap)
PHASES = ("t32 load | pass 1 (leader)", "probe", "window scan",
          "sweep + veto probes", "hit stats", "leader chain", "rank update")
SLOTS = ("total", "events", "hits", "veto probes", "literal bytes")
# parts of the phases (x3_core.cuh PH_SUB_*)
SUBS = ("pass-1 ctx rows (leader's warp)", "leader: mode choice",
        "leader: AC coding", "leader: table updates")
LANES = 32


def build_counted(kernel="encoder", define="-DX3_PHASES", name="k1phases"):
    """A kernel's library built once more with ``define`` (the phase
    counters), keyed like the main path's libraries by the sources and
    flags; loaded, not yet bound."""
    from x3tpu_torch.vm import driver

    lib = driver.library_path(name)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [driver._nvcc(), *driver.NVCC_FLAGS, define, "-o",
             str(tmp), str(driver.CSRC / driver.SOURCES[kernel])],
            capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas (counted): {line.strip()}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {define} failed:\n{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def median_ms(fn, runs=3):
    """Median CUDA-event time of ``runs`` calls of ``fn``."""
    import torch

    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def print_card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)


def split_of(tree: pathlib.Path, data_path: pathlib.Path) -> dict:
    """Count one tree's K1 on the wave in ``data_path``."""
    sys.path.insert(0, str(tree))
    import torch
    from x3tpu_torch import X3Params, codec
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.vm import driver

    counted = build_counted()
    driver._bind_encoder(counted, phases=True)
    data = data_path.read_bytes()
    lanes = len(data) // BLOCK
    params, caps = X3Params(), runtime.caps_for_block(BLOCK)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    text, tlen = codec.pack_blocks(blocks, params, caps)
    text, tlen = torch.from_numpy(text).cuda(), torch.from_numpy(tlen).cuda()
    ph = torch.zeros((lanes, len(PHASES) + len(SLOTS) + len(SUBS)),
                     dtype=torch.int64, device="cuda")

    def plain_call():
        return driver.encode_blocks_cuda(text, tlen, params, caps)

    def counted_call():
        ph.zero_()
        return driver._encode_with(text, tlen, params, caps, lib=counted,
                                   phases=ph)

    ref, got = plain_call(), counted_call()
    for what, a, b in zip(("words", "byte_lens", "counts"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"the counted kernel's {what} differ")

    plain_ms, counted_ms = median_ms(plain_call), median_ms(counted_call)
    arr = ph.cpu().numpy()
    n = len(PHASES)
    slow = int(arr[:, n].argmax())
    row = arr[slow]
    total, events = int(row[n]), int(row[n + 1])
    ns_per_cycle = counted_ms * 1e6 / total
    print(f"{tree}: {lanes} x 16 KiB: K1 {plain_ms:.3f} ms, counted "
          f"{counted_ms:.3f} ms; slowest lane {slow}: {total} cycles, {events} events "
          f"({int(row[n + 2])} hits, {int(row[n + 4])} literal bytes, "
          f"{int(row[n + 3])} veto probes); {ns_per_cycle:.4f} ns a cycle",
          flush=True)
    split = {}
    for k, name in enumerate(PHASES):
        per_event = row[k] / events
        split[name] = {"cycles_per_event": per_event,
                       "share": row[k] / total}
        print(f"  {name:28s} {per_event:10.1f} cycles/event  "
              f"{100 * row[k] / total:5.1f} %", flush=True)
    print(f"  {'(all)':28s} {total / events:10.1f} cycles/event  "
          f"{total / events * ns_per_cycle:.1f} ns/event", flush=True)
    subs = {}
    for k, name in enumerate(SUBS):
        subs[name] = row[n + len(SLOTS) + k] / events
        print(f"    {name:32s} {subs[name]:10.1f} cycles/event", flush=True)
    mean = (arr[:, :n].sum(0) / arr[:, n + 1].sum()).tolist()
    return {
        "tree": str(tree), "lanes": lanes, "K1_ms": plain_ms,
        "counted_ms": counted_ms,
        "slowest_lane": slow, "cycles": total, "events": events,
        "hits": int(row[n + 2]), "veto_probes": int(row[n + 3]),
        "literal_bytes": int(row[n + 4]), "ns_per_cycle": ns_per_cycle,
        "cycles_per_event": total / events,
        "ns_per_event": total / events * ns_per_cycle,
        "leader_share": row[PHASES.index("leader chain")] / total,
        "split": split, "parts": subs,
        "mean_cycles_per_event_all_lanes": dict(zip(PHASES, mean)),
        "device": torch.cuda.get_device_name(0)}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(split_of(pathlib.Path(sys.argv[2]).resolve(),
                                  pathlib.Path(sys.argv[3]))), flush=True)
        return 0
    import torch

    print_card()
    if not torch.cuda.is_available():
        print("k1_phases: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    data_path = ROOT / "build" / "k1_phases_data.bin"
    data_path.parent.mkdir(parents=True, exist_ok=True)
    data_path.write_bytes(chip_smoke.corpus(LANES * BLOCK))
    for tree in sys.argv[1:] or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree,
                        str(data_path)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
