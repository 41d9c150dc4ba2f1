#!/usr/bin/env python3
"""Where one lane of kernel K2 spends its cycles: per-phase ``clock64()``
counters, on one NVIDIA GPU.

    python3 tools/k2_phases.py [TREE ...]

For each checkout TREE of the port (default: this one), in a process of
its own that imports that tree's ``x3tpu_torch``: encodes 32 blocks of 16
KiB of this checkout's ``chip_smoke.corpus`` (the same bytes for every
tree) with K1 at ``caps_for_block(16 KiB)`` and ``X3Params()``, builds
its ``csrc/x3_decoder.cu`` once more with ``-DX3_DEC_PHASES`` (the main
path's library never has the counters) into a library of its own,
decodes the wave with it, checks that the counted kernel gives exactly
the main path's bytes, lengths, counts, sizes and flags, and prints for
the slowest lane the cycles per event of each phase, the events of each
kind and the lane's ns an event; then one JSON line.  Cycles convert to
time at the counted kernel's own rate (its CUDA-event time over the
slowest lane's cycles).

The slots are x3_dec_core.cuh's PHD_*: the phases of the leader's chain
(read by the leader thread), then the lane's cycles and events, then the
jobs of the other warps (each read by that warp's first thread; they run
beside the chain, so their cycles overlap it).
"""

import json
import pathlib
import subprocess
import sys

import k1_phases

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCK = 16 * 1024
LANES = 32
# x3_dec_core.cuh PHD_*, in order: the chain's phases, the lane's slots,
# then the other warps' jobs
PHASES = ("event symbol", "ctx0 id search", "row views and totals",
          "payload search", "the two finds", "leader's updates", "emit",
          "rank update", "literal path", "duplicate probe")
SLOTS = ("total", "events", "E_CTX0", "E_CTX1", "E_IDX1", "E_NEW")
CHAIN_WAITS = ("wait: ctx rows", "wait: dictionary")
JOBS = ("ctx0 warp: find + update", "ctx0 warp: wait for the id",
        "ctx0 warp: next row", "ctx1 warp: find, id + update",
        "ctx1 warp: next row", "dictionary warp: rank update",
        "dictionary warp: index model", "dictionary warp: bytes + sizes",
        "ctx1 warp: ctx0 id after a literal")
NSLOTS = len(PHASES) + len(SLOTS) + len(CHAIN_WAITS) + len(JOBS)


def split_of(tree: pathlib.Path, data_path: pathlib.Path) -> dict:
    """Count one tree's K2 on the wave in ``data_path``."""
    sys.path.insert(0, str(tree))
    import torch
    from x3tpu_torch import X3Params, codec
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.vm import driver

    counted = k1_phases.build_counted("decoder", "-DX3_DEC_PHASES",
                                      "k2phases")
    driver._bind_decoder(counted, phases=True)
    data = data_path.read_bytes()
    lanes = len(data) // BLOCK
    params, caps = X3Params(), runtime.caps_for_block(BLOCK)
    blocks = [data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]
    text, tlen = codec.pack_blocks(blocks, params, caps)
    text, tlen = torch.from_numpy(text).cuda(), torch.from_numpy(tlen).cuda()
    enc = driver.encode_blocks_cuda(text, tlen, params, caps)
    w = enc[0]
    words = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    lens = enc[1].to(torch.int32)
    ph = torch.zeros((lanes, NSLOTS), dtype=torch.int64, device="cuda")

    def plain_call():
        return driver.decode_blocks_cuda(words, lens, caps)

    def counted_call():
        ph.zero_()
        return driver._decode_with(words, lens, caps, lib=counted, phases=ph)

    ref, got = plain_call(), counted_call()
    for what, a, b in zip(("out", "out_lens", "counts", "sizes"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"the counted kernel's {what} differ")
    for f in ref[4]._fields:
        if not torch.equal(getattr(got[4], f), getattr(ref[4], f)):
            raise AssertionError(f"the counted kernel's flag {f} differs")
    if int(got[1].sum()) != int(tlen.sum()):
        raise AssertionError("K2 did not decode the wave")

    plain_ms = k1_phases.median_ms(plain_call)
    counted_ms = k1_phases.median_ms(counted_call)
    arr = ph.cpu().numpy()
    n = len(PHASES)
    slow = int(arr[:, n].argmax())
    row = arr[slow]
    total, events = int(row[n]), int(row[n + 1])
    kinds = {k: int(row[n + 2 + i]) for i, k in enumerate(SLOTS[2:])}
    ns_per_cycle = counted_ms * 1e6 / total
    print(f"{tree}: {lanes} x 16 KiB: K2 {plain_ms:.3f} ms, counted "
          f"{counted_ms:.3f} ms; slowest lane {slow}: {total} cycles, "
          f"{events} events {kinds}; {ns_per_cycle:.4f} ns a cycle; "
          f"{plain_ms * 1e6 / events:.1f} ns an event (main path's K2)",
          flush=True)
    split = {}
    names = PHASES + CHAIN_WAITS
    at = list(range(n)) + [n + len(SLOTS) + i for i in range(len(CHAIN_WAITS))]
    for name, k in zip(names, at):
        if not row[k]:  # a phase the tree's design does not have
            continue
        split[name] = {"cycles_per_event": row[k] / events,
                       "share": row[k] / total}
        print(f"  {name:36s} {row[k] / events:10.1f} cycles/event  "
              f"{100 * row[k] / total:5.1f} %", flush=True)
    print(f"  {'(all)':36s} {total / events:10.1f} cycles/event  "
          f"{total / events * ns_per_cycle:.1f} ns/event", flush=True)
    jobs = {}
    base = n + len(SLOTS) + len(CHAIN_WAITS)
    for i, name in enumerate(JOBS):
        if row[base + i]:
            jobs[name] = row[base + i] / events
            print(f"    {name:34s} {jobs[name]:10.1f} cycles/event "
                  f"(beside the chain)", flush=True)
    return {
        "tree": str(tree), "lanes": lanes, "K2_ms": plain_ms,
        "counted_ms": counted_ms, "slowest_lane": slow, "cycles": total,
        "events": events, "kinds": kinds, "ns_per_cycle": ns_per_cycle,
        "cycles_per_event": total / events,
        "ns_per_event": plain_ms * 1e6 / events,
        "split": split, "jobs": jobs,
        "device": torch.cuda.get_device_name(0)}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(split_of(pathlib.Path(sys.argv[2]).resolve(),
                                  pathlib.Path(sys.argv[3]))), flush=True)
        return 0
    import torch

    k1_phases.print_card()
    if not torch.cuda.is_available():
        print("k2_phases: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    data_path = ROOT / "build" / "k2_phases_data.bin"
    data_path.parent.mkdir(parents=True, exist_ok=True)
    data_path.write_bytes(chip_smoke.corpus(LANES * BLOCK))
    for tree in sys.argv[1:] or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree,
                        str(data_path)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
