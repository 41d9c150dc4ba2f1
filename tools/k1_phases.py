#!/usr/bin/env python3
"""Where one lane of kernel K1 spends its cycles: per-phase ``clock64()``
counters, on one NVIDIA GPU.

    python3 tools/k1_phases.py [--blocks KIB[,KIB...]] [TREE ...]

For each block size (default 16 and 1024 KiB) and each checkout TREE of
the port (default: this one), in a process of its own that imports that
tree's ``x3tpu_torch``: builds its ``csrc/x3_encoder.cu`` once more with
``-DX3_PHASES`` (the main path's library never has the counters) into a
library of its own, encodes 32 blocks (the same bytes for every tree and
every checkout: ``tools/kernel_ab.py`` ``corpus_of``, 16 KiB blocks of
``chip_smoke.corpus``, larger ones of the ``c1m-records`` cell's records) at
``caps_for_block`` of the block and ``X3Params()``, checks that the
counted kernel gives the main path's words, and prints for the slowest
lane the cycles per event of each phase, the leader thread's share, and
the events; where the tree's K1 has a hash index of its dictionary
(dict_cap 4096 and up), the lookups it made and the slots they visited
(their ratio: the mean chain length); where its index model is a tree,
the cycles of the warp that reads it in pass 2, the hits that queried
it and the tree nodes read and written; then one JSON line.  The leader
reads the clock right after each of the CTA's barriers, so a phase's
cycles are the whole CTA's time in it.  Cycles convert to time at the
counted kernel's own rate (its CUDA-event time over the slowest lane's
cycles).
"""

import ctypes
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
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
# the hash index's counters (x3_core.cuh PH_HASH_*), in trees that have them
HASH = ("hash lookups", "hash slots visited")
# the index model tree's counters (x3_core.cuh PH_IX*), in trees that have
# them: the cycles of the index model's warp in pass 2, the hits that
# queried it, the nodes read and written
IX = ("index model (its warp, pass 2)", "index queries", "tree nodes")
LANES = 32
BLOCKS_KIB = (16, 1024)


def has_counter(tree: pathlib.Path, slot: str) -> bool:
    """Whether the tree's K1 has the phase slot ``slot`` (x3_core.cuh)."""
    core = tree / "x3tpu_torch" / "csrc" / "x3_core.cuh"
    return slot in core.read_text()


def corpus_bytes(block: int) -> bytes:
    """LANES blocks of ``block`` bytes, as the module's docstring says."""
    import kernel_ab

    return kernel_ab.corpus_of(block, LANES * block)


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


def split_of(tree: pathlib.Path, data_path: pathlib.Path, block: int) -> dict:
    """Count one tree's K1 on the wave of ``block``-byte blocks in
    ``data_path``."""
    sys.path.insert(0, str(tree))
    import torch
    from x3tpu_torch import X3Params, codec
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.vm import driver

    counted = build_counted()
    driver._bind_encoder(counted, phases=True)
    data = data_path.read_bytes()
    lanes = len(data) // block
    params, caps = X3Params(), runtime.caps_for_block(block)
    blocks = [data[i: i + block] for i in range(0, len(data), block)]
    text, tlen = codec.pack_blocks(blocks, params, caps)
    text, tlen = torch.from_numpy(text).cuda(), torch.from_numpy(tlen).cuda()
    hashed = has_counter(tree, "PH_HASH_LOOKUPS")
    ix_tree = hashed and has_counter(tree, "PH_IX_QUERIES")
    nslots = (len(PHASES) + len(SLOTS) + len(SUBS) + len(HASH) * hashed
              + len(IX) * ix_tree)
    ph = torch.zeros((lanes, nslots), dtype=torch.int64, device="cuda")

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
    print(f"{tree}: {lanes} x {block // 1024} KiB, dict_cap "
          f"{caps.dict_cap}: K1 {plain_ms:.3f} ms, counted "
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
    hash_counts = {}
    if hashed:
        at = n + len(SLOTS) + len(SUBS)
        lookups, visits = arr[:, at].sum(), arr[:, at + 1].sum()
        hash_counts = {
            "lookups_per_event": lookups / arr[:, n + 1].sum(),
            "slots_per_lookup": visits / max(lookups, 1),
            "slowest_lane_lookups": int(row[at]),
            "slowest_lane_slots": int(row[at + 1])}
        print(f"  hash index (all lanes): {hash_counts['lookups_per_event']:.2f}"
              f" lookups an event, {hash_counts['slots_per_lookup']:.3f} "
              f"slots a lookup (a lookup: one key, one lane)", flush=True)
    ix_counts = {}
    if ix_tree:
        at = n + len(SLOTS) + len(SUBS) + len(HASH)
        queries = int(row[at + 1])
        ix_counts = {
            "cycles_per_event": row[at] / events,
            "cycles_per_query": row[at] / max(queries, 1),
            "queries": queries, "nodes": int(row[at + 2]),
            "nodes_per_event": row[at + 2] / events}
        print(f"  {IX[0]:28s} {ix_counts['cycles_per_event']:10.1f} "
              f"cycles/event  {ix_counts['cycles_per_query']:.1f} a query; "
              f"{queries} queries, {ix_counts['nodes']} tree nodes read "
              f"and written ({ix_counts['nodes_per_event']:.2f} an event)",
              flush=True)
    mean = (arr[:, :n].sum(0) / arr[:, n + 1].sum()).tolist()
    return {
        "tree": str(tree), "block_bytes": block,
        "dict_cap": caps.dict_cap, "lanes": lanes, "K1_ms": plain_ms,
        "counted_ms": counted_ms,
        "slowest_lane": slow, "cycles": total, "events": events,
        "hits": int(row[n + 2]), "veto_probes": int(row[n + 3]),
        "literal_bytes": int(row[n + 4]), "ns_per_cycle": ns_per_cycle,
        "cycles_per_event": total / events,
        "ns_per_event": total / events * ns_per_cycle,
        "leader_share": row[PHASES.index("leader chain")] / total,
        "split": split, "parts": subs,
        "mean_cycles_per_event_all_lanes": dict(zip(PHASES, mean)),
        "hash_index": hash_counts, "index_model_tree": ix_counts,
        "device": torch.cuda.get_device_name(0)}


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print(json.dumps(split_of(pathlib.Path(args[1]).resolve(),
                                  pathlib.Path(args[2]), int(args[3]))),
              flush=True)
        return 0
    blocks = BLOCKS_KIB
    if args[:1] == ["--blocks"]:
        blocks = tuple(int(b) for b in args[1].split(","))
        args = args[2:]
    import torch

    print_card()
    if not torch.cuda.is_available():
        print("k1_phases: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    for kib in blocks:
        data_path = ROOT / "build" / f"k1_phases_data_{kib}k.bin"
        data_path.parent.mkdir(parents=True, exist_ok=True)
        data_path.write_bytes(corpus_bytes(kib * 1024))
        for tree in args or [str(ROOT)]:
            subprocess.run([sys.executable, __file__, "--one", tree,
                            str(data_path), str(kib * 1024)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
