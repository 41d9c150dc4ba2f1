#!/usr/bin/env python3
"""Where a warm wave's extra time goes, on one NVIDIA GPU.

    python3 tools/warm_split.py

At 32 and 128 lanes of 16 KiB of ``chip_smoke.corpus`` (``X3Params()``,
``caps_for_block(16 KiB)``), with the seeds and tape
``compress(warm_start=True)`` trains on the wave: the K1 and K2 wrappers
seeded and warm (CUDA events around each call, median of 7, with the
host's wall time beside them), the scratch pass alone
(``driver._seeded_scratch``: the zeroing, the seeds and, warm, the warm
tables), the slowest lane's events and the events of each kind, the
stream bytes, and the replay and packing of the tape on the host.  The
kernels' own share is the wrapper's time less the scratch pass's.
"""

import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
RUNS = 7


def ev_ms(fn):
    """Median CUDA-event time and host wall time of ``fn``, in ms."""
    import torch

    ts, walls = [], []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        w = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - w) * 1e3)
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), statistics.median(walls)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("warm_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    import chip_smoke
    from x3tpu_torch import codec, host
    from x3tpu_torch import warm as wm
    from x3tpu_torch.config import X3Params
    from x3tpu_torch.parallel import blocks as blk
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.utils import corpus as mbc
    from x3tpu_torch.vm import driver

    driver.build()
    dev = torch.device("cuda", 0)
    params, caps = X3Params(), runtime.caps_for_block(16384)
    for lanes in (32, 128):
        blocks = blk.split_blocks(chip_smoke.corpus(lanes * 16384), 16384)
        strs, lens, tape = host.train_tape(mbc.warm_sample(blocks), params,
                                           min(256, caps.dict_cap // 2))
        seed_bytes = [strs[i, : lens[i]].tobytes() for i in range(len(lens))]
        tape, _ = wm.decode_tape(wm.encode_tape(tape))
        seeds = runtime.seeds_to_arrays(seed_bytes)
        t = time.perf_counter()
        state = wm.pack(wm.replay(tape, len(seed_bytes)))
        replay_ms = (time.perf_counter() - t) * 1e3
        text, tlen = (torch.from_numpy(a).to(dev)
                      for a in codec.pack_blocks(blocks, params, caps))
        for label, warm in (("seeded", None), ("warm", state)):
            enc = driver.encode_blocks_cuda(text, tlen, params, caps, seeds,
                                            warm)
            ev = int(enc[2].sum(1).max())
            k1 = ev_ms(lambda: driver.encode_blocks_cuda(
                text, tlen, params, caps, seeds, warm))
            words = torch.where(enc[0] >= 1 << 31, enc[0] - (1 << 32),
                                enc[0]).to(torch.int32)
            byte_lens = enc[1].to(torch.int32)
            k2 = ev_ms(lambda: driver.decode_blocks_cuda(
                words, byte_lens, caps, seeds, warm))
            scratch = ev_ms(lambda: driver._seeded_scratch(
                lanes, caps, dev, seeds, False, warm=warm))
            print(f"{lanes} lanes {label}: K1 {k1[0]:.3f} ms (host wall "
                  f"{k1[1]:.3f}), K2 {k2[0]:.3f} ms (wall {k2[1]:.3f}); "
                  f"scratch pass alone {scratch[0]:.3f} ms (wall "
                  f"{scratch[1]:.3f}); slowest lane {ev} events, K1 "
                  f"{k1[0] * 1e6 / ev:.1f} ns, K2 {k2[0] * 1e6 / ev:.1f} ns "
                  f"an event; events by kind {enc[2].sum(0).tolist()}; "
                  f"stream bytes {int(enc[1].sum())}", flush=True)
        print(f"{lanes} lanes: replay + pack on the host {replay_ms:.2f} ms; "
              f"tape {len(tape)} entries, {len(wm.encode_tape(tape))} B",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
