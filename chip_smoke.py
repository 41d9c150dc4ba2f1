#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (x3tpu_torch) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``.  It
imports nothing of the JAX package.  In order, stopping with a non-zero
exit at the first failure:

1. environment, then the build of both kernels (csrc/x3_encoder.cu and
   csrc/x3_decoder.cu, one nvcc each, side by side);
2. the encoder kernel K1 against its plain PyTorch version on the card:
   the golden inputs of each golden paramset (the 20 golden streams byte
   for byte), small capacities where every overflow flag fires, magic
   factor 2, and a large dictionary (dict_cap 8192: K1 keeps every plane
   in global memory);
3. the decoder kernel K2 against its plain PyTorch version on the card:
   the 20 golden streams (each must give its input) and K1's tiny-caps
   streams, where the state flags fire while decoding;
4. corrupt streams (random bytes, a golden stream cut in half, zeros):
   K2 and the plain decoder end in the same error, and a decode after
   them still works;
5. seeded kernels: 256 dictionary seeds trained by the port's trainer on
   a strided sample of the corpus; K1 against the plain encoder at 8
   lanes of 4 KiB with every lane seeded, with the default shared-memory
   plan and at dict_cap 8192 (every plane in global memory), and K2
   against the plain decoder on those streams;
6. warm kernels: the seeds and warm-start tape the port's trainer gives
   on the 8 x 16 KiB blocks of x3tpu_torch.utils.corpus.warm_blocks
   (their sha256 the recorded ones); K1 against the plain encoder at 8
   lanes of 4 KiB with every lane warm, with the shared-memory plan
   holding the hubs and at dict_cap 8192 (every plane global), and K2
   against the plain decoder on those streams; K1's warm streams of the
   8 x 16 KiB blocks against x3tpu_torch/testdata/warm_streams.json
   (written by tools/mb_oracle.py --warm) and back through K2;
   ``compress(warm_start=True)`` and ``decompress`` at 32 and 128 lanes
   of 16 KiB, timed, with their ratio beside the seeded and unseeded
   ones on the same input; and one warm wave over a 2-entry mesh on
   cuda:0, twice, the one-device wave's streams;
7. the raw path: one 16 KiB block compressed to a raw stream and
   decompressed on the card, and the golden streams over 2 KiB decoded
   raw, at the capacities a raw decode picks (dict 16384-24576, 8192
   items a context: about 520 MiB of scratch a lane);
8. the main path at 32 and 128 lanes of 16 KiB, unseeded and with
   ``dict_seed=True``: ``x3tpu_torch.compress(..., device="cuda")`` then
   ``x3tpu_torch.decompress(..., device="cuda")``, each run with the
   launch counts set to 0 just before it and read just after: the data
   comes back, and the decoder's event counts equal the encoder's; then
   each main-path wave is encoded and decoded three more times, with
   every output equal to the first (K1's coder warp and K2's warps hand
   work to each other through shared memory, so a race would show as a
   difference);
9. the command line: ``python3 -m x3tpu_torch`` compresses and
   decompresses a 512 KiB file in 16 KiB blocks with ``--dict-seed`` and
   a 16 KiB file as one raw stream, each to the same bytes;
10. times: compress and decompress (unseeded and seeded), the seed
   trainer on the host, each kernel alone, and both plain versions
   against the kernels at 32 lanes of 4 KiB;
11. MB wave: 32 x 1 MiB of the MB corpus (x3tpu_torch.utils.corpus) at
   -t 15 -w 8 and caps_for_block(1 MiB) through compress and decompress:
   every stream equals the reference codec's (its length and sha256 in
   x3tpu_torch/testdata/mb_streams.json, written by tools/mb_oracle.py),
   and the blocks come back; one more encode and decode through the
   wrappers, timed, with equal streams;
12. MB 16 MiB caps: the first 8 of those blocks under
   caps_for_block(16 MiB), the same reference streams;
13. window 32 KiB: 32 x 256 KiB at -w 32 (dict 6144, 640 items) through
   compress (whose attempts at 640 and 1280 items overflow a context row
   and are retried) and decompress, the reference streams and back;
14. wave split: the MB wave with a device-memory budget of 8 lanes, 4
   launches each way, the one-launch wave's streams;
15. MB retry: the MB wave from dict_cap 8192, which some of its blocks
   outgrow (up to 9 706 entries), retried at caps.scaled(2), the
   reference streams;
16. MB command line: ``python3 -m x3tpu_torch`` on one 4 MiB file (one
   raw stream, K1 at dict 24576, retried once: more than 4096 ctx0 rows
   outgrow the small pool, and the retry doubles the pool of promoted
   rows; the decode at a raw stream's 64:1 guess, retried once) and on 32
   MiB in 1 MiB blocks (a container of 32 lanes), each the reference
   stream(s) and back byte for byte; then the 4 MiB lane alone through
   each kernel at the caps where it fits, timed;
17. mesh: the 32 x 16 KiB main-path wave through ``compress(mesh=)`` and
   ``decompress(mesh=)`` over every local card and over a 2-entry mesh
   (cuda:0 twice on a one-card machine, two streams side by side), each
   the one-device wave's streams, one K1 and one K2 launch a lane group,
   and the data back; then the MB wave over the 2-entry mesh with a
   budget of 8 lanes a launch (2 groups x 2 launches each way), the
   reference streams and the blocks back, timed beside phase 14's 4
   launches in series;
18. distributed: two processes (this script again, ``--dist-worker``),
   each on cuda:<rank % count>, joined over gloo on localhost, each
   encoding its half of a 64 x 16 KiB wave with K1; rank 0 gathers the
   payloads in lane order, which must be the one-process wave's, and K2
   decodes them back.  A failure of either process fails the script.

The last line is one JSON object, {"ok": true, "device": {...}}; the line
before it lists the kernels with their launches, errors, times and bounds.
"""

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import socket
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BLOCK = 16 * 1024
PLAIN_BLOCK = 4 * 1024              # the plain versions' depth
PLAIN_KIB = f"{PLAIN_BLOCK // 1024} KiB"
SEED_LANES = 8                      # lanes of the seeded kernels' check
SIZE_RTOL, SIZE_ATOL = 1e-5, 1e-3   # f32 size estimates (tests/test_vm.py)
HBM_BYTES_PER_S = 3.35e12           # H100 SXM peak device-memory rate


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def corpus(nbytes: int) -> bytes:
    """The repository's own text, in sorted path order, repeated to
    ``nbytes``."""
    paths = set()
    for pattern in ("x3tpu/**/*.py", "native/*.cpp", "tests/*.py", "*.md"):
        paths.update(ROOT.glob(pattern))
    text = b"".join(p.read_bytes() for p in sorted(paths))
    return (text * (nbytes // len(text) + 1))[:nbytes]


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    byte read once, each output byte written once) at its peak
    device-memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def dist_worker(rank: int, world: int, port: int, outdir: str) -> int:
    """Phase 18's process ``rank`` of ``world``: on cuda:<rank % count>,
    join the gloo group at localhost:``port``, encode lanes ``rank *
    64 / world`` on of the 64 x 16 KiB wave with K1, and gather every
    payload on rank 0, which decodes them with K2, checks the blocks and
    writes the payloads to ``outdir``.  Prints one JSON line of its
    numbers; any failure raises (a non-zero exit)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from x3tpu_torch.config import X3Params
    from x3tpu_torch.parallel import blocks as blk
    from x3tpu_torch.parallel import distributed, runtime
    from x3tpu_torch.vm import driver

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    if distributed.init_multihost(f"localhost:{port}", world, rank) != rank:
        raise AssertionError(f"rank {rank}: the group gave another rank")
    blocks = blk.split_blocks(corpus(64 * BLOCK), BLOCK)
    per = len(blocks) // world
    lo = rank * per
    caps = runtime.caps_for_block(BLOCK)
    t = time.perf_counter()
    res = runtime.encode_wave(blocks[lo : lo + per], X3Params(), caps,
                              device=dev)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    gathered = distributed.gather_payloads_in_order(res.payloads, lo,
                                                    len(blocks))
    gather_s = time.perf_counter() - t
    dec_s = None
    if rank == 0:
        t = time.perf_counter()
        back = runtime.decode_wave(gathered, [len(b) for b in blocks], caps,
                                   device=dev)
        dec_s = time.perf_counter() - t
        if back.payloads != blocks:
            raise AssertionError("rank 0: K2 did not give the blocks back")
        pathlib.Path(outdir, "payloads.json").write_text(json.dumps(
            [p.hex() for p in gathered]))
    elif gathered is not None:
        raise AssertionError(f"rank {rank}: gathered payloads off rank 0")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "device": str(dev), "lanes": per,
                      "launches": dict(driver.LAUNCHES), "encode_s": enc_s,
                      "gather_s": gather_s, "decode_s": dec_s}), flush=True)
    return 0


def main() -> int:
    import torch

    t0 = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    print(f"device {name} (count {torch.cuda.device_count()})", flush=True)

    sys.path.insert(0, str(ROOT))
    import numpy as np

    import x3tpu_torch
    from x3tpu_torch import codec, host
    from x3tpu_torch import warm as wm
    from x3tpu_torch.config import CodecCaps, X3Params
    from x3tpu_torch.parallel import blocks as blk
    from x3tpu_torch.parallel import mesh as meshmod
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.utils import corpus as mbc
    from x3tpu_torch.vm import driver

    phase("environment", t0)

    t0 = time.perf_counter()
    libs = driver.build()
    host._load()   # the seed trainer (g++)
    phase("build", t0)
    for kernel, lib in libs.items():
        print(f"built {kernel}: {lib.relative_to(ROOT)}", flush=True)
    for line in driver.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("["):
            print(f"ptxas: {line.strip()}", flush=True)

    max_err = {"encoder": 0.0, "decoder": 0.0}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def kernel_ms(fn, runs=3):
        """Median device time of a wrapper call (CUDA events; scratch and
        output allocation included)."""
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
        return statistics.median(times), times

    def same(label, kernel, ours, ref, names):
        """Kernel and plain results must agree: the integer outputs and the
        flags exactly, the f32 sizes within the tolerance."""
        for what, a, b in zip(names, ours, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {what} differ from the plain "
                                     f"version")
        err = (ours[3] - ref[3]).abs().max().item() if ours[3].numel() else 0.0
        if not torch.allclose(ours[3], ref[3], rtol=SIZE_RTOL, atol=SIZE_ATOL):
            raise AssertionError(f"{label}: sizes differ by {err}")
        max_err[kernel] = max(max_err[kernel], err)
        for f in ref[4]._fields:
            if not torch.equal(getattr(ours[4], f), getattr(ref[4], f)):
                raise AssertionError(f"{label}: overflow flag {f} differs")
        return err

    def against_plain(label, blocks, params, caps, seeds=None, warm=None):
        """K1 and the plain encoder on the same CUDA tensors (every lane
        from ``seeds`` and ``warm`` where given).  Returns the kernel's
        result and both times."""
        text, tlen = codec.pack_blocks(blocks, params, caps)
        text, tlen = torch.from_numpy(text).to(dev), torch.from_numpy(tlen).to(dev)
        ours, kernel_s = timed(
            lambda: driver.encode_blocks_cuda(text, tlen, params, caps, seeds,
                                              warm))
        ref, plain_s = timed(
            lambda: codec.encode_blocks_chunked(text, tlen, params, caps,
                                                seeds, warm))
        err = same(label, "encoder", ours, ref,
                   ("words", "byte_lens", "counts"))
        print(f"{label}: {len(blocks)} lanes match the plain encoder "
              f"(kernel {kernel_s:.3f} s, plain {plain_s:.3f} s, "
              f"max size err {err:.3g})", flush=True)
        return ours, kernel_s, plain_s

    def as_i32(words):
        """u32 values held in int64 -> the same bits as int32."""
        return torch.where(words >= 1 << 31, words - (1 << 32),
                           words).to(torch.int32)

    def pack_streams(streams):
        iw = max(1, max((len(s) + 3) // 4 for s in streams))
        words = np.zeros((len(streams), iw), np.uint32)
        for i, s in enumerate(streams):
            arr = np.frombuffer(s + b"\0" * (-len(s) % 4), "<u4")
            words[i, : len(arr)] = arr
        lens = np.array([len(s) for s in streams], np.int32)
        return (torch.from_numpy(words.view(np.int32)).to(dev),
                torch.from_numpy(lens).to(dev))

    def against_plain_dec(label, words, byte_lens, caps, seeds=None,
                          warm=None):
        """K2 and the plain decoder on the same CUDA tensors (``words``
        i32 [L, IW], the streams' u32 words; every lane from ``seeds`` and
        ``warm`` where given).  Returns the kernel's result and both
        times."""
        ours, kernel_s = timed(
            lambda: driver.decode_blocks_cuda(words, byte_lens, caps, seeds,
                                              warm))
        ref, plain_s = timed(lambda: codec.decode_blocks_chunked(
            words.to(torch.int64) & 0xFFFFFFFF, byte_lens.to(torch.int64),
            caps, seeds, warm))
        err = same(label, "decoder", ours, ref, ("out", "out_lens", "counts"))
        print(f"{label}: {words.shape[0]} lanes match the plain decoder "
              f"(kernel {kernel_s:.3f} s, plain {plain_s:.3f} s, "
              f"max size err {err:.3g})", flush=True)
        return ours, kernel_s, plain_s

    # ------------------------------------------------ 2. K1 against plain
    t0 = time.perf_counter()
    golden = ROOT / "tests" / "golden"
    names = sorted(p.stem for p in golden.glob("*.bin"))
    inputs = [(golden / f"{n}.bin").read_bytes() for n in names]
    paramsets = {
        "t15_w8": X3Params(max_match_count=15, window=8 * 1024),
        "t4_w1": X3Params(max_match_count=4, window=1024),
        "t2_w1_x": X3Params(max_match_count=2, window=1024, nl_remap=True),
        "t8_w2_m0": X3Params(max_match_count=8, window=2 * 1024,
                             magic_factor1=0),
    }
    small = CodecCaps(dict_cap=1 << 10, pair_cap=1 << 13, ctx_items_cap=192,
                      block_bytes=1 << 15)
    golden_cases = []   # (stream, input) of every golden .x3
    for pname, params in paramsets.items():
        # the inputs with a golden stream under this paramset
        refs = [(n, data, golden / f"{n}.{pname}.x3")
                for n, data in zip(names, inputs)
                if (golden / f"{n}.{pname}.x3").exists()]
        out, _, _ = against_plain(f"golden {pname}", [d for _, d, _ in refs],
                                  params, small)
        streams = codec.streams_from_words(out[0], out[1], len(refs))
        for (n, data, ref), stream in zip(refs, streams):
            if stream != ref.read_bytes():
                raise AssertionError(f"{n}.{pname}: not the golden stream")
            golden_cases.append((stream, data))
    if len(golden_cases) != 20:
        raise AssertionError(f"{len(golden_cases)} golden streams checked, "
                             f"want 20")
    print("golden: 20 streams byte-identical", flush=True)

    # tests/test_vm.py's six blocks and, between two of them, random bytes
    # whose stream outgrows the output buffer (out_words = block_bytes / 4
    # at factor 1): every overflow flag fires, and the lanes beside the one
    # whose words are dropped must keep theirs
    text_small = (golden / "text_small.bin").read_bytes()
    rng = np.random.default_rng(7)
    vm_blocks = [b"abracadabra " * 40, b"", text_small[:1200],
                 rng.integers(0, 256, 400, np.uint8).tobytes(), b"A",
                 b"\x00" * 1200]
    vm_blocks.insert(3, np.random.default_rng(8).integers(
        0, 256, 900, np.uint8).tobytes())
    tiny = CodecCaps(dict_cap=128, pair_cap=256, ctx_items_cap=24,
                     ctx0_items_cap=24, ctx_small_cap=8, ctx_promo_rows=4,
                     block_bytes=1200, out_words_factor=1)
    tiny_out, _, _ = against_plain("tiny caps", vm_blocks,
                                   X3Params(max_match_count=4, window=256),
                                   tiny)
    fired = {f: getattr(tiny_out[4], f).nonzero().flatten().tolist()
             for f in tiny_out[4]._fields}
    if not all(fired.values()) or fired["out"] != [3]:
        raise AssertionError(f"tiny caps: lanes flagged {fired}, want every "
                             f"flag to fire and out on lane 3 alone")
    print(f"tiny caps: lanes flagged: {fired}", flush=True)
    against_plain("magic_factor2=2",
                  [text_small, inputs[names.index("c_source")][:PLAIN_BLOCK]],
                  X3Params(magic_factor2=2), small)
    # K1's shared-memory plan leaves the dictionary (and every other plane)
    # in global memory at dict_cap 8192; the streams stay the golden ones
    wide = dataclasses.replace(small, dict_cap=8192)
    plan = driver.smem_plan(paramsets["t15_w8"], wide)
    if "strs" in plan.offsets:
        raise AssertionError(f"dict_cap 8192: the plan holds the strings "
                             f"({plan})")
    pair = ["text_tiny", "text_small"]
    out, _, _ = against_plain("dictionary in global memory",
                              [inputs[names.index(n)] for n in pair],
                              paramsets["t15_w8"], wide)
    for n, stream in zip(pair, codec.streams_from_words(out[0], out[1], 2)):
        if stream != (golden / f"{n}.t15_w8.x3").read_bytes():
            raise AssertionError(f"dictionary in global memory: {n} is not "
                                 f"the golden stream")
    print(f"dictionary in global memory: 2 golden streams byte-identical "
          f"(shared memory holds {sorted(plan.offsets)}, {plan.nbytes} B)",
          flush=True)
    phase("K1 vs plain", t0)

    # ------------------------------------------------ 3. K2 against plain
    t0 = time.perf_counter()
    words, byte_lens = pack_streams([s for s, _ in golden_cases])
    out, _, _ = against_plain_dec("golden streams", words, byte_lens, small)
    for i, (_, data) in enumerate(golden_cases):
        if out[0][i, : out[1][i]].cpu().numpy().tobytes() != data:
            raise AssertionError(f"golden stream {i} does not decode to its "
                                 f"input")
    print("golden: 20 streams decode to their inputs", flush=True)
    # K1's tiny-caps streams as the encoder left them: lane 3's lost its
    # tail to the output overflow (byte_lens counts past the buffer)
    tiny_dec, _, _ = against_plain_dec(
        "tiny caps streams", as_i32(tiny_out[0]), tiny_out[1].to(torch.int32),
        tiny)
    fired = {f: getattr(tiny_dec[4], f).nonzero().flatten().tolist()
             for f in tiny_dec[4]._fields}
    if not all(fired[f] for f in ("dict", "ctx0", "ctx1", "pairs")):
        raise AssertionError(f"tiny caps decode: lanes flagged {fired}, "
                             f"want the four state flags to fire")
    print(f"tiny caps decode: lanes flagged: {fired}", flush=True)
    phase("K2 vs plain", t0)

    # ------------------------------------------------- 4. corrupt streams
    t0 = time.perf_counter()
    half = (golden / "text_small.t15_w8.x3").read_bytes()
    corrupt = {
        # random bytes and zeros decode to events that emit nothing; at a
        # 1 KiB block the event bound ends them
        "random": (np.random.default_rng(11).integers(
            0, 256, 4096, np.uint8).tobytes(), 4096, 1024),
        "zeros": (bytes(64), 4096, 1024),
        # the first half decodes, then the rest is read past the end
        "half": (half[: len(half) // 2], len(text_small), len(text_small)),
    }

    def outcome(blob, device):
        try:
            return f"returned {len(runtime.decompress(blob, device=device))} bytes"
        except (ValueError, codec.X3CapacityError) as e:
            return f"{type(e).__name__}: {e}"

    for label, (stream, orig, block) in corrupt.items():
        blob = blk.pack_container([stream], [orig], block)
        got, kernel_s = timed(lambda: outcome(blob, "cuda"))
        want, plain_s = timed(lambda: outcome(blob, "cpu"))
        if got != want or got.startswith("returned"):
            raise AssertionError(f"corrupt {label}: K2 {got!r}, plain "
                                 f"decoder {want!r}")
        print(f"corrupt {label}: both raise {got!r} (K2 {kernel_s:.3f} s, "
              f"plain on the host CPU {plain_s:.3f} s)", flush=True)
    stream, data = golden_cases[-1]
    if x3tpu_torch.decompress(stream, device="cuda") != data:
        raise AssertionError("a decode after the corrupt streams failed")
    print("a decode after the corrupt streams succeeds", flush=True)
    phase("corrupt streams", t0)

    # ---------------------------------------------------- 5. seeded kernels
    t0 = time.perf_counter()
    shapes = (32, 128)
    data = {lanes: corpus(lanes * BLOCK) for lanes in shapes}
    caps = runtime.caps_for_block(BLOCK)
    params = X3Params()

    def train(blob):
        """compress(dict_seed=True)'s seeds for ``blob``: a strided sample
        (the head of each block), at most dict_cap / 2 seeds."""
        parts = blk.split_blocks(blob, BLOCK)
        per = 64 * 1024 // len(parts)
        strs, lens = host.train_seeds(b"".join(p[:per] for p in parts),
                                      params, min(256, caps.dict_cap // 2))
        seed_bytes = [strs[i, : lens[i]].tobytes() for i in range(len(lens))]
        return runtime.seeds_to_arrays(seed_bytes)

    seeds, train_s = timed(lambda: train(data[32]))
    k_seeds = len(seeds[1])
    if k_seeds != 256:
        raise AssertionError(f"{k_seeds} seeds trained, want 256")
    print(f"seeds: {k_seeds} trained on the host in {train_s:.3f} s",
          flush=True)
    seed_blocks = [p[:PLAIN_BLOCK] for p in
                   blk.split_blocks(data[32], BLOCK)[:SEED_LANES]]
    seeded_out, _, _ = against_plain(f"seeded K1 {SEED_LANES} x {PLAIN_KIB}",
                                     seed_blocks, params, caps, seeds)
    wide_caps = dataclasses.replace(caps, dict_cap=8192)
    if "strs" in driver.smem_plan(params, wide_caps).offsets:
        raise AssertionError("dict_cap 8192: the plan holds the strings")
    wide_out, _, _ = against_plain(
        f"seeded K1 {SEED_LANES} x {PLAIN_KIB}, dictionary in global memory",
        seed_blocks, params, wide_caps, seeds)
    for got in (seeded_out, wide_out):
        if got[4].any_flag().any():
            raise AssertionError("seeded K1: a lane overflowed")
    if not torch.equal(seeded_out[0], wide_out[0]):
        raise AssertionError("seeded K1: the streams depend on dict_cap")
    words, byte_lens = as_i32(seeded_out[0]), seeded_out[1].to(torch.int32)
    dec, _, _ = against_plain_dec(f"seeded K2 {SEED_LANES} x {PLAIN_KIB}",
                                  words, byte_lens, caps, seeds)
    for i, b in enumerate(seed_blocks):
        if dec[0][i, : dec[1][i]].cpu().numpy().tobytes() != b:
            raise AssertionError(f"seeded K2: block {i} does not round trip")
    if not torch.equal(dec[2], seeded_out[2]):
        raise AssertionError("seeded K2: event counts differ from K1's")
    unseeded = driver.encode_blocks_cuda(
        *(torch.from_numpy(a).to(dev)
          for a in codec.pack_blocks(seed_blocks, params, caps)),
        params, caps)
    print(f"seeded kernels: {SEED_LANES} x {PLAIN_KIB} in "
          f"{int(seeded_out[1].sum())} stream bytes seeded, "
          f"{int(unseeded[1].sum())} unseeded; hits by index rank "
          f"{int(seeded_out[2][:, 2].sum())} seeded, "
          f"{int(unseeded[2][:, 2].sum())} unseeded", flush=True)
    phase("seeded kernels vs plain", t0)

    # ------------------------------------------------------ 6. warm kernels
    t0 = time.perf_counter()
    warm_ref = json.loads(mbc.WARM_ORACLE.read_text())

    def train_warm(blocks):
        """compress(warm_start=True)'s seeds, tape and warm state for
        ``blocks``: the strided sample, at most dict_cap / 2 seeds, the
        tape through its container bytes."""
        strs, lens, tape = host.train_tape(mbc.warm_sample(blocks), params,
                                           min(256, caps.dict_cap // 2))
        seed_bytes = [strs[i, : lens[i]].tobytes() for i in range(len(lens))]
        tape, _ = wm.decode_tape(wm.encode_tape(tape))
        return (seed_bytes, tape, runtime.seeds_to_arrays(seed_bytes),
                wm.pack(wm.replay(tape, len(seed_bytes))))

    warm_blocks = mbc.warm_blocks()
    (wseed_bytes, wtape, wseeds, wstate), wtrain_s = timed(
        lambda: train_warm(warm_blocks))
    digests = mbc.warm_digests(wseed_bytes, wtape)
    if digests != {k: warm_ref[k] for k in digests}:
        raise AssertionError("warm: the trained seeds or tape are not the "
                             "recorded ones")
    print(f"warm: {len(wseed_bytes)} seeds and a tape of {len(wtape)} "
          f"entries trained on the host in {wtrain_s:.3f} s (the recorded "
          f"sha256); {wstate.pair_n} pairs, hubs of "
          f"{len(wstate.hub0_tags)} and {len(wstate.hub1_tags)} items, "
          f"{len(wstate.ctx0_idx)} ctx0 and {len(wstate.ctx1_idx)} ctx1 "
          f"rows", flush=True)
    hubs = {"f1_hub_tags", "f1_hub_freqs", "f1_hub_pair", "f0_hub_tags",
            "f0_hub_freqs", "f1_n"}
    if not hubs <= set(driver.smem_plan(params, caps).offsets):
        raise AssertionError("warm: the plan does not hold the hubs in "
                             "shared memory")
    if len(warm_blocks) != SEED_LANES:
        raise AssertionError(f"warm: {len(warm_blocks)} blocks, want "
                             f"{SEED_LANES}")
    warm_in = [b[:PLAIN_BLOCK] for b in warm_blocks]
    warm_out, _, _ = against_plain(
        f"warm K1 {SEED_LANES} x {PLAIN_KIB}, hubs in shared memory",
        warm_in, params, caps, wseeds, wstate)
    # the plain encoder's output depends on the capacities only through
    # its flags, which equal K1's here (none): the dict-8192 K1 run is
    # held to the same plain result, once more on the same inputs
    wide_run = driver.encode_blocks_cuda(
        *(torch.from_numpy(a).to(dev)
          for a in codec.pack_blocks(warm_in, params, wide_caps)),
        params, wide_caps, wseeds, wstate)
    same(f"warm K1 {SEED_LANES} x {PLAIN_KIB}, every plane global",
         "encoder", wide_run, warm_out, ("words", "byte_lens", "counts"))
    if warm_out[4].any_flag().any():
        raise AssertionError("warm K1: a lane overflowed")
    print(f"warm K1 {SEED_LANES} x {PLAIN_KIB}, every plane global "
          f"(dict_cap 8192): the same streams, counts and flags", flush=True)
    words, byte_lens = as_i32(warm_out[0]), warm_out[1].to(torch.int32)
    wdec, _, _ = against_plain_dec(f"warm K2 {SEED_LANES} x {PLAIN_KIB}",
                                   words, byte_lens, caps, wseeds, wstate)
    for i, b in enumerate(warm_in):
        if wdec[0][i, : wdec[1][i]].cpu().numpy().tobytes() != b:
            raise AssertionError(f"warm K2: block {i} does not round trip")
    if not torch.equal(wdec[2], warm_out[2]):
        raise AssertionError("warm K2: event counts differ from K1's")
    # the recorded reference: 8 x 16 KiB, K1 on the card
    text, tlen = (torch.from_numpy(a).to(dev)
                  for a in codec.pack_blocks(warm_blocks, params, caps))
    wenc = driver.encode_blocks_cuda(text, tlen, params, caps, wseeds, wstate)
    wstreams = codec.streams_from_words(wenc[0], wenc[1], len(warm_blocks))
    for i, (got, ref) in enumerate(zip(wstreams, warm_ref["streams"])):
        if (len(got) != ref["len"]
                or hashlib.sha256(got).hexdigest() != ref["sha256"]):
            raise AssertionError(f"warm K1: stream {i} ({len(got)} B) is "
                                 f"not the reference stream "
                                 f"({ref['len']} B)")
    words, byte_lens = pack_streams(wstreams)
    wback = driver.decode_blocks_cuda(words, byte_lens, caps, wseeds, wstate)
    for i, b in enumerate(warm_blocks):
        if wback[0][i, : wback[1][i]].cpu().numpy().tobytes() != b:
            raise AssertionError(f"warm K2: 16 KiB block {i} does not "
                                 f"round trip")
    if not torch.equal(wback[2], wenc[2]):
        raise AssertionError("warm K2: 16 KiB event counts differ")
    plain_seeded = driver.encode_blocks_cuda(text, tlen, params, caps,
                                             wseeds)
    print(f"warm K1 {len(warm_blocks)} x 16 KiB: the {len(wstreams)} "
          f"reference streams ({sum(map(len, wstreams))} B; seeds alone "
          f"{int(plain_seeded[1].sum())} B), and back through K2",
          flush=True)

    # compress(warm_start=True) and decompress at the main path's shapes,
    # each run with the counts set to 0 just before it and read after
    warm_rows, warm_launches = {}, {"encoder": 0, "decoder": 0}
    warm_blobs = {}
    for lanes in shapes:
        row, enc_stats = {}, []
        for what, fn in (
                ("compress", lambda: x3tpu_torch.compress(
                    data[lanes], block_bytes=BLOCK, lanes_per_device=lanes,
                    warm_start=True, stats_out=enc_stats, device="cuda")),
                ("trainer", lambda: train_warm(
                    blk.split_blocks(data[lanes], BLOCK)))):
            runs = []
            for _ in range(3):
                driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
                out, secs = timed(fn)
                runs.append(secs)
                if what == "compress":
                    if driver.LAUNCHES["encoder"] < 1:
                        raise AssertionError(f"warm compress {lanes}: no K1 "
                                             f"launch")
                    warm_launches["encoder"] += driver.LAUNCHES["encoder"]
                    warm_blobs[lanes] = out
            row[what], row[what + "_runs"] = statistics.median(runs), runs
        blob = warm_blobs[lanes]
        payloads, _, _, seed_bytes, tape = blk.unpack_container(blob)
        if not seed_bytes or not tape or len(payloads) != lanes:
            raise AssertionError(f"warm compress {lanes}: container without "
                                 f"seeds or tape")
        runs = []
        for _ in range(3):
            dec_stats = []
            driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
            back, secs = timed(lambda: x3tpu_torch.decompress(
                blob, lanes_per_device=lanes, stats_out=dec_stats,
                device="cuda"))
            runs.append(secs)
            if back != data[lanes] or driver.LAUNCHES["decoder"] < 1:
                raise AssertionError(f"warm decompress {lanes}: "
                                     f"{len(back)} B in "
                                     f"{driver.LAUNCHES['decoder']} K2 "
                                     f"launches")
            warm_launches["decoder"] += driver.LAUNCHES["decoder"]
        row["decompress"], row["decompress_runs"] = (statistics.median(runs),
                                                     runs)
        if not np.array_equal(enc_stats[-1].events, dec_stats[0].events):
            raise AssertionError(f"warm {lanes}: decode counts differ from "
                                 f"encode counts")
        sizes = {kind: len(x3tpu_torch.compress(
            data[lanes], block_bytes=BLOCK, lanes_per_device=lanes,
            dict_seed=kind == "seeded", device="cuda"))
            for kind in ("unseeded", "seeded")}
        row["ratio"] = len(blob) / len(data[lanes])
        row["ratio_seeded"] = sizes["seeded"] / len(data[lanes])
        row["ratio_unseeded"] = sizes["unseeded"] / len(data[lanes])
        # the kernels alone on the wave, warm
        lstate = train_warm(blk.split_blocks(data[lanes], BLOCK))
        text, tlen = (torch.from_numpy(a).to(dev) for a in codec.pack_blocks(
            blk.split_blocks(data[lanes], BLOCK), params, caps))
        row["K1"], row["K1_runs"] = kernel_ms(
            lambda: driver.encode_blocks_cuda(text, tlen, params, caps,
                                              lstate[2], lstate[3]))
        words, byte_lens = pack_streams(payloads)
        row["K2"], row["K2_runs"] = kernel_ms(
            lambda: driver.decode_blocks_cuda(words, byte_lens, caps,
                                              lstate[2], lstate[3]))
        warm_rows[lanes] = row
        mb = len(data[lanes]) / 1e6
        print(f"warm {lanes} x 16 KiB: compress {row['compress']:.4f} s "
              f"({mb / row['compress']:.3f} MB/s, the trainer's "
              f"{row['trainer']:.4f} s on the host included), decompress "
              f"{row['decompress']:.4f} s ({mb / row['decompress']:.3f} "
              f"MB/s); K1 {row['K1']:.3f} ms, K2 {row['K2']:.3f} ms; ratio "
              f"{row['ratio']:.4f} (seeds alone {row['ratio_seeded']:.4f}, "
              f"unseeded {row['ratio_unseeded']:.4f}); runs "
              f"{[round(r, 4) for r in row['compress_runs']]} / "
              f"{[round(r, 4) for r in row['decompress_runs']]} / "
              f"{[round(r, 4) for r in row['trainer_runs']]} s, "
              f"{[round(r, 3) for r in row['K1_runs']]} / "
              f"{[round(r, 3) for r in row['K2_runs']]} ms", flush=True)

    # one warm wave over two entries on cuda:0 (two streams), twice
    two = meshmod.make_mesh(devices=["cuda:0", "cuda:0"])
    blocks32 = blk.split_blocks(data[32], BLOCK)
    lstate = train_warm(blocks32)
    one_dev = runtime.encode_wave(blocks32, params, caps, device="cuda",
                                  seeds=lstate[2], warm=lstate[3]).payloads
    if one_dev != blk.unpack_container(warm_blobs[32])[0]:
        raise AssertionError("warm wave: not compress's payloads")
    warm_mesh_launches = {"encoder": 0, "decoder": 0}
    for run in range(2):
        driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
        res = runtime.encode_wave(blocks32, params, caps, device="cuda",
                                  seeds=lstate[2], mesh=two, warm=lstate[3])
        back = runtime.decode_wave(res.payloads, [len(b) for b in blocks32],
                                   caps, device="cuda", seeds=lstate[2],
                                   mesh=two, warm=lstate[3])
        if res.payloads != one_dev or back.payloads != blocks32:
            raise AssertionError(f"warm mesh run {run}: the streams differ "
                                 f"from one device's, or do not come back")
        if driver.LAUNCHES != {"encoder": 2, "decoder": 2}:
            raise AssertionError(f"warm mesh run {run}: launches "
                                 f"{driver.LAUNCHES}, want 2 each way")
        for k in warm_mesh_launches:
            warm_mesh_launches[k] += driver.LAUNCHES[k]
    print(f"warm mesh over {[str(d) for d in two.devices]}: two runs of "
          f"32 x 16 KiB, 2 lane groups each way, the one-device streams "
          f"and the blocks back", flush=True)
    phase("warm kernels vs plain", t0)

    # ------------------------------------------------------- 7. raw path
    t0 = time.perf_counter()

    def raw_caps(stream):
        """The capacities decompress picks for a raw stream."""
        return runtime.caps_for_block(max(64 * len(stream), 1 << 16))

    one = data[32][:BLOCK]
    driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
    raw = x3tpu_torch.compress(one, device="cuda")
    if blk.is_container(raw) or driver.LAUNCHES["encoder"] != 1:
        raise AssertionError("raw path: compress of one block is not one "
                             "raw stream from K1")
    raw_cases = [("one 16 KiB block", raw, one)] + [
        (f"{n}.t4_w1.x3", (golden / f"{n}.t4_w1.x3").read_bytes(),
         (golden / f"{n}.bin").read_bytes())
        for n in ("c_source", "binary_mixed", "random_2k")]
    for label, stream, want in raw_cases:
        rc = raw_caps(stream)
        driver.LAUNCHES["decoder"] = 0
        back, dec_s = timed(lambda: x3tpu_torch.decompress(stream,
                                                           device="cuda"))
        if back != want or driver.LAUNCHES["decoder"] != 1:
            raise AssertionError(f"raw path {label}: decompress gave "
                                 f"{len(back)} bytes in "
                                 f"{driver.LAUNCHES['decoder']} launches")
        words, byte_lens = pack_streams([stream])
        wrapper_ms, _ = kernel_ms(
            lambda: driver.decode_blocks_cuda(words, byte_lens, rc))
        print(f"raw path {label}: {len(stream)} B stream -> {len(want)} B "
              f"at dict {rc.dict_cap}, items {rc.ctx_items_cap}, block "
              f"{rc.block_bytes}; scratch "
              f"{driver.scratch_words(rc) * 4 / 2**20:.2f} MiB a lane; "
              f"decompress {dec_s:.4f} s, K2 wrapper {wrapper_ms:.3f} ms",
              flush=True)
    phase("raw path", t0)

    # ---------------------------------------------------------- 8. main path
    t0 = time.perf_counter()
    launches = {"encoder": 0, "decoder": 0}
    results = {}
    for lanes in shapes:
        for seeded in (False, True):
            enc_stats, dec_stats = [], []
            driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
            blob = x3tpu_torch.compress(data[lanes], block_bytes=BLOCK,
                                        lanes_per_device=lanes,
                                        dict_seed=seeded,
                                        stats_out=enc_stats, device="cuda")
            n_enc = driver.LAUNCHES["encoder"]
            driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
            back = x3tpu_torch.decompress(blob, lanes_per_device=lanes,
                                          stats_out=dec_stats, device="cuda")
            n_dec = driver.LAUNCHES["decoder"]
            if n_enc < 1 or n_dec < 1:
                raise AssertionError(f"{lanes} lanes, seeded {seeded}: "
                                     f"launches {n_enc} (K1), {n_dec} (K2) "
                                     f"on the main path")
            launches["encoder"] += n_enc
            launches["decoder"] += n_dec
            results[lanes, seeded] = (blob, back, enc_stats[0], dec_stats[0])
    phase("main path", t0)

    t0 = time.perf_counter()

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    ratios = {}
    for lanes in shapes:
        for seeded in (False, True):
            blob, back, enc_stats, dec_stats = results[lanes, seeded]
            label = f"main path {lanes} x 16 KiB{', seeded' if seeded else ''}"
            if back != data[lanes]:
                raise AssertionError(f"{label}: decompress(compress(data)) "
                                     f"is not the data")
            if not np.array_equal(enc_stats.events, dec_stats.events):
                raise AssertionError(f"{label}: decode counts "
                                     f"{dec_stats.events} != encode counts "
                                     f"{enc_stats.events}")
            payloads, orig_lens, _, seed_bytes, _ = blk.unpack_container(
                blob)
            if (len(payloads) != lanes or bool(seed_bytes) != seeded
                    or blob != blk.pack_container(payloads, orig_lens, BLOCK,
                                                  seeds=seed_bytes)):
                raise AssertionError(f"{label}: container framing differs")
            wave_seeds = (runtime.seeds_to_arrays(seed_bytes) if seeded
                          else None)
            ratios[lanes, seeded] = len(blob) / len(data[lanes])
            print(f"{label}: {lanes} blocks round trip, event counts "
                  f"{enc_stats.events.tolist()} both ways; ratio "
                  f"{ratios[lanes, seeded]:.4f}"
                  + (f" (unseeded {ratios[lanes, False]:.4f}, "
                     f"{len(seed_bytes)} seeds)" if seeded else ""),
                  flush=True)
            # the race checks: each wave three more times through each
            # kernel, every output equal to the first
            text, tlen = codec.pack_blocks(
                blk.split_blocks(data[lanes], BLOCK), params, caps)
            text, tlen = (torch.from_numpy(text).to(dev),
                          torch.from_numpy(tlen).to(dev))
            encs = [driver.encode_blocks_cuda(text, tlen, params, caps,
                                              wave_seeds) for _ in range(3)]
            hashes = {digest(e[0], e[1], e[2], e[3]) for e in encs}
            if len(hashes) != 1 or codec.streams_from_words(
                    encs[0][0], encs[0][1], lanes) != payloads:
                raise AssertionError(f"{label}: three encodes differ "
                                     f"({sorted(hashes)})")
            words, byte_lens = pack_streams(payloads)
            runs = [driver.decode_blocks_cuda(words, byte_lens, caps,
                                              wave_seeds) for _ in range(3)]
            for i, run in enumerate(runs[1:], 2):
                same(f"{label}, decode {i}", "decoder", run, runs[0],
                     ("out", "out_lens", "counts"))
                if not torch.equal(run[3], runs[0][3]):
                    raise AssertionError(f"{label}: decode {i}'s sizes "
                                         f"differ from the first's")
            print(f"{label}: three encodes identical (hash "
                  f"{hashes.pop()}), three decodes identical", flush=True)
    phase("main path checks", t0)

    # ---------------------------------------------------- 9. command line
    t0 = time.perf_counter()
    cli_dir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli_dir.mkdir(parents=True)
    cli_cases = {"corpus.bin": (data[32], ["--block-size", "16",
                                           "--dict-seed"]),
                 "block.bin": (data[32][:BLOCK], [])}
    for fname, (blob, flags) in cli_cases.items():
        src = cli_dir / fname
        src.write_bytes(blob)
        for argv in (["-z", *flags, str(src)], ["-d", "-f", f"{src}.x3"]):
            r = subprocess.run([sys.executable, "-m", "x3tpu_torch", *argv],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cli {argv}: exit {r.returncode}\n"
                                     f"{r.stderr[-3000:]}")
            print(f"cli {' '.join(argv[:-1])} {fname}:", flush=True)
            for line in r.stderr.splitlines():
                print(f"  {line}", flush=True)
            if argv[0] == "-z":
                packed = pathlib.Path(f"{src}.x3").read_bytes()
                if blk.is_container(packed) != bool(flags):
                    raise AssertionError(f"cli {fname}: container "
                                         f"{blk.is_container(packed)}")
        if src.read_bytes() != blob:
            raise AssertionError(f"cli {fname}: -d did not give the input "
                                 f"back")
        print(f"cli {fname}: {len(blob)} B round trip through "
              f"{len(packed)} B", flush=True)
    shutil.rmtree(cli_dir)
    phase("command line", t0)

    # --------------------------------------------------------------- 10. times
    t0 = time.perf_counter()
    print(smi.stdout.strip(), flush=True)   # the card beside every time
    lane_mib = driver.scratch_words(caps) * 4 / 2**20
    print(f"device state per lane: {lane_mib:.2f} MiB of scratch "
          f"(caps {caps})", flush=True)

    timing, bounds = {}, {}
    for lanes in shapes:
        blob = results[lanes, False][0]
        seeded_blob = results[lanes, True][0]
        row = {}
        for what, fn in (
                ("compress", lambda: x3tpu_torch.compress(
                    data[lanes], block_bytes=BLOCK, lanes_per_device=lanes,
                    device="cuda")),
                ("decompress", lambda: x3tpu_torch.decompress(
                    blob, lanes_per_device=lanes, device="cuda")),
                ("seeded_compress", lambda: x3tpu_torch.compress(
                    data[lanes], block_bytes=BLOCK, lanes_per_device=lanes,
                    dict_seed=True, device="cuda")),
                ("seeded_decompress", lambda: x3tpu_torch.decompress(
                    seeded_blob, lanes_per_device=lanes, device="cuda")),
                ("trainer", lambda: train(data[lanes]))):
            runs = [timed(fn)[1] for _ in range(3)]
            row[what] = statistics.median(runs)
            row[what + "_runs"] = runs
        text, tlen = codec.pack_blocks(blk.split_blocks(data[lanes], BLOCK),
                                       params, caps)
        text, tlen = torch.from_numpy(text).to(dev), torch.from_numpy(tlen).to(dev)
        torch.cuda.reset_peak_memory_stats()
        enc = driver.encode_blocks_cuda(text, tlen, params, caps)
        row["K1"], row["K1_runs"] = kernel_ms(
            lambda: driver.encode_blocks_cuda(text, tlen, params, caps))
        # a wave takes its slowest lane's time: the lane with most events
        row["events_slowest_lane"] = int(enc[2].sum(1).max())
        payloads = blk.unpack_container(blob)[0]
        words, byte_lens = pack_streams(payloads)
        dec = driver.decode_blocks_cuda(words, byte_lens, caps)
        row["K2"], row["K2_runs"] = kernel_ms(
            lambda: driver.decode_blocks_cuda(words, byte_lens, caps))
        row["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        # the same wave seeded: K1 on the same text, K2 on its streams
        seed_bytes = blk.unpack_container(seeded_blob)[3]
        wseeds = runtime.seeds_to_arrays(seed_bytes)
        row["K1_seeded"], row["K1_seeded_runs"] = kernel_ms(
            lambda: driver.encode_blocks_cuda(text, tlen, params, caps,
                                              wseeds))
        swords, sbyte_lens = pack_streams(blk.unpack_container(seeded_blob)[0])
        row["K2_seeded"], row["K2_seeded_runs"] = kernel_ms(
            lambda: driver.decode_blocks_cuda(swords, sbyte_lens, caps,
                                              wseeds))
        # what this run's data needs: each block's bytes and stream once,
        # plus the per-lane lengths, counts, sizes and flags (4+20+20+4 B)
        raw, packed = int(tlen.sum()), int(enc[1].sum())
        if int(dec[1].sum()) != raw:
            raise AssertionError(f"{lanes} lanes: K2 decoded "
                                 f"{int(dec[1].sum())} bytes, want {raw}")
        small_io = lanes * (4 + 4 + 20 + 20 + 4)
        bounds[lanes] = {"encoder": bound_ms(raw + packed + small_io),
                         "decoder": bound_ms(packed + raw + small_io)}
        timing[lanes] = row
        mb = len(data[lanes]) / 1e6
        print(f"time {lanes} x 16 KiB: compress {row['compress']:.4f} s "
              f"({mb / row['compress']:.3f} MB/s), decompress "
              f"{row['decompress']:.4f} s ({mb / row['decompress']:.3f} "
              f"MB/s); K1 {row['K1']:.3f} ms, K2 {row['K2']:.3f} ms "
              f"(bounds {bounds[lanes]['encoder']:.5f} / "
              f"{bounds[lanes]['decoder']:.5f} ms); runs "
              f"{[round(r, 4) for r in row['compress_runs']]} / "
              f"{[round(r, 4) for r in row['decompress_runs']]} s, "
              f"{[round(r, 3) for r in row['K1_runs']]} / "
              f"{[round(r, 3) for r in row['K2_runs']]} ms; peak device "
              f"memory {row['peak_mib']:.0f} MiB; K1 "
              f"{row['K1'] * 1e6 / row['events_slowest_lane']:.1f} ns, K2 "
              f"{row['K2'] * 1e6 / row['events_slowest_lane']:.1f} ns an "
              f"event of the slowest lane ({row['events_slowest_lane']} "
              f"events)", flush=True)
        print(f"time {lanes} x 16 KiB seeded: compress "
              f"{row['seeded_compress']:.4f} s "
              f"({mb / row['seeded_compress']:.3f} MB/s, the trainer's "
              f"{row['trainer']:.4f} s on the host included), decompress "
              f"{row['seeded_decompress']:.4f} s "
              f"({mb / row['seeded_decompress']:.3f} MB/s); K1 "
              f"{row['K1_seeded']:.3f} ms, K2 {row['K2_seeded']:.3f} ms "
              f"(runs {[round(r, 3) for r in row['K1_seeded_runs']]} / "
              f"{[round(r, 3) for r in row['K2_seeded_runs']]}); ratio "
              f"{ratios[lanes, True]:.4f} (unseeded "
              f"{ratios[lanes, False]:.4f}); runs "
              f"{[round(r, 4) for r in row['seeded_compress_runs']]} / "
              f"{[round(r, 4) for r in row['seeded_decompress_runs']]} / "
              f"{[round(r, 4) for r in row['trainer_runs']]} s", flush=True)

    # the plain versions at 32 lanes of 4 KiB (a slice of each main-path
    # block, caps_for_block(16 KiB)), held against the kernels
    plain_blocks = [p[:PLAIN_BLOCK] for p in blk.split_blocks(data[32], BLOCK)]
    enc, k1_s, plain_enc_s = against_plain(f"plain shape 32 x {PLAIN_KIB}",
                                           plain_blocks, params, caps)
    words, byte_lens = as_i32(enc[0]), enc[1].to(torch.int32)
    dec, k2_s, plain_dec_s = against_plain_dec(
        f"plain shape 32 x {PLAIN_KIB}", words, byte_lens, caps)
    for i, b in enumerate(plain_blocks):
        if dec[0][i, : dec[1][i]].cpu().numpy().tobytes() != b:
            raise AssertionError(f"plain shape: block {i} does not round trip")
    phase("times", t0)

    # ------------------------------------------------- 11-16. MB blocks
    # the MB corpus's streams against the reference codec's, recorded by
    # tools/mb_oracle.py (the JAX package does not run here)
    oracle = mbc.load_oracle()
    mb = {"encoder": {}, "decoder": {}}   # numbers for the kernels line
    mb_launches = {"encoder": 0, "decoder": 0}

    def oracle_check(label, streams, name):
        want = oracle[name]["streams"]
        if len(streams) > len(want):
            raise AssertionError(f"{label}: {len(streams)} streams, the "
                                 f"reference has {len(want)}")
        for i, (got, ref) in enumerate(zip(streams, want)):
            if (len(got) != ref["len"]
                    or hashlib.sha256(got).hexdigest() != ref["sha256"]):
                raise AssertionError(f"{label}: stream {i} ({len(got)} B) is "
                                     f"not the reference stream "
                                     f"({ref['len']} B)")

    def event_ms(fn):
        """One call's device time (CUDA events) and its result."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def counted(fn):
        """fn's result, wall time and launches, the counts set to 0 just
        before it."""
        driver.LAUNCHES["encoder"] = driver.LAUNCHES["decoder"] = 0
        out, wall = timed(fn)
        return out, wall, dict(driver.LAUNCHES)

    def lane_mib(c):
        # the kernels' own layout; it raises where driver.layout differs
        return driver.kernel_layout(c)[0] * 4 / 2**20

    def time_wave(label, blocks, prm, c, streams=None):
        """K1 then K2 on a wave through the wrappers, one call each timed
        with CUDA events; K1's streams must be ``streams`` (where given)
        and K2 must give the blocks back.  Returns the numbers."""
        text, tlen = (torch.from_numpy(a).to(dev)
                      for a in codec.pack_blocks(blocks, prm, c))
        torch.cuda.reset_peak_memory_stats()
        enc, k1 = event_ms(lambda: driver.encode_blocks_cuda(text, tlen, prm,
                                                             c))
        got = codec.streams_from_words(enc[0], enc[1], len(blocks))
        if enc[4].any_flag().any() or (streams is not None
                                       and got != streams):
            raise AssertionError(f"{label}: K1's streams differ")
        words, byte_lens = pack_streams(got)
        dec, k2 = event_ms(lambda: driver.decode_blocks_cuda(words, byte_lens,
                                                             c))
        for i, b in enumerate(blocks):
            if dec[0][i, : dec[1][i]].cpu().numpy().tobytes() != b:
                raise AssertionError(f"{label}: K2 did not give block {i} "
                                     f"back")
        if not torch.equal(dec[2], enc[2]):
            raise AssertionError(f"{label}: K2's event counts differ")
        ev = int(enc[2].sum(1).max())
        raw, packed = sum(map(len, blocks)), sum(map(len, got))
        small_io = len(blocks) * (4 + 4 + 20 + 20 + 4)
        row = {"k1_ms": k1, "k2_ms": k2, "events": ev,
               "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
               "scratch_mib": lane_mib(c),
               "bound_ms": bound_ms(raw + packed + small_io)}
        print(f"{label}: K1 {k1:.1f} ms, K2 {k2:.1f} ms; {ev} events in the "
              f"slowest lane: K1 {k1 * 1e6 / ev:.1f} ns, K2 "
              f"{k2 * 1e6 / ev:.1f} ns an event; scratch "
              f"{row['scratch_mib']:.2f} MiB a lane, peak device memory "
              f"{row['peak_mib']:.0f} MiB; bound {row['bound_ms']:.5f} ms",
              flush=True)
        return row, got

    # ---- 11. MB wave: 32 x 1 MiB at -t 15 -w 8, caps_for_block(1 MiB)
    t0 = time.perf_counter()
    mb_caps = runtime.caps_for_block(1 << 20)
    mb_data = mbc.mb_corpus(32 << 20)
    mb_blocks = mbc.mb_blocks("wave_1m")
    blob, enc_s, n = counted(lambda: x3tpu_torch.compress(
        mb_data, block_bytes=1 << 20, device="cuda"))
    mb_payloads, orig_lens = blk.unpack_container(blob)[:2]
    if n != {"encoder": 1, "decoder": 0} or len(mb_payloads) != 32:
        raise AssertionError(f"MB wave: {len(mb_payloads)} streams in "
                             f"launches {n}")
    oracle_check("MB wave", mb_payloads, "wave_1m")
    back, dec_s, n2 = counted(lambda: x3tpu_torch.decompress(blob,
                                                             device="cuda"))
    if back != mb_data or n2 != {"encoder": 0, "decoder": 1}:
        raise AssertionError(f"MB wave: decompress gave {len(back)} B in "
                             f"launches {n2}")
    for k in mb_launches:
        mb_launches[k] += n[k] + n2[k]
    print(f"MB wave: 32 x 1 MiB equal the reference streams and come back "
          f"(compress {enc_s:.3f} s, decompress {dec_s:.3f} s, ratio "
          f"{len(blob) / len(mb_data):.4f}); caps {mb_caps}", flush=True)
    row, _ = time_wave("MB wave, once more", mb_blocks, params, mb_caps,
                       mb_payloads)
    zeros, zero_ms = event_ms(lambda: torch.zeros(
        (32, driver.scratch_words(mb_caps)), dtype=torch.int32, device=dev))
    del zeros
    print(f"MB wave: zeroing 32 lanes' scratch ({32 * row['scratch_mib']:.0f} "
          f"MiB) takes {zero_ms:.3f} ms", flush=True)
    for kernel, key in (("encoder", "k1_ms"), ("decoder", "k2_ms")):
        mb[kernel].update({
            "ms_mb": row[key],
            "ns_per_event_mb": row[key] * 1e6 / row["events"],
            "events_slowest_lane_mb": row["events"],
            "bound_ms_mb": row["bound_ms"],
            "scratch_mib_mb": row["scratch_mib"],
            "peak_mib_mb": row["peak_mib"], "zero_ms_mb": zero_ms,
            "wall_s_mb": enc_s if kernel == "encoder" else dec_s})
    phase("MB wave", t0)

    # ---- 12. the first 8 blocks under caps_for_block(16 MiB): caps never
    # change a stream
    t0 = time.perf_counter()
    caps16 = runtime.caps_for_block(16 << 20)
    res, wall, n = counted(lambda: runtime.encode_wave(
        mb_blocks[:8], params, caps16, device="cuda"))
    if n["encoder"] != 1:
        raise AssertionError(f"MB 16 MiB caps: launches {n}")
    oracle_check("MB 16 MiB caps", res.payloads, "wave_1m")
    print(f"MB 16 MiB caps: 8 x 1 MiB equal the reference streams "
          f"(encode_wave {wall:.3f} s); caps {caps16}", flush=True)
    row, _ = time_wave("MB 16 MiB caps", mb_blocks[:8], params, caps16,
                       res.payloads)
    mb["encoder"]["ms_mb_16m_caps"] = row["k1_ms"]
    mb["decoder"]["ms_mb_16m_caps"] = row["k2_ms"]
    phase("MB 16 MiB caps", t0)

    # ---- 13. 32 x 256 KiB at -w 32 (dict 6144, 640 items a row)
    t0 = time.perf_counter()
    w32 = X3Params(window=32 * 1024)
    w32_data = mbc.mb_corpus(8 << 20)
    w32_blocks = mbc.mb_blocks("wave_w32")
    blob, enc_s, n = counted(lambda: x3tpu_torch.compress(
        w32_data, w32, block_bytes=256 << 10, device="cuda"))
    w32_payloads = blk.unpack_container(blob)[0]
    oracle_check("window 32 KiB", w32_payloads, "wave_w32")
    back, dec_s, n2 = counted(lambda: x3tpu_torch.decompress(blob,
                                                             device="cuda"))
    if back != w32_data or n["encoder"] < 1 or n2["decoder"] < 1:
        raise AssertionError(f"window 32 KiB: decompress gave {len(back)} B "
                             f"(launches {n}, {n2})")
    for k in mb_launches:
        mb_launches[k] += n[k] + n2[k]
    # the attempts compress made, one by one: a ctx0 row outgrows 640 items
    w32_caps = runtime.caps_for_block(256 << 10, window=w32.window)
    text, tlen = (torch.from_numpy(a).to(dev)
                  for a in codec.pack_blocks(w32_blocks, w32, w32_caps))
    attempts = []
    for _ in range(n["encoder"] - 1):
        enc, ms = event_ms(lambda: driver.encode_blocks_cuda(
            text, tlen, w32, w32_caps))
        fired = [f for f in enc[4]._fields if bool(getattr(enc[4], f).any())]
        attempts.append((ms, fired))
        if not fired:
            raise AssertionError("window 32 KiB: compress retried a wave "
                                 "that does not overflow")
        w32_caps = runtime._retry_caps(w32_caps, fired, "out_words_factor")
    print(f"window 32 KiB: 32 x 256 KiB equal the reference streams and come "
          f"back (compress {enc_s:.3f} s in {n['encoder']} launches, "
          f"decompress {dec_s:.3f} s); attempts before the last: "
          f"{[(round(ms, 1), f) for ms, f in attempts]}", flush=True)
    row, _ = time_wave("window 32 KiB", w32_blocks, w32, w32_caps,
                       w32_payloads)
    for kernel, key in (("encoder", "k1_ms"), ("decoder", "k2_ms")):
        mb[kernel].update({
            "ms_w32": row[key], "ns_per_event_w32": row[key] * 1e6
            / row["events"], "events_slowest_lane_w32": row["events"],
            "bound_ms_w32": row["bound_ms"], "caps_w32": str(w32_caps)})
    mb["encoder"]["ms_w32_overflowing_attempts"] = [ms for ms, _ in attempts]
    phase("window 32 KiB", t0)

    # ---- 14. the MB wave in launches of 8 lanes (a budget of 8 lanes)
    t0 = time.perf_counter()
    budget = 8 * driver.encoder_lane_bytes(params, mb_caps)
    res, enc_s, n = counted(lambda: runtime.encode_wave(
        mb_blocks, params, mb_caps, device="cuda", mem_budget=budget))
    if n["encoder"] != 4 or res.payloads != mb_payloads:
        raise AssertionError(f"wave split: {n['encoder']} launches, streams "
                             f"equal {res.payloads == mb_payloads}")
    words, _ = pack_streams(mb_payloads)
    dbudget = 8 * driver.decoder_lane_bytes(mb_caps, words.shape[1])
    dres, dec_s, n2 = counted(lambda: runtime.decode_wave(
        mb_payloads, [len(b) for b in mb_blocks], mb_caps, device="cuda",
        mem_budget=dbudget))
    if n2["decoder"] != 4 or dres.payloads != mb_blocks:
        raise AssertionError(f"wave split: {n2['decoder']} K2 launches, "
                             f"blocks equal {dres.payloads == mb_blocks}")
    split_hash = hashlib.sha256(b"".join(res.payloads)).hexdigest()[:16]
    one_hash = hashlib.sha256(b"".join(mb_payloads)).hexdigest()[:16]
    print(f"wave split: {n['encoder']} K1 and {n2['decoder']} K2 launches "
          f"of 8 lanes; streams hash {split_hash}, the one-launch wave's "
          f"{one_hash}; encode_wave {enc_s:.3f} s, decode_wave "
          f"{dec_s:.3f} s", flush=True)
    mb["encoder"].update({"wall_s_mb_split": enc_s,
                          "launches_mb_split": n["encoder"]})
    mb["decoder"].update({"wall_s_mb_split": dec_s,
                          "launches_mb_split": n2["decoder"]})
    phase("wave split", t0)

    # ---- 15. the MB wave from dict_cap 8192, which some blocks outgrow:
    # the retry at caps.scaled(2) (dict 16384, 1 M pairs, 16384 items)
    # gives the reference streams
    t0 = time.perf_counter()
    small_mb = dataclasses.replace(mb_caps, dict_cap=8192)
    torch.cuda.reset_peak_memory_stats()
    res, enc_s, n = counted(lambda: runtime.encode_wave(
        mb_blocks, params, small_mb, device="cuda"))
    if n["encoder"] != 2:
        raise AssertionError(f"MB retry: {n['encoder']} launches, want 2")
    oracle_check("MB retry", res.payloads, "wave_1m")
    retry_mib = lane_mib(small_mb.scaled(2))
    print(f"MB retry: dict_cap 8192 overflowed, the retry at "
          f"{small_mb.scaled(2)} ({retry_mib:.2f} MiB a lane) gave the "
          f"reference streams; encode_wave {enc_s:.3f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB",
          flush=True)
    mb["encoder"].update({"wall_s_mb_retry": enc_s,
                          "scratch_mib_mb_retry": retry_mib})
    phase("MB retry", t0)

    # ---- 16. the command line at real file sizes: one 4 MiB file (a raw
    # stream) and 32 MiB in 1 MiB blocks (a container)
    t0 = time.perf_counter()
    cli_dir = ROOT / "build" / "chip_smoke_cli_mb"
    shutil.rmtree(cli_dir, ignore_errors=True)
    # the CLI runs in processes of its own: hand them the memory this
    # process's allocator still caches from the phases above (tens of GB)
    torch.cuda.empty_cache()
    cli_dir.mkdir(parents=True)
    file_4m = mbc.mb_corpus(4 << 20)
    for fname, (blob, flags) in {
            "file_4m.bin": (file_4m, []),
            "corpus_32m.bin": (mb_data, ["--block-size", "1024"])}.items():
        src = cli_dir / fname
        src.write_bytes(blob)
        for argv in (["-z", *flags, str(src)], ["-d", "-f", f"{src}.x3"]):
            r = subprocess.run([sys.executable, "-m", "x3tpu_torch", *argv],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"cli {argv}: exit {r.returncode}\n"
                                     f"{r.stderr[-3000:]}")
            print(f"cli {' '.join(argv[:-1])} {fname}:", flush=True)
            for line in r.stderr.splitlines():
                print(f"  {line}", flush=True)
            if argv[0] == "-z":
                packed = pathlib.Path(f"{src}.x3").read_bytes()
                if flags:
                    oracle_check(f"cli {fname}",
                                 blk.unpack_container(packed)[0], "wave_1m")
                else:
                    oracle_check(f"cli {fname}", [packed], "file_4m")
        if src.read_bytes() != blob:
            raise AssertionError(f"cli {fname}: -d did not give the input "
                                 f"back")
        print(f"cli {fname}: {len(blob)} B round trip through {len(packed)} "
              f"B, the reference stream{'s' if flags else ''}", flush=True)
    shutil.rmtree(cli_dir)
    # the 4 MiB file's lane alone: K1 at the caps of compress's second
    # attempt (its first overflows the pool of promoted ctx0 rows), K2 from
    # a raw decode's caps
    file_caps = runtime._retry_caps(runtime.caps_for_block(4 << 20),
                                    ("ctx0",), "out_words_factor")
    text, tlen = (torch.from_numpy(a).to(dev)
                  for a in codec.pack_blocks([file_4m], params, file_caps))
    enc, k1 = event_ms(lambda: driver.encode_blocks_cuda(text, tlen, params,
                                                         file_caps))
    stream = codec.streams_from_words(enc[0], enc[1], 1)[0]
    oracle_check("4 MiB file", [stream], "file_4m")
    # K2 from a raw decode's caps, retried as decode_wave retries
    file_raw = raw_caps(stream)
    words, byte_lens = pack_streams([stream])
    k2_attempts = []
    for _ in range(runtime.MAX_RETRIES + 1):
        dec, k2 = event_ms(lambda: driver.decode_blocks_cuda(
            words, byte_lens, file_raw))
        fired = [f for f in dec[4]._fields if bool(getattr(dec[4], f).any())]
        if not fired:
            break
        k2_attempts.append((round(k2, 1), fired))
        file_raw = runtime._retry_caps(file_raw, fired, "block_bytes")
    if dec[0][0, : dec[1][0]].cpu().numpy().tobytes() != file_4m:
        raise AssertionError("4 MiB file: K2 did not give it back")
    ev = int(enc[2].sum())
    print(f"4 MiB file: K1 {k1:.1f} ms at dict {file_caps.dict_cap}, "
          f"items {file_caps.ctx_items_cap}, {file_caps.ctx_promo_rows} "
          f"promoted rows; K2 {k2:.1f} ms at a raw "
          f"decode's dict {file_raw.dict_cap}, items "
          f"{file_raw.ctx_items_cap}, block {file_raw.block_bytes} "
          f"({lane_mib(file_raw):.2f} MiB of scratch), after attempts "
          f"{k2_attempts}; {ev} events: K1 {k1 * 1e6 / ev:.1f} ns, K2 "
          f"{k2 * 1e6 / ev:.1f} ns an event", flush=True)
    for kernel, ms in (("encoder", k1), ("decoder", k2)):
        mb[kernel].update({"ms_file_4m": ms,
                           "ns_per_event_file_4m": ms * 1e6 / ev})
    mb["decoder"]["ms_file_4m_overflowing_attempts"] = [
        ms for ms, _ in k2_attempts]
    phase("MB command line", t0)

    # ---- 17. mesh: lane groups over the local cards, and two entries on
    # one card (two streams side by side)
    t0 = time.perf_counter()
    from x3tpu_torch.parallel import mesh as meshmod

    count = torch.cuda.device_count()
    meshes = {f"every card ({count})": meshmod.make_mesh(),
              "2 entries": meshmod.make_mesh(
                  devices=[f"cuda:{i % count}" for i in range(2)])}
    mesh_launches = {"encoder": 0, "decoder": 0}
    one_blob = results[32, False][0]
    for label, m in meshes.items():
        lpd = -(-32 // m.size)   # one wave of 32 blocks (padded to the mesh)
        blob, enc_s, n = counted(lambda: x3tpu_torch.compress(
            data[32], block_bytes=BLOCK, lanes_per_device=lpd, mesh=m,
            device="cuda"))
        if blob != one_blob or n != {"encoder": m.size, "decoder": 0}:
            raise AssertionError(f"mesh {label}: the one-device streams "
                                 f"{blob == one_blob}, launches {n}")
        back, dec_s, n2 = counted(lambda: x3tpu_torch.decompress(
            blob, lanes_per_device=lpd, mesh=m, device="cuda"))
        if back != data[32] or n2 != {"encoder": 0, "decoder": m.size}:
            raise AssertionError(f"mesh {label}: decompress gave "
                                 f"{len(back)} B in launches {n2}")
        for k in mesh_launches:
            mesh_launches[k] += n[k] + n2[k]
        print(f"mesh {label} {[str(d) for d in m.devices]}: 32 x 16 KiB "
              f"the one-device streams, {n['encoder']} K1 and "
              f"{n2['decoder']} K2 launches; compress {enc_s:.4f} s, "
              f"decompress {dec_s:.4f} s", flush=True)
    two = meshes["2 entries"]
    res, enc_s, n = counted(lambda: runtime.encode_wave(
        mb_blocks, params, mb_caps, device="cuda", mesh=two,
        mem_budget=budget))
    if n["encoder"] != 4:
        raise AssertionError(f"mesh MB wave: {n['encoder']} K1 launches, "
                             f"want 2 groups x 2")
    oracle_check("mesh MB wave", res.payloads, "wave_1m")
    dres, dec_s, n2 = counted(lambda: runtime.decode_wave(
        res.payloads, [len(b) for b in mb_blocks], mb_caps, device="cuda",
        mesh=two, mem_budget=dbudget))
    if n2["decoder"] != 4 or dres.payloads != mb_blocks:
        raise AssertionError(f"mesh MB wave: {n2['decoder']} K2 launches, "
                             f"blocks equal {dres.payloads == mb_blocks}")
    serial = (mb["encoder"]["wall_s_mb_split"],
              mb["decoder"]["wall_s_mb_split"])
    print(f"mesh MB wave over {[str(d) for d in two.devices]}: 2 groups x "
          f"2 launches of 8 lanes each way, the reference streams and the "
          f"blocks back; encode_wave {enc_s:.3f} s, decode_wave "
          f"{dec_s:.3f} s; phase 14's 4 launches in series "
          f"{serial[0]:.3f} s, {serial[1]:.3f} s ({enc_s / serial[0]:.3f}x, "
          f"{dec_s / serial[1]:.3f}x)", flush=True)
    for kernel, wall, launched in (("encoder", enc_s, n["encoder"]),
                                   ("decoder", dec_s, n2["decoder"])):
        mb[kernel].update({"launches_mesh": mesh_launches[kernel],
                           "wall_s_mb_mesh2": wall,
                           "launches_mb_mesh2": launched})
    phase("mesh", t0)

    # ---- 18. distributed: two processes, gloo over localhost
    t0 = time.perf_counter()
    dist_dir = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(dist_dir, ignore_errors=True)
    dist_dir.mkdir(parents=True)
    blocks64 = blk.split_blocks(corpus(64 * BLOCK), BLOCK)
    want = runtime.encode_wave(blocks64, params, caps, device="cuda").payloads
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker",
         str(rank), "2", str(port), str(dist_dir)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed rank {rank}: exit "
                                 f"{p.returncode}\n{out[-3000:]}")
    ranks = [json.loads([line for line in out.splitlines()
                         if line.startswith('{"rank"')][-1]) for out in outs]
    gathered = [bytes.fromhex(h) for h in json.loads(
        (dist_dir / "payloads.json").read_text())]
    if gathered != want:
        raise AssertionError("distributed: the gathered payloads are not "
                             "the one-process wave's")
    shutil.rmtree(dist_dir)
    for r in ranks:
        print(f"distributed rank {r['rank']} on {r['device']}: {r['lanes']} "
              f"lanes, launches {r['launches']}; encode_wave "
              f"{r['encode_s']:.4f} s, gather {r['gather_s']:.4f} s"
              + (f", K2 decode_wave of all 64 {r['decode_s']:.4f} s"
                 if r["decode_s"] is not None else ""), flush=True)
    print("distributed: 64 x 16 KiB gathered in lane order on rank 0, the "
          "one-process wave's payloads, decoded back by K2", flush=True)
    for kernel in mb:
        mb[kernel]["launches_dist"] = sum(r["launches"][kernel]
                                          for r in ranks)
    phase("distributed", t0)

    k1_info = driver.encoder_info()
    k1_warm_info = driver.encoder_info(warm=True)
    k1_plan = driver.smem_plan(params, caps)
    print(f"K1: {k1_info}, warm {k1_warm_info}; shared memory plan "
          f"{k1_plan.nbytes} B "
          f"({sorted(k1_plan.offsets)})", flush=True)
    k2_info = driver.decoder_info()
    print(f"K2: {k2_info}; no dynamic shared memory (every plane in the "
          f"global scratch)", flush=True)

    def kernel_entry(kernel, source, replaces, k_ms, plain_s, k_small_s):
        return {
            "name": kernel,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max_err[kernel],
            "ms": timing[32][k_ms],
            "plain_ms": plain_s * 1e3,
            "bound_ms": bounds[32][kernel],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": "32 x 16 KiB",
            "plain_shape": f"32 x {PLAIN_KIB}",
            "ms_at_plain_shape": k_small_s * 1e3,
            "ms_128_lanes": timing[128][k_ms],
            "ms_seeded": timing[32][k_ms + "_seeded"],
            "ms_seeded_128_lanes": timing[128][k_ms + "_seeded"],
            "bound_ms_128_lanes": bounds[128][kernel],
            "launches_mb": mb_launches[kernel],
            **mb[kernel],
            "launches_warm": warm_launches[kernel],
            "ms_warm": warm_rows[32][k_ms],
            "ms_warm_128_lanes": warm_rows[128][k_ms],
            "launches_warm_mesh": warm_mesh_launches[kernel],
        }

    k1_entry = kernel_entry("encoder", "x3tpu_torch/csrc/x3_encoder.cu",
                            "x3tpu/vm/kernel.py:228", "K1", plain_enc_s, k1_s)
    k1_entry.update({
        "smem_bytes": k1_plan.nbytes + k1_info["static_smem"],
        "smem_dynamic_bytes": k1_plan.nbytes,
        "registers": k1_info["registers"],
        "local_bytes": k1_info["local_bytes"],
        "registers_warm": k1_warm_info["registers"],
        "local_bytes_warm": k1_warm_info["local_bytes"],
        "events_slowest_lane": timing[32]["events_slowest_lane"],
        "ns_per_event": timing[32]["K1"] * 1e6
        / timing[32]["events_slowest_lane"],
        "ns_per_event_128_lanes": timing[128]["K1"] * 1e6
        / timing[128]["events_slowest_lane"],
    })
    k2_entry = kernel_entry("decoder", "x3tpu_torch/csrc/x3_decoder.cu",
                            "x3tpu/vm/kernel_dec.py:112", "K2", plain_dec_s,
                            k2_s)
    k2_entry.update({
        "smem_bytes": k2_info["static_smem"],
        "smem_dynamic_bytes": 0,
        "registers": k2_info["registers"],
        "local_bytes": k2_info["local_bytes"],
        "events_slowest_lane": timing[32]["events_slowest_lane"],
        "ns_per_event": timing[32]["K2"] * 1e6
        / timing[32]["events_slowest_lane"],
        "ns_per_event_128_lanes": timing[128]["K2"] * 1e6
        / timing[128]["events_slowest_lane"],
    })
    def mb_s(what):
        return {str(k): len(data[k]) / 1e6 / v[what]
                for k, v in timing.items()}

    print(json.dumps({
        "kernels": [k1_entry, k2_entry],
        "compress_mb_s": mb_s("compress"),
        "decompress_mb_s": mb_s("decompress"),
        "seeded_compress_mb_s": mb_s("seeded_compress"),
        "seeded_decompress_mb_s": mb_s("seeded_decompress"),
        "trainer_s": {str(k): v["trainer"] for k, v in timing.items()},
        "ratio": {f"{k}{' seeded' if sd else ''}": r
                  for (k, sd), r in ratios.items()},
        "warm_compress_mb_s": {str(k): len(data[k]) / 1e6 / v["compress"]
                               for k, v in warm_rows.items()},
        "warm_decompress_mb_s": {str(k): len(data[k]) / 1e6
                                 / v["decompress"]
                                 for k, v in warm_rows.items()},
        "warm_trainer_s": {str(k): v["trainer"] for k, v in warm_rows.items()},
        "ratio_warm": {str(k): {"warm": v["ratio"],
                                "seeded": v["ratio_seeded"],
                                "unseeded": v["ratio_unseeded"]}
                       for k, v in warm_rows.items()},
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
