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
   factor 2, and a dictionary too large for shared memory (dict_cap 8192:
   K1 keeps its strings in global memory);
3. the decoder kernel K2 against its plain PyTorch version on the card:
   the 20 golden streams (each must give its input) and K1's tiny-caps
   streams, where the state flags fire while decoding;
4. corrupt streams (random bytes, a golden stream cut in half, zeros):
   K2 and the plain decoder end in the same error, and a decode after
   them still works;
5. seeded kernels: 256 dictionary seeds trained by the port's trainer on
   a strided sample of the corpus; K1 against the plain encoder at 8
   lanes of 4 KiB with every lane seeded, with the default shared-memory
   plan and at dict_cap 8192 (the strings in global memory), and K2
   against the plain decoder on those streams;
6. the raw path: one 16 KiB block compressed to a raw stream and
   decompressed on the card, and the golden streams over 2 KiB decoded
   raw, at the capacities a raw decode picks (dict 16384-24576, 8192
   items a context: about 520 MiB of scratch a lane);
7. the main path at 32 and 128 lanes of 16 KiB, unseeded and with
   ``dict_seed=True``: ``x3tpu_torch.compress(..., device="cuda")`` then
   ``x3tpu_torch.decompress(..., device="cuda")``, each run with the
   launch counts set to 0 just before it and read just after: the data
   comes back, and the decoder's event counts equal the encoder's; then
   each main-path wave is encoded and decoded three more times, with
   every output equal to the first (K1's coder warp and K2's warps hand
   work to each other through shared memory, so a race would show as a
   difference);
8. the command line: ``python3 -m x3tpu_torch`` compresses and
   decompresses a 512 KiB file in 16 KiB blocks with ``--dict-seed`` and
   a 16 KiB file as one raw stream, each to the same bytes;
9. times: compress and decompress (unseeded and seeded), the seed
   trainer on the host, each kernel alone, and both plain versions
   against the kernels at 32 lanes of 4 KiB.

The last line is one JSON object, {"ok": true, "device": {...}}; the line
before it lists the kernels with their launches, errors, times and bounds.
"""

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BLOCK = 16 * 1024
PLAIN_BLOCK = 4 * 1024              # the plain versions' depth
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
    from x3tpu_torch.config import CodecCaps, X3Params
    from x3tpu_torch.parallel import blocks as blk
    from x3tpu_torch.parallel import runtime
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

    def against_plain(label, blocks, params, caps, seeds=None):
        """K1 and the plain encoder on the same CUDA tensors (every lane
        from ``seeds`` where given).  Returns the kernel's result and both
        times."""
        text, tlen = codec.pack_blocks(blocks, params, caps)
        text, tlen = torch.from_numpy(text).to(dev), torch.from_numpy(tlen).to(dev)
        ours, kernel_s = timed(
            lambda: driver.encode_blocks_cuda(text, tlen, params, caps, seeds))
        ref, plain_s = timed(
            lambda: codec.encode_blocks_chunked(text, tlen, params, caps,
                                                seeds))
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

    def against_plain_dec(label, words, byte_lens, caps, seeds=None):
        """K2 and the plain decoder on the same CUDA tensors (``words``
        i32 [L, IW], the streams' u32 words; every lane from ``seeds``
        where given).  Returns the kernel's result and both times."""
        ours, kernel_s = timed(
            lambda: driver.decode_blocks_cuda(words, byte_lens, caps, seeds))
        ref, plain_s = timed(lambda: codec.decode_blocks_chunked(
            words.to(torch.int64) & 0xFFFFFFFF, byte_lens.to(torch.int64),
            caps, seeds))
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
    # K1's shared-memory plan leaves the dictionary strings in global
    # memory at dict_cap 8192; the streams stay the golden ones
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
    seeded_out, _, _ = against_plain(
        f"seeded K1 {SEED_LANES} x 4 KiB", seed_blocks, params, caps, seeds)
    wide_caps = dataclasses.replace(caps, dict_cap=8192)
    if "strs" in driver.smem_plan(params, wide_caps).offsets:
        raise AssertionError("dict_cap 8192: the plan holds the strings")
    wide_out, _, _ = against_plain(
        f"seeded K1 {SEED_LANES} x 4 KiB, dictionary in global memory",
        seed_blocks, params, wide_caps, seeds)
    for got in (seeded_out, wide_out):
        if got[4].any_flag().any():
            raise AssertionError("seeded K1: a lane overflowed")
    if not torch.equal(seeded_out[0], wide_out[0]):
        raise AssertionError("seeded K1: the streams depend on dict_cap")
    words, byte_lens = as_i32(seeded_out[0]), seeded_out[1].to(torch.int32)
    dec, _, _ = against_plain_dec(f"seeded K2 {SEED_LANES} x 4 KiB", words,
                                  byte_lens, caps, seeds)
    for i, b in enumerate(seed_blocks):
        if dec[0][i, : dec[1][i]].cpu().numpy().tobytes() != b:
            raise AssertionError(f"seeded K2: block {i} does not round trip")
    if not torch.equal(dec[2], seeded_out[2]):
        raise AssertionError("seeded K2: event counts differ from K1's")
    unseeded = driver.encode_blocks_cuda(
        *(torch.from_numpy(a).to(dev)
          for a in codec.pack_blocks(seed_blocks, params, caps)),
        params, caps)
    print(f"seeded kernels: {SEED_LANES} x 4 KiB in "
          f"{int(seeded_out[1].sum())} stream bytes seeded, "
          f"{int(unseeded[1].sum())} unseeded; hits by index rank "
          f"{int(seeded_out[2][:, 2].sum())} seeded, "
          f"{int(unseeded[2][:, 2].sum())} unseeded", flush=True)
    phase("seeded kernels vs plain", t0)

    # ------------------------------------------------------- 6. raw path
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

    # ---------------------------------------------------------- 7. main path
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
            payloads, orig_lens, _, seed_bytes = blk.unpack_container(blob)
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

    # ---------------------------------------------------- 8. command line
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

    # ---------------------------------------------------------------- 9. times
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
        _, _, _, seed_bytes = blk.unpack_container(seeded_blob)
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
    enc, k1_s, plain_enc_s = against_plain("plain shape 32 x 4 KiB",
                                           plain_blocks, params, caps)
    words, byte_lens = as_i32(enc[0]), enc[1].to(torch.int32)
    dec, k2_s, plain_dec_s = against_plain_dec("plain shape 32 x 4 KiB",
                                               words, byte_lens, caps)
    for i, b in enumerate(plain_blocks):
        if dec[0][i, : dec[1][i]].cpu().numpy().tobytes() != b:
            raise AssertionError(f"plain shape: block {i} does not round trip")
    phase("times", t0)

    k1_info = driver.encoder_info()
    k1_plan = driver.smem_plan(params, caps)
    print(f"K1: {k1_info}; shared memory plan {k1_plan.nbytes} B "
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
            "plain_shape": "32 x 4 KiB",
            "ms_at_plain_shape": k_small_s * 1e3,
            "ms_128_lanes": timing[128][k_ms],
            "ms_seeded": timing[32][k_ms + "_seeded"],
            "ms_seeded_128_lanes": timing[128][k_ms + "_seeded"],
            "bound_ms_128_lanes": bounds[128][kernel],
        }

    k1_entry = kernel_entry("encoder", "x3tpu_torch/csrc/x3_encoder.cu",
                            "x3tpu/vm/kernel.py:228", "K1", plain_enc_s, k1_s)
    k1_entry.update({
        "smem_bytes": k1_plan.nbytes + k1_info["static_smem"],
        "smem_dynamic_bytes": k1_plan.nbytes,
        "registers": k1_info["registers"],
        "local_bytes": k1_info["local_bytes"],
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
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
