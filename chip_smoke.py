#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (x3tpu_torch) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``.  In order,
stopping with a non-zero exit at the first failure:

1. environment: versions, the card's name and power limit, a CUDA device;
2. build of the CUDA encoder kernel (csrc/x3_encoder.cu) with nvcc;
3. the kernel against its plain PyTorch version on the card: the golden
   inputs under the four golden paramsets (and the golden streams), small
   capacities where overflow flags fire, and magic factor 2;
4. the main path, ``x3tpu_torch.compress(..., device="cuda")`` at 32 and
   128 lanes of 16 KiB: launch counts, every payload against the native host
   codec, the round trip through its decoder, and the container framing;
5. times: compress, the kernel alone, and the plain version, with the
   kernel against the plain version at the main path's shape.

The last line is one JSON object, {"ok": true, "device": {...}}; the line
before it lists the kernels with their launches, errors and times.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
BLOCK = 16 * 1024
SIZE_RTOL, SIZE_ATOL = 1e-5, 1e-3   # f32 size estimates (tests/test_vm.py)


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
    from x3tpu import host
    from x3tpu.config import CodecCaps, X3Params
    from x3tpu.parallel import blocks as blk
    from x3tpu_torch import codec
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.vm import driver

    phase("environment", t0)

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    lib = driver.build()
    phase("build", t0)
    print(f"built {lib.relative_to(ROOT)}", flush=True)
    for line in driver.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    # ------------------------------------- 3. kernel against plain version
    max_err = [0.0]

    def against_plain(label, blocks, params, caps):
        """Kernel and plain version on the same CUDA tensors; everything
        must agree.  Returns the kernel's result and both times."""
        text, tlen = codec.pack_blocks(blocks, params, caps)
        text, tlen = torch.from_numpy(text).to(dev), torch.from_numpy(tlen).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ours = driver.encode_blocks_cuda(text, tlen, params, caps)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t
        t = time.perf_counter()
        ref = codec.encode_blocks_chunked(text, tlen, params, caps)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        for what, a, b in zip(("words", "byte_lens", "counts"), ours, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {what} differ from the plain "
                                     f"version")
        err = (ours[3] - ref[3]).abs().max().item() if len(blocks) else 0.0
        if not torch.allclose(ours[3], ref[3], rtol=SIZE_RTOL, atol=SIZE_ATOL):
            raise AssertionError(f"{label}: sizes differ by {err}")
        max_err[0] = max(max_err[0], err)
        for f in ref[4]._fields:
            if not torch.equal(getattr(ours[4], f), getattr(ref[4], f)):
                raise AssertionError(f"{label}: overflow flag {f} differs")
        print(f"{label}: {len(blocks)} lanes match the plain version "
              f"(kernel {kernel_s:.3f} s, plain {plain_s:.3f} s, "
              f"max size err {err:.3g})", flush=True)
        return ours, kernel_s, plain_s

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
    checked = 0
    for pname, params in paramsets.items():
        out, _, _ = against_plain(f"golden {pname}", inputs, params, small)
        streams = codec.streams_from_words(out[0], out[1], len(inputs))
        for n, stream in zip(names, streams):
            ref = golden / f"{n}.{pname}.x3"
            if ref.exists():
                if stream != ref.read_bytes():
                    raise AssertionError(f"{n}.{pname}: not the golden stream")
                checked += 1
    if checked != 20:
        raise AssertionError(f"{checked} golden streams checked, want 20")
    print(f"golden: {checked} streams byte-identical", flush=True)

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
    out, _, _ = against_plain("tiny caps", vm_blocks,
                              X3Params(max_match_count=4, window=256), tiny)
    fired = {f: getattr(out[4], f).nonzero().flatten().tolist()
             for f in out[4]._fields}
    if not all(fired.values()) or fired["out"] != [3]:
        raise AssertionError(f"tiny caps: lanes flagged {fired}, want every "
                             f"flag to fire and out on lane 3 alone")
    print(f"tiny caps: lanes flagged: {fired}", flush=True)
    against_plain("magic_factor2=2", [text_small, inputs[names.index("c_source")]],
                  X3Params(magic_factor2=2), small)
    phase("kernel vs plain", t0)

    # ---------------------------------------------------------- 4. main path
    t0 = time.perf_counter()
    shapes = (32, 128)
    data = {lanes: corpus(lanes * BLOCK) for lanes in shapes}
    launches = 0
    results = {}
    for lanes in shapes:
        driver.LAUNCHES["encoder"] = 0
        out = x3tpu_torch.compress(data[lanes], block_bytes=BLOCK,
                                   lanes_per_device=lanes, device="cuda")
        n = driver.LAUNCHES["encoder"]
        if n < 1:
            raise AssertionError(f"{lanes} lanes: the encoder kernel was not "
                                 f"launched on the main path")
        launches += n
        results[lanes] = out
    phase("main path", t0)

    t0 = time.perf_counter()
    for lanes in shapes:
        parts = blk.split_blocks(data[lanes], BLOCK)
        payloads, orig_lens, _, _, _ = blk.unpack_container(results[lanes])
        if len(payloads) != lanes:
            raise AssertionError(f"{lanes} lanes: {len(payloads)} payloads")
        for i, (part, payload) in enumerate(zip(parts, payloads)):
            if payload != host.encode(part):
                raise AssertionError(f"{lanes} lanes: block {i} differs from "
                                     f"x3tpu.host.encode")
            if host.decode(payload) != part:
                raise AssertionError(f"{lanes} lanes: block {i} does not "
                                     f"decode back")
        if results[lanes] != blk.pack_container(payloads, orig_lens, BLOCK):
            raise AssertionError(f"{lanes} lanes: container framing differs")
        print(f"main path {lanes} x 16 KiB: {lanes} payloads equal "
              f"x3tpu.host.encode and decode back; ratio "
              f"{len(results[lanes]) / len(data[lanes]):.4f}", flush=True)
    phase("main path checks", t0)

    # ---------------------------------------------------------------- 5. times
    t0 = time.perf_counter()
    caps = runtime.caps_for_block(BLOCK)
    params = X3Params()
    lane_mib = driver.scratch_words(caps) * 4 / 2**20
    print(f"device state per lane: {lane_mib:.2f} MiB of scratch "
          f"(caps {caps})", flush=True)
    timing = {}
    for lanes in shapes:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x3tpu_torch.compress(data[lanes], block_bytes=BLOCK,
                                 lanes_per_device=lanes, device="cuda")
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        text, tlen = codec.pack_blocks(blk.split_blocks(data[lanes], BLOCK),
                                       params, caps)
        text, tlen = torch.from_numpy(text).to(dev), torch.from_numpy(tlen).to(dev)
        torch.cuda.reset_peak_memory_stats()
        kruns = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            driver.encode_blocks_cuda(text, tlen, params, caps)
            torch.cuda.synchronize()
            kruns.append(time.perf_counter() - t)
        timing[lanes] = (statistics.median(runs), statistics.median(kruns))
        mb = len(data[lanes]) / 1e6
        print(f"time {lanes} x 16 KiB: compress {timing[lanes][0]:.4f} s "
              f"({mb / timing[lanes][0]:.3f} MB/s), kernel "
              f"{timing[lanes][1]:.4f} s ({mb / timing[lanes][1]:.3f} MB/s), "
              f"runs {[round(r, 4) for r in runs]} / "
              f"{[round(r, 4) for r in kruns]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB",
              flush=True)
    # the plain version once at the main path's shape, held against the
    # kernel on the same inputs
    blocks32 = blk.split_blocks(data[32], BLOCK)
    _, kernel_s, plain_s = against_plain("main shape 32 x 16 KiB", blocks32,
                                         params, caps)
    phase("times", t0)

    print(json.dumps({"kernels": [{
        "name": "encoder",
        "route": "cuda",
        "source": "x3tpu_torch/csrc/x3_encoder.cu",
        "replaces": "x3tpu/vm/kernel.py:228",
        "launches": launches,
        "max_abs_err": max_err[0],
        "ms": timing[32][1] * 1e3,
        "plain_ms": plain_s * 1e3,
        "ms_128_lanes": timing[128][1] * 1e3,
        "compress_mb_s": {str(k): len(data[k]) / 1e6 / v[0]
                          for k, v in timing.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
