#!/usr/bin/env python3
"""The kernels' cores under AddressSanitizer and UndefinedBehaviorSanitizer,
on the CPU.

    python3 tools/sanitize_core.py

Builds ``x3tpu_torch/csrc/x3_core_host.cpp`` (the g++ build of K1's and
K2's per-lane cores, one thread per lane) with ``-fsanitize=address,
undefined`` into ``build/x3tpu_torch/`` and runs, in a child process that
preloads the sanitizers' runtimes, these cases through both cores: the
golden inputs of every golden paramset (K1 with its planes in the scratch
and in a buffer of their own; each stream must be the golden one) and the
golden streams (each must decode to its input); K1's index model tree
(``x3h_ix_tree``) from rank 0 to the last position, filled past its
size; small capacities where
every overflow flag fires, encoded and decoded; corrupt streams (random
bytes, a golden stream cut in half, zeros, and every stream of 0-4 bytes),
which must end in a flag; seeded encodes and decodes (seeds trained by
``x3tpu_torch.host`` on the golden inputs), which must round trip; and
warm ones (the seeds and tape ``x3tpu_torch.host.train_tape`` gives there,
each lane's scratch written by ``driver.seed_scratch`` and
``driver.warm_scratch``), which must round trip too.  Any
sanitizer report ends the child with an error, and so does a failed check.
The build takes about a minute; the tests (``tests/test_torch_kernel_host
.py``) build the cores with ``-O2`` only.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "x3tpu_torch" / "csrc"
GOLDEN = ROOT / "tests" / "golden"
FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]
# the golden streams' paramsets (tests/golden/*.<name>.x3)
PARAMSETS = {
    "t15_w8": dict(max_match_count=15, window=8 * 1024),
    "t4_w1": dict(max_match_count=4, window=1024),
    "t2_w1_x": dict(max_match_count=2, window=1024, nl_remap=True),
    "t8_w2_m0": dict(max_match_count=8, window=2 * 1024, magic_factor1=0),
}
OF_STEPS, OF_CORRUPT = 32, 64


def build() -> pathlib.Path:
    src = CSRC / "x3_core_host.cpp"
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = (ROOT / "build" / "x3tpu_torch"
           / f"libx3core_host_san_{h.hexdigest()[:16]}.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, out)
    return out


def runtimes():
    """The sanitizers' runtime libraries, to preload into the child (the
    interpreter itself is not instrumented)."""
    libs = []
    for name in ("libasan.so", "libubsan.so"):
        path = subprocess.run(["g++", f"-print-file-name={name}"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        if not os.path.isabs(path):
            raise RuntimeError(f"g++ has no {name}")
        libs.append(path)
    return libs


class Core:
    """ctypes bindings of the host build (x3_core_host.cpp)."""

    def __init__(self, path):
        self.lib = lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.x3h_encode.argtypes = ([p, p, i, ctypes.c_longlong] + [i] * 12
                                   + [ctypes.c_uint, p, p, i] + [p] * 6)
        lib.x3h_encode.restype = i
        lib.x3h_decode.argtypes = [p, p] + [i] * 9 + [p, p, i] + [p] * 5
        lib.x3h_decode.restype = i
        lib.x3h_encode_warm.argtypes = ([p, p, i, ctypes.c_longlong]
                                        + [i] * 12
                                        + [ctypes.c_uint, i, p, i, i, i]
                                        + [p] * 5)
        lib.x3h_encode_warm.restype = i
        lib.x3h_decode_warm.argtypes = ([p, p] + [i] * 10 + [p, i, i, i]
                                        + [p] * 5)
        lib.x3h_decode_warm.restype = i
        for fn in ("x3h_dict_layout", "x3h_fam_layout"):
            getattr(lib, fn).restype = None
        lib.x3h_dict_layout.argtypes = [i] * 6 + [p]
        lib.x3h_fam_layout.argtypes = [i] * 7 + [p]
        lib.x3h_scratch_words.argtypes = [i] * 6
        lib.x3h_scratch_words.restype = ctypes.c_longlong
        lib.x3h_ix_tree.argtypes = [i, i, i, p, p, p, p]
        lib.x3h_ix_tree.restype = ctypes.c_longlong

    def warm_scratch(self, caps, seeds, warm, cumulative):
        """One lane's scratch as the wrappers start a warm lane, and the
        warm counts."""
        import torch
        from x3tpu_torch.vm import driver

        words = self.lib.x3h_scratch_words(
            caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
            caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows)
        scratch = torch.zeros((1, words), dtype=torch.int32)
        driver.seed_scratch(scratch, driver.dict_layout(
            caps, self.lib, "x3h_dict_layout"), seeds, cumulative)
        counts = driver.warm_scratch(scratch, driver.fam_layout(
            caps, self.lib, "x3h_fam_layout"), warm, caps)
        return scratch[0].numpy().copy(), counts

    @staticmethod
    def _seeds(seeds):
        import numpy as np

        if seeds is None:
            return None, None, 0, ()
        strs = np.ascontiguousarray(seeds[0], np.uint8)
        lens = np.ascontiguousarray(seeds[1], np.int32)
        return strs.ctypes.data, lens.ctypes.data, len(lens), (strs, lens)

    def encode(self, blocks, params, caps, mask=0, seeds=None, warm=None):
        """(streams, flags) of the encoder core (every lane from ``seeds``
        and the warm state ``warm`` where given)."""
        import numpy as np
        from x3tpu_torch import codec

        text, tlen = codec.pack_blocks(blocks, params, caps)
        lanes = len(blocks)
        words = np.zeros((lanes, caps.out_words), np.uint32)
        lens = np.zeros(lanes, np.int32)
        counts = np.zeros((lanes, 5), np.int32)
        sizes = np.zeros((lanes, 5), np.float32)
        flags = np.zeros(lanes, np.int32)
        sp, lp, k, _keep = self._seeds(seeds)
        head = (text.ctypes.data, tlen.ctypes.data, lanes, text.shape[1],
                params.max_match_count, params.window, params.magic_factor1,
                params.magic_factor2, int(params.nl_remap), caps.dict_cap,
                caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
                caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words,
                mask)
        tail = (words.ctypes.data, lens.ctypes.data, counts.ctypes.data,
                sizes.ctypes.data, flags.ctypes.data)
        if warm is None:
            self.lib.x3h_encode(*head, sp, lp, k, *tail, None)
        else:
            init, wn = self.warm_scratch(caps, seeds, warm, False)
            self.lib.x3h_encode_warm(*head, k, init.ctypes.data, *wn, *tail)
        streams = [words[i].tobytes()[: min(lens[i], 4 * caps.out_words)]
                   for i in range(lanes)]
        return streams, flags

    def decode(self, streams, caps, seeds=None, warm=None):
        """(outputs, flags) of the decoder core (``seeds`` and ``warm`` as
        :meth:`encode` takes them)."""
        import numpy as np

        iw = max(1, max((len(s) + 3) // 4 for s in streams))
        words = np.zeros((len(streams), iw), np.uint32)
        for i, s in enumerate(streams):
            arr = np.frombuffer(s + b"\0" * (-len(s) % 4), "<u4")
            words[i, : len(arr)] = arr
        byte_lens = np.array([len(s) for s in streams], np.int32)
        lanes = len(streams)
        out = np.zeros((lanes, caps.block_bytes), np.uint8)
        lens = np.zeros(lanes, np.int32)
        counts = np.zeros((lanes, 5), np.int32)
        sizes = np.zeros((lanes, 5), np.float32)
        flags = np.zeros(lanes, np.int32)
        sp, lp, k, _keep = self._seeds(seeds)
        head = (words.ctypes.data, byte_lens.ctypes.data, lanes, iw,
                caps.block_bytes, caps.dict_cap, caps.pair_cap,
                caps.ctx_items_cap, caps.ctx0_items_cap, caps.ctx_small_cap,
                caps.ctx_promo_rows)
        tail = (out.ctypes.data, lens.ctypes.data, counts.ctypes.data,
                sizes.ctypes.data, flags.ctypes.data)
        if warm is None:
            self.lib.x3h_decode(*head, sp, lp, k, *tail)
        else:
            init, wn = self.warm_scratch(caps, seeds, warm, True)
            self.lib.x3h_decode_warm(*head, k, init.ctypes.data, *wn, *tail)
        return [out[i, : lens[i]].tobytes() for i in range(lanes)], flags


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    print(f"ok: {what}", flush=True)


def child(lib_path) -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from x3tpu_torch import host, warm
    from x3tpu_torch.config import CodecCaps, X3Params
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.vm import driver

    core = Core(lib_path)
    small = CodecCaps(dict_cap=1 << 10, pair_cap=1 << 13, ctx_items_cap=192,
                      block_bytes=1 << 15)
    names = sorted(p.stem for p in GOLDEN.glob("*.bin"))
    inputs = {n: (GOLDEN / f"{n}.bin").read_bytes() for n in names}
    for pname, kw in PARAMSETS.items():
        params = X3Params(**kw)
        refs = [n for n in names if (GOLDEN / f"{n}.{pname}.x3").exists()]
        golden = [(GOLDEN / f"{n}.{pname}.x3").read_bytes() for n in refs]
        for mask in (0, driver.smem_plan(params, small).mask):
            streams, flags = core.encode([inputs[n] for n in refs], params,
                                         small, mask)
            check(streams == golden and not flags.any(),
                  f"golden {pname}, plan mask {mask:#x}: {len(refs)} "
                  f"streams")
        outs, flags = core.decode(golden, small)
        check(outs == [inputs[n] for n in refs] and not flags.any(),
              f"golden {pname}: {len(refs)} streams decode")

    # tests/test_vm.py's blocks at capacities where every flag fires
    rng = np.random.default_rng(7)
    text_small = inputs["text_small"]
    blocks = [b"abracadabra " * 40, b"", text_small[:1200],
              np.random.default_rng(8).integers(0, 256, 900,
                                                np.uint8).tobytes(),
              rng.integers(0, 256, 400, np.uint8).tobytes(), b"A",
              b"\x00" * 1200]
    tiny = CodecCaps(dict_cap=128, pair_cap=256, ctx_items_cap=24,
                     ctx0_items_cap=24, ctx_small_cap=8, ctx_promo_rows=4,
                     block_bytes=1200, out_words_factor=1)
    tparams = X3Params(max_match_count=4, window=256)
    for mask in (0, driver.smem_plan(tparams, tiny).mask):
        streams, flags = core.encode(blocks, tparams, tiny, mask)
        check(all((flags & (1 << b)).any() for b in range(5)),
              f"tiny caps, plan mask {mask:#x}: every overflow flag fires")
    _, dflags = core.decode(streams, tiny)
    check(all((dflags & (1 << b)).any() for b in range(4)),
          "tiny caps: the decoder's state flags fire")

    # K1's index model tree at both ends of the model, filled past D
    for d, k in ((1024, 0), (24576, 600), (5, 5)):
        n = 3 * d
        rank = np.where(np.arange(n) % 3 == 0, -1,
                        np.where(np.arange(n) % 2 == 0, 0,
                                 np.iinfo(np.int32).max)).astype(np.int32)
        idx1 = np.ones(n, np.int32)
        out = np.zeros((n, 3), np.int32)
        ix = np.zeros(d, np.int32)
        core.lib.x3h_ix_tree(d, k, n, rank.ctypes.data, idx1.ctypes.data,
                             out.ctypes.data, ix.ctypes.data)
        check(int(ix.sum()) == int(out[-1, 2]) + 1 and (ix > 0).all(),
              f"index model tree, D {d}, {k} seeds: {n} events, full")

    # corrupt streams: each ends in a flag or an overflow, never a fault
    half = (GOLDEN / "text_small.t15_w8.x3").read_bytes()
    corrupt = [np.random.default_rng(s).integers(0, 256, n, np.uint8)
               .tobytes() for s, n in ((11, 4096), (12, 300), (13, 37))]
    corrupt += [half[: len(half) // 2], bytes(64), bytes(4), b"\0" * 3,
                b"\0" * 2, b"\0", b"", b"\xff" * 4, b"\xff" * 40]
    ccaps = CodecCaps(dict_cap=128, pair_cap=256, ctx_items_cap=24,
                      ctx0_items_cap=24, ctx_small_cap=8, ctx_promo_rows=4,
                      block_bytes=512)
    outs, flags = core.decode(corrupt, ccaps)
    ends = [int(f) for f in flags]
    check(all(f or len(s) < 4 for f, s in zip(ends, corrupt)),
          f"{len(corrupt)} corrupt streams end in a flag: {ends}")

    # seeded: every golden input of a paramset from seeds trained on all
    for pname, kw in PARAMSETS.items():
        params = X3Params(**kw)
        strs, lens = host.train_seeds(b"".join(inputs.values()), params,
                                      small.dict_cap // 2)
        seeds = runtime.seeds_to_arrays(
            [strs[i, : lens[i]].tobytes() for i in range(len(lens))])
        data = [inputs[n] for n in names]
        for mask in (0, driver.smem_plan(params, small).mask):
            streams, flags = core.encode(data, params, small, mask, seeds)
            outs, dflags = core.decode(streams, small, seeds)
            check(outs == data and not flags.any() and not dflags.any(),
                  f"seeded {pname} ({len(lens)} seeds), plan mask "
                  f"{mask:#x}: {len(data)} blocks round trip")
        outs, dflags = core.decode(streams, small)
        check(outs != data or bool(dflags.any()),
              f"seeded {pname}: the streams need their seeds")

    # warm: the same inputs from the seeds and tape trained on all of them
    for pname, kw in PARAMSETS.items():
        params = X3Params(**kw)
        strs, lens, tape = host.train_tape(b"".join(inputs.values()),
                                           params, small.dict_cap // 2)
        seed_bytes = [strs[i, : lens[i]].tobytes() for i in range(len(lens))]
        seeds = runtime.seeds_to_arrays(seed_bytes)
        tape, _ = warm.decode_tape(warm.encode_tape(tape))
        state = warm.pack(warm.replay(tape, len(seed_bytes)))
        data = [inputs[n] for n in names]
        for mask in (0, driver.smem_plan(params, small).mask):
            streams, flags = core.encode(data, params, small, mask, seeds,
                                         state)
            outs, dflags = core.decode(streams, small, seeds, state)
            check(outs == data and not flags.any() and not dflags.any(),
                  f"warm {pname} ({state.pair_n} pairs), plan mask "
                  f"{mask:#x}: {len(data)} blocks round trip")
    print("sanitize_core: no sanitizer report, every check passed",
          flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    lib = build()
    env = dict(os.environ, LD_PRELOAD=" ".join(runtimes()),
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
    r = subprocess.run([sys.executable, __file__, "--child", str(lib)],
                       env=env, cwd=ROOT)
    print(f"sanitize_core: child exit {r.returncode}", flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
