#!/usr/bin/env python3
"""Time the CUDA kernels of several checkouts of the port on one GPU, in
turns, on the same input: the A/B of a kernel change.

    python3 tools/kernel_ab.py [--block KIB] OLD_TREE NEW_TREE [...]

Each tree is the root of a checkout (unpack the parent with ``git archive
<commit> | tar -x -C <dir>`` into a directory ``.gitignore`` lists).  The
trees run in the order given and then in reverse (old, new, new, old for
two trees), each in a process of its own that imports that tree's
``x3tpu_torch``: K1 and K2 at 32 and at 128 lanes of 16 KiB of
``chip_smoke.corpus`` (``--block``: blocks of KIB KiB at their
``caps_for_block``, above 16 KiB of the ``c1m-records`` cell's records
at seed 0 (:func:`corpus_of`), and 32 lanes alone above 64 KiB), median
of 5 wrapper calls timed with CUDA events,
a hash of K1's words and lengths and one of K2's bytes, lengths, counts,
sizes and flags (equal across trees whose outputs are).  One JSON line
per run; a run that takes more than RUN_TIMEOUT seconds fails.

    python3 tools/kernel_ab.py --plan [CASE ...]

K1 of this tree with ``driver.smem_plan``'s shared-memory placement (as
it packs the planes with no SMEM_DICT_MAX limit) and with every plane in
global memory (mask 0), in turns (plan, global,
global, plan), on 32 blocks of ``x3tpu_torch.utils.corpus.mb_corpus`` at
each of PLAN_CASES' capacities (16 KiB to 1 MiB blocks, -w 8 and -w 32):
one CUDA-event time a launch and a hash of the streams, which must agree
(CASE: labels of PLAN_CASES to run; default all).

    python3 tools/kernel_ab.py --sass TREE [...]

Each tree's kernel libraries as built (run the timing first, or any
command that builds them): for every kernel function in them, its SASS
instruction count and a hash of its instructions without their addresses
and with the kernel parameters' constant-bank offsets blanked (a new
parameter moves the others), ``cuobjdump -sass``, one JSON line a tree,
so the machine code of two trees' functions can be compared.
"""

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

LANES, BLOCK = (32, 128), 16 * 1024
RUN_TIMEOUT = 300
# --plan: label -> (block bytes, window, dict_cap in place of
# caps_for_block's, or None)
PLAN_CASES = {
    "16 KiB": (16 << 10, 8192, None),
    "16 KiB, dict 8192": (16 << 10, 8192, 8192),
    "32 KiB": (32 << 10, 8192, None),
    "64 KiB": (64 << 10, 8192, None),
    "128 KiB": (128 << 10, 8192, None),
    "256 KiB": (256 << 10, 8192, None),
    "256 KiB, -w 32": (256 << 10, 32768, None),
    "1 MiB": (1 << 20, 8192, None),
}


def print_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)


def plan_ab(labels) -> None:
    """K1 with smem_plan's placement against all-global (PLAN_CASES)."""
    import dataclasses

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch
    from x3tpu_torch import X3Params, codec
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.utils import corpus
    from x3tpu_torch.vm import driver

    driver.build()
    print_card()
    for label in labels or PLAN_CASES:
        block, window, dict_cap = PLAN_CASES[label]
        params = X3Params(window=window)
        caps = runtime.caps_for_block(block, window=window)
        if dict_cap:
            caps = dataclasses.replace(caps, dict_cap=dict_cap)
        data = corpus.mb_corpus(32 * block)
        blocks = [data[i: i + block] for i in range(0, len(data), block)]
        text, tlen = codec.pack_blocks(blocks, params, caps)
        text = torch.from_numpy(text).cuda()
        tlen = torch.from_numpy(tlen).cuda()
        # the placement smem_plan would pick with no dictionary limit
        limit, driver.SMEM_DICT_MAX = driver.SMEM_DICT_MAX, caps.dict_cap
        plan = driver.smem_plan(params, caps)
        driver.SMEM_DICT_MAX = limit
        row = {"case": label, "caps": str(caps), "plan_bytes": plan.nbytes,
               "plan": sorted(plan.offsets), "plan_ms": [], "global_ms": []}
        hashes = set()
        for mask in (plan.mask, 0, 0, plan.mask):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            enc = driver._encode_with(text, tlen, params, caps,
                                      smem_mask=mask)
            b.record()
            torch.cuda.synchronize()
            row["plan_ms" if mask else "global_ms"].append(a.elapsed_time(b))
            hashes.add(hashlib.sha256(
                enc[0].cpu().numpy().tobytes()
                + enc[1].cpu().numpy().tobytes()).hexdigest()[:16])
        if len(hashes) != 1:
            raise AssertionError(f"{label}: the placements' streams differ")
        row["sha"] = hashes.pop()
        row["events_slowest_lane"] = int(enc[2].sum(1).max())
        row["flags"] = [f for f in enc[4]._fields
                        if bool(getattr(enc[4], f).any())]
        print(json.dumps(row), flush=True)


def corpus_of(block: int, nbytes: int) -> bytes:
    """``nbytes`` of input for ``block``-byte blocks, the same in every
    checkout: ``chip_smoke.corpus`` up to 16 KiB, else the ``records``
    traffic of the benchmark's ``c1m-records`` cell at seed 0
    (``portbench/traffic/records.json``, made by its recipe, nothing read
    from the checkout's files)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    if block <= BLOCK:
        import chip_smoke

        return chip_smoke.corpus(nbytes)
    from portbench.lib import generate

    traffic = json.loads(
        (root / "portbench" / "traffic" / "records.json").read_text())
    return generate.generate(traffic, nbytes, 0)


def lanes_of(block: int) -> tuple:
    """The wave sizes timed at ``block``-byte blocks."""
    return LANES if block <= 64 * 1024 else LANES[:1]


def time_tree(tree: pathlib.Path, data_path: pathlib.Path,
              block: int = BLOCK) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from x3tpu_torch import X3Params, codec
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.vm import driver

    driver.build()

    def median_ms(fn):
        fn()
        runs = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b))
        return statistics.median(runs), runs

    data = data_path.read_bytes()
    params, caps = X3Params(), runtime.caps_for_block(block)
    out = {"tree": str(tree), "block_bytes": block,
           "dict_cap": caps.dict_cap}
    for lanes in lanes_of(block):
        blocks = [data[i: i + block] for i in range(0, lanes * block, block)]
        text, tlen = codec.pack_blocks(blocks, params, caps)
        text = torch.from_numpy(text).cuda()
        tlen = torch.from_numpy(tlen).cuda()
        enc = driver.encode_blocks_cuda(text, tlen, params, caps)
        # the wave's streams, to hold the trees' outputs against each other
        out[f"K1_sha_{lanes}"] = hashlib.sha256(
            enc[0].cpu().numpy().tobytes()
            + enc[1].cpu().numpy().tobytes()).hexdigest()[:16]
        out[f"K1_ms_{lanes}"], out[f"K1_runs_{lanes}"] = median_ms(
            lambda: driver.encode_blocks_cuda(text, tlen, params, caps))
        out[f"K1_ns_per_event_{lanes}"] = (
            out[f"K1_ms_{lanes}"] * 1e6 / int(enc[2].sum(1).max()))
        w = enc[0]
        words = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
        lens = enc[1].to(torch.int32)
        dec = driver.decode_blocks_cuda(words, lens, caps)
        if int(dec[1].sum()) != int(tlen.sum()):
            raise AssertionError(f"{tree}: K2 did not decode the wave")
        flags = sum(getattr(dec[4], f).to(torch.int64) << i
                    for i, f in enumerate(dec[4]._fields))
        out[f"K2_sha_{lanes}"] = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes()
            for t in (dec[0], dec[1], dec[2], dec[3], flags))).hexdigest()[:16]
        out[f"K2_ms_{lanes}"], out[f"K2_runs_{lanes}"] = median_ms(
            lambda: driver.decode_blocks_cuda(words, lens, caps))
    return out


def sass_of(tree: pathlib.Path) -> dict:
    """Kernel function -> [SASS instructions, hash of their text] of each
    library under ``tree``'s build directory (``cuobjdump -sass``)."""
    import re

    cuobjdump = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    out = {}
    libs = (tree / "build" / "x3tpu_torch").glob("libx3*coder_*.so")
    for lib in sorted(libs):
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        for part in text.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", part)
            code = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][]",
                          "\n".join(ins))
            out[f"{lib.name.split('_')[0]}:{name}"] = [
                len(ins), hashlib.sha256(code.encode()).hexdigest()[:16]]
    return out


def main() -> int:
    if sys.argv[1] == "--sass":
        for tree in sys.argv[2:]:
            print(json.dumps({"tree": tree,
                              "sass": sass_of(pathlib.Path(tree))}),
                  flush=True)
        return 0
    if sys.argv[1] == "--plan":
        plan_ab(sys.argv[2:])
        return 0
    if sys.argv[1] == "--one":
        print(json.dumps(time_tree(pathlib.Path(sys.argv[2]).resolve(),
                                   pathlib.Path(sys.argv[3]),
                                   int(sys.argv[4]))), flush=True)
        return 0
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    trees, block = sys.argv[1:], BLOCK
    if trees[0] == "--block":
        block, trees = int(trees[1]) * 1024, trees[2:]
    print_card()
    data = corpus_of(block, max(lanes_of(block)) * block)
    data_path = root / "build" / f"kernel_ab_data_{block}.bin"
    data_path.parent.mkdir(parents=True, exist_ok=True)
    data_path.write_bytes(data)
    order = trees + trees[::-1]
    for tree in order:
        subprocess.run([sys.executable, __file__, "--one", tree,
                        str(data_path), str(block)], check=True,
                       timeout=RUN_TIMEOUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
