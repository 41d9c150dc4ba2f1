"""Command-line interface of the port, ``python -m x3tpu_torch``: the
flags of ``x3tpu.cli`` (flag-compatible with the reference binary,
x3.c:460-548, plus the runtime's options).

Reference behaviours kept: -z/-d mode select, -f overwrite guard
(file.c:47-55), -k (no-op: inputs are never deleted), .x3 suffix
add/strip (x3.c:522-548), stdin/stdout when no files are given, the config
echo and the stats block on stderr (x3.c:572-575, x3.c:662-699).

Runtime options: --block-size (KiB) splits the input into independent
blocks (container output), run as lane groups over a mesh of the local
cards (``x3tpu_torch.parallel.mesh``); --devices bounds the mesh (0: every
card; more than the machine has is refused), and either builds it;
--dict-seed starts every block from a trained seed dictionary; --cpu runs
the plain PyTorch codec on the host instead of the CUDA kernels (with
--devices N, over N CPU entries); -q/--quiet drops the stats report.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from x3tpu_torch.config import X3Params
from x3tpu_torch.parallel import mesh as meshmod
from x3tpu_torch.parallel import runtime
from x3tpu_torch.utils import timing


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="x3tpu_torch",
        description="x3 compressor on an NVIDIA GPU (reference-format "
                    "compatible)",
    )
    p.add_argument("-z", dest="mode", action="store_const", const="z",
                   help="force compression")
    p.add_argument("-d", dest="mode", action="store_const", const="d",
                   help="force decompression")
    p.add_argument("-f", dest="force", action="store_true",
                   help="overwrite existing output file")
    p.add_argument("-k", dest="keep", action="store_true",
                   help="keep (don't delete) input file (default)")
    p.add_argument("-t", dest="max_match_count", type=int, default=15,
                   metavar="NUM",
                   help="maximum number of matches (ratio/speed)")
    p.add_argument("-w", dest="window_kib", type=int, default=8, metavar="NUM",
                   help="window size in KiB (ratio/speed)")
    p.add_argument("-m", dest="magic_factor1", type=int, default=4,
                   metavar="NUM", help="magic factor 1")
    p.add_argument("-n", dest="magic_factor2", type=int, default=0,
                   metavar="NUM", help="magic factor 2")
    p.add_argument("-x", dest="nl_remap", action="store_true",
                   help="enable match-length remap")
    p.add_argument("--block-size", type=int, default=0, metavar="KIB",
                   help="split input into KIB-KiB blocks (0 = single block)")
    p.add_argument("--dict-seed", action="store_true",
                   help="broadcast a trained seed dictionary to all blocks")
    p.add_argument("--devices", type=int, default=0,
                   help="mesh size (0 = every local GPU)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch codec on the host CPU")
    p.add_argument("--quiet", "-q", action="store_true",
                   help="suppress the stats report")
    p.add_argument("files", nargs="*", metavar="input-file output-file")
    return p


def _open_out(path: str, force: bool):
    if not force and os.path.exists(path):
        print("File already exists", file=sys.stderr)
        raise SystemExit(1)
    return open(path, "wb")


def main(argv: Optional[list] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    mode = args.mode or "z"
    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.devices != 0 or args.block_size:
        if args.devices < 0:
            parser.error(f"--devices {args.devices}: not a device count")
        try:
            mesh = (meshmod.make_mesh(devices=["cpu"] * max(args.devices, 1))
                    if args.cpu else meshmod.make_mesh(args.devices or None))
        except (ValueError, RuntimeError) as e:   # too many, or no card
            parser.error(f"--devices {args.devices}: {e}")

    params = X3Params(
        max_match_count=args.max_match_count,
        window=args.window_kib * 1024,
        magic_factor1=args.magic_factor1,
        magic_factor2=args.magic_factor2,
        nl_remap=args.nl_remap,
    )

    files = args.files
    if len(files) == 0:
        istream, ostream = sys.stdin.buffer, sys.stdout.buffer
    elif len(files) == 1:
        istream = open(files[0], "rb")
        if mode == "z":
            ostream = _open_out(files[0] + ".x3", args.force)
        else:
            # suffix strip via splitext (dots inside directory components
            # are not suffixes).  A suffixless input must not fall back to
            # the input path itself: opening it for writing would truncate
            # it before it is read, so refuse.
            base, ext = os.path.splitext(files[0])
            if not ext:
                print("Cannot derive output name (no suffix); "
                      "pass an output file", file=sys.stderr)
                istream.close()
                return 1
            ostream = _open_out(base, args.force)
    elif len(files) == 2:
        istream = open(files[0], "rb")
        ostream = _open_out(files[1], args.force)
    else:
        print("Unexpected argument", file=sys.stderr)
        return 1

    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr)
    )
    log("Compressing..." if mode == "z" else "Decompressing...")

    timers = timing.PhaseTimers()
    stats_box: list = []
    try:
        t0 = timing.wall_clock_ns()
        with timers.phase("read"):
            data = istream.read()
        if mode == "z":
            log(f"max match count: {params.max_match_count}")
            log(f"forward window: {params.window}")
            log(f"magic factor 1: {params.magic_factor1}")
            log(f"magic factor 2: {params.magic_factor2}")
            block_bytes = args.block_size * 1024 if args.block_size else None
            with timers.phase("codec"):
                out = runtime.compress(
                    data, params, block_bytes=block_bytes,
                    stats_out=stats_box, dict_seed=args.dict_seed,
                    device=device, mesh=mesh,
                )
            insize, outsize = len(data), len(out)
        else:
            # the stream is self-describing: no parameter shapes decoding
            with timers.phase("codec"):
                out = runtime.decompress(data, stats_out=stats_box,
                                         device=device, mesh=mesh)
            insize, outsize = len(out), len(data)
        elapsed = (timing.wall_clock_ns() - t0) / 1e9
        with timers.phase("write"):
            ostream.write(out)
            ostream.flush()
    finally:
        if files:
            istream.close()
            ostream.close()

    if stats_box and not args.quiet:
        log(stats_box[0].report(insize, outsize, elapsed))
        log(timers.report())
    return 0
