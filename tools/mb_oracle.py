#!/usr/bin/env python3
"""Record the reference streams of the MB checks: the length and sha256 of
the stream of every block of ``x3tpu_torch.utils.corpus.MB_SETS``, from
the JAX package's native host codec (``x3tpu.host.encode``, bit-exact with
the reference binary), into ``x3tpu_torch/testdata/mb_streams.json``.

    python3 tools/mb_oracle.py [--workers N] [SET ...]

With ``--warm``, the warm-start reference instead: the seeds and tape that
``x3tpu.host.train_tape`` trains on the blocks of ``corpus.warm_blocks``
(their sha256, ``corpus.warm_digests``) and the length and sha256 of
``x3tpu.host.encode(block, seeds=, warm_tape=)``'s stream of each block,
into ``x3tpu_torch/testdata/warm_streams.json`` (a few seconds).

``chip_smoke.py`` holds the CUDA kernels' streams to that file on a machine
without the JAX package; ``tests/test_torch_mb.py`` recomputes an entry.
The corpus reads only files that the port never edits, so the file stays
valid until the corpus itself changes.  A whole run takes a few minutes
of CPU time (about 7 s a 1 MiB block at -w 8); SET names rerun only those
sets and keep the others.
"""

import argparse
import hashlib
import json
import multiprocessing
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _one(job):
    name, i, window = job
    from x3tpu import host
    from x3tpu.config import X3Params
    from x3tpu_torch.utils import corpus

    block = corpus.mb_blocks(name)[i]
    t = time.perf_counter()
    stream = host.encode(block, X3Params(window=window))
    return name, i, {"len": len(stream),
                     "sha256": hashlib.sha256(stream).hexdigest()}, \
        time.perf_counter() - t


def warm_oracle() -> dict:
    """The warm-start reference (``--warm``)."""
    from x3tpu import host
    from x3tpu.config import X3Params
    from x3tpu_torch import warm
    from x3tpu_torch.parallel import runtime
    from x3tpu_torch.utils import corpus

    params = X3Params()
    blocks = corpus.warm_blocks()
    strs, lens, tape = host.train_tape(corpus.warm_sample(blocks), params,
                                       corpus.WARM_SEEDS)
    seed_bytes = [bytes(strs[i, : lens[i]]) for i in range(len(lens))]
    tape, _ = warm.decode_tape(warm.encode_tape(tape))
    seeds = runtime.seeds_to_arrays(seed_bytes)
    streams = []
    for i, block in enumerate(blocks):
        stream = host.encode(block, params, seeds=seeds, warm_tape=tape)
        streams.append({"len": len(stream),
                        "sha256": hashlib.sha256(stream).hexdigest()})
        print(f"warm[{i}]: {len(stream)} B", flush=True)
    return {"codec": "x3tpu.host.encode(seeds=, warm_tape=)",
            "trainer": "x3tpu.host.train_tape",
            "corpus": "x3tpu_torch.utils.corpus.warm_blocks()",
            "block_bytes": corpus.WARM_BLOCK, "window": params.window,
            "max_match_count": params.max_match_count,
            "seeds": len(seed_bytes), "tape_entries": len(tape),
            **corpus.warm_digests(seed_bytes, tape), "streams": streams}


def main() -> int:
    from x3tpu_torch.utils import corpus

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--warm", action="store_true",
                    help="record the warm-start reference instead")
    ap.add_argument("sets", nargs="*", default=sorted(corpus.MB_SETS))
    args = ap.parse_args()
    if args.warm:
        corpus.WARM_ORACLE.parent.mkdir(parents=True, exist_ok=True)
        corpus.WARM_ORACLE.write_text(json.dumps(warm_oracle(), indent=1)
                                      + "\n")
        print(f"wrote {corpus.WARM_ORACLE.relative_to(ROOT)}", flush=True)
        return 0
    old = (json.loads(corpus.ORACLE.read_text())["sets"]
           if corpus.ORACLE.exists() else {})
    sets = {k: v for k, v in old.items() if k in corpus.MB_SETS}
    jobs = []
    for name in args.sets:
        block, count, window = corpus.MB_SETS[name]
        sets[name] = {"block_bytes": block, "window": window,
                      "max_match_count": 15, "streams": [None] * count}
        jobs += [(name, i, window) for i in range(count)]
    # the largest blocks first, so the pool ends together
    jobs.sort(key=lambda j: -corpus.MB_SETS[j[0]][0])
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        for name, i, entry, secs in pool.imap_unordered(_one, jobs):
            sets[name]["streams"][i] = entry
            print(f"{name}[{i}]: {entry['len']} B in {secs:.1f} s",
                  flush=True)
    corpus.ORACLE.parent.mkdir(parents=True, exist_ok=True)
    corpus.ORACLE.write_text(json.dumps(
        {"codec": "x3tpu.host.encode", "corpus": "x3tpu_torch.utils.corpus"
         ".mb_corpus(seed=0)", "sets": dict(sorted(sets.items()))},
        indent=1) + "\n")
    print(f"wrote {corpus.ORACLE.relative_to(ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
