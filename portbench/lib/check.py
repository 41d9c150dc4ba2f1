"""The comparison that decides ``correct``: what the timed window's calls
returned, against the plain reference (``portbench/reference``).

* Every decompress call's output against the bytes of its wave, which
  the benchmark made itself.
* Every compress call's container against the framing the reference
  expects: its header, block count, nominal block size and each block's
  original length.
* The calls of one wave return one container: the format fixes the
  stream to the bit, so two different containers of one input mean at
  least one is wrong.
* K1's streams, byte for byte, in a sample of blocks drawn from the seed
  (in each wave the window drove, its longest stream and others at
  random) against the reference encoder's.  A round trip alone cannot
  catch a stream that differs but decodes, such as one whose mode choice
  was computed at a lower precision.

Each number compared has the limit 0.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np

from portbench.reference import container, x3ref

LIMITS = {
    "failed_calls": 0,        # calls that raised
    "decode_mismatch": 0,     # decompress outputs that are not the input
    "framing_mismatch": 0,    # containers framed unlike the reference's
    "unsteady_waves": 0,      # waves that returned two containers
    "stream_mismatch": 0,     # sampled streams unlike the reference's
}


@dataclasses.dataclass
class Outcome:
    """What the window's calls returned, gathered by the harness."""

    failed_calls: int = 0
    decode_mismatch: int = 0
    # wave -> {container bytes: how many calls returned it}
    containers: dict = dataclasses.field(default_factory=dict)


ROOT = pathlib.Path(__file__).resolve().parents[2]


def _encode(args):
    block, params, precision = args
    return x3ref.encode(block, x3ref.Params(**params), precision)


def _worker() -> None:
    """One reference process: a pickled list of ``(index, task)`` on
    standard input, a pickled list of ``(index, stream)`` on standard
    output."""
    tasks = pickle.load(sys.stdin.buffer)
    pickle.dump([(i, _encode(t)) for i, t in tasks], sys.stdout.buffer)
    sys.stdout.buffer.flush()


def reference_streams(blocks: list, params: dict, precision: str = "f32",
                      workers: int = 0) -> list:
    """The reference's stream of each block, on up to ``workers``
    processes (0: one a CPU, at most 8).

    The processes are plain ``subprocess`` children, each waited for on
    every path out, and never ``multiprocessing``, whose resource
    tracker outlives the process that started it."""
    tasks = [(b, params, precision) for b in blocks]
    if workers <= 0:
        workers = min(8, len(os.sched_getaffinity(0)))
    workers = min(workers, len(tasks))
    if workers <= 1:
        return [_encode(t) for t in tasks]
    # the longest blocks first, each to the least loaded process
    shares = [[] for _ in range(workers)]
    load = [0] * workers
    for i in sorted(range(len(tasks)), key=lambda i: -len(tasks[i][0])):
        k = load.index(min(load))
        shares[k].append((i, tasks[i]))
        load[k] += len(tasks[i][0])
    cmd = [sys.executable, "-c",
           "from portbench.lib.check import _worker; _worker()"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    procs = []
    try:
        for share in shares:
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE))
        for proc, share in zip(procs, shares):
            # each process reads all of its input before it writes
            proc.stdin.write(pickle.dumps(share))
            proc.stdin.close()
        out = [None] * len(tasks)
        for proc in procs:
            got = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError(f"a reference process exited with "
                                   f"{proc.returncode}")
            for i, stream in pickle.loads(got):
                out[i] = stream
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for f in (proc.stdin, proc.stdout):
                f.close()


def sample(waves: list, outcome: Outcome, n: int, seed: int) -> list:
    """``(wave, block)`` pairs to compare: in each wave the window
    compressed, the block of its longest stream, then others drawn from
    the seed, ``n`` in all."""
    rng = np.random.default_rng((seed, 0x5A3B))
    used = sorted(w for w, c in outcome.containers.items() if c)
    if not used:
        return []
    picks = []
    for w in used:
        blob = max(outcome.containers[w], key=outcome.containers[w].get)
        try:
            _, blocks = container.parse(blob)
            lens = [len(s) for _, s in blocks]
        except ValueError:
            lens = [0]
        picks.append((w, int(np.argmax(lens))))
    per = -(-max(n - len(picks), 0) // len(used))
    for w in used:
        rest = [b for b in range(len(waves[w])) if (w, b) not in picks]
        take = min(per, len(rest), max(n - len(picks), 0))
        picks += [(w, int(b)) for b in rng.choice(rest, take, replace=False)]
    return sorted(picks)


def compare(waves: list, block_bytes: int, params: dict, outcome: Outcome,
            picks: list, streams: list) -> dict:
    """The numbers compared, each ``{"value", "limit"}``; ``streams`` are
    the reference's streams of ``picks``."""
    framing = unsteady = mismatch = 0
    want = dict(zip(picks, streams))
    for w, seen in outcome.containers.items():
        if len(seen) > 1:
            unsteady += 1
        orig = [len(b) for b in waves[w]]
        for blob, calls in seen.items():
            try:
                (count, block), blocks = container.parse(blob)
            except ValueError:
                framing += calls
                continue
            if (count, block) != (len(orig), block_bytes) or \
                    [o for o, _ in blocks] != orig:
                framing += calls
                continue
            for (pw, pb), stream in want.items():
                if pw == w and blocks[pb][1] != stream:
                    mismatch += 1
    values = {"failed_calls": outcome.failed_calls,
              "decode_mismatch": outcome.decode_mismatch,
              "framing_mismatch": framing,
              "unsteady_waves": unsteady,
              "stream_mismatch": mismatch}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def passed(checks: dict, picks: list) -> bool:
    return bool(picks) and all(c["value"] <= c["limit"]
                               for c in checks.values())
