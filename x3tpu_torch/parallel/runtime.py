"""Runtime of the port (``x3tpu.parallel.runtime``): block splitting,
capacity heuristics, dictionary seeds and the model warm start
(``x3tpu_torch.warm``), waves of independent blocks on one device or over
a mesh of lane groups (``x3tpu_torch.parallel.mesh``), run as launches
sized to the device's memory, overflow auto-retry, the wave journal,
container framing; ``compress`` and ``decompress``.

The engine follows the device and nothing else: ``device="cuda"`` runs the
CUDA kernels (``x3tpu_torch.vm.driver``) and raises without a card,
``device="cpu"`` runs the plain PyTorch codec (``x3tpu_torch.codec``); a
mesh's entries are of the same type.  A configuration the kernels cannot
run raises; nothing is demoted.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from x3tpu_torch import codec
from x3tpu_torch import warm as wm
from x3tpu_torch.config import (MAX_MATCH_LEN, CodecCaps, X3Params,
                                resolve_device)
from x3tpu_torch.parallel import blocks as blk
from x3tpu_torch.parallel import mesh as meshmod
from x3tpu_torch.utils.stats import CodecStats


MAX_RETRIES = 3  # capacity doublings before an overflow is raised
# the stream of an empty block, the shortest valid one: a wave's pad lanes
# decode it (the decoder's state at its EOF is the same with or without
# seeds and warm state: the event model, the first thing the EOF reads,
# starts the same)
EMPTY_STREAM = bytes.fromhex("ff170000")
MIN_STREAM = len(EMPTY_STREAM)


class WaveJournal:
    """Per-wave checkpoint of a long compression (``x3tpu.parallel.runtime
    .WaveJournal``; the reference aborts on any failure).  Completed waves
    are appended under a job fingerprint; running the same job again
    resumes after them.  One JSON record a line on an append-only file:
    the fingerprint, then the seeds (recorded once) and each wave's
    payloads and stats.  A file of another job, or one that does not
    parse, starts over."""

    def __init__(self, path: str, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self.done: dict = {}
        self.seed_bytes: Optional[List[bytes]] = None
        try:
            with open(path, "r", encoding="ascii") as f:
                lines = f.read().splitlines()
            if json.loads(lines[0]).get("fingerprint") == fingerprint:
                for line in lines[1:]:
                    self._apply(json.loads(line))
        except (OSError, ValueError, IndexError, KeyError, TypeError):
            self.done, self.seed_bytes = {}, None
        if not self.done and self.seed_bytes is None:
            with open(path, "w", encoding="ascii") as f:
                f.write(json.dumps({"fingerprint": fingerprint}) + "\n")

    def _apply(self, rec: dict) -> None:
        payloads = [base64.b64decode(p) for p in rec["payloads"]]
        if rec["kind"] == "seeds":
            self.seed_bytes = payloads
        else:
            stats = CodecStats(np.array(rec["events"], np.int64),
                               np.array(rec["sizes"], np.float64))
            self.done[rec["wave"]] = (payloads, stats)

    def _append(self, rec: dict) -> None:
        rec["payloads"] = [base64.b64encode(p).decode() for p in
                           rec["payloads"]]
        with open(self.path, "a", encoding="ascii") as f:
            f.write(json.dumps(rec) + "\n")

    def record_seeds(self, seed_bytes: List[bytes]) -> None:
        self._append({"kind": "seeds", "payloads": seed_bytes})
        self.seed_bytes = seed_bytes

    def record(self, wave: int, payloads: List[bytes],
               stats: CodecStats) -> None:
        self._append({"kind": "wave", "wave": wave, "payloads": payloads,
                      "events": stats.events.tolist(),
                      "sizes": stats.sizes.tolist()})
        self.done[wave] = (payloads, stats)

    def finish(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def caps_for_block(block_bytes: int, ratio_hint: float = 1.0,
                   window: int = 8192) -> CodecCaps:
    """Capacities for a block size: x3tpu's heuristic (runtime.py:91-153,
    where the measurements behind each number are recorded), kept equal so
    that both packages retry at the same points."""
    d = int(np.clip(_pow2(block_bytes // 16), 1 << 10, 1 << 16))
    if d > 24576:
        d = 24576
    if window > 8192:
        d = min(d, 6144)
    items = int(np.clip(_pow2(d // 4), 256, 2048))
    if d <= 8192:
        items = min(items, 640)
    elif block_bytes <= 4 << 20:
        items = 8192
    else:
        items = 4096
    pair = min((32 if d > 8192 else 16) * d,
               1 << (20 if block_bytes > 4 << 20 else 19))
    items0 = min(items, 2048 if block_bytes <= 4 << 20 else 4096)
    return CodecCaps(
        dict_cap=d,
        pair_cap=pair,
        ctx_items_cap=items,
        ctx0_items_cap=items0,
        ctx_promo_rows=min(max(pair // 8, 16), 4096),
        block_bytes=block_bytes,
    )


@dataclasses.dataclass
class RunResult:
    payloads: List[bytes]
    stats: CodecStats


def seeds_to_arrays(seed_bytes: Sequence[bytes]):
    """Seed fragments -> (strs u8 [K, 32], lens i32 [K]) arrays, the
    strings zero-padded (x3tpu/parallel/runtime.py:172)."""
    strs = np.zeros((len(seed_bytes), MAX_MATCH_LEN), np.uint8)
    lens = np.zeros((len(seed_bytes),), np.int32)
    for i, b in enumerate(seed_bytes):
        strs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return strs, lens


def _wave_lanes(nblocks: int, mesh: Optional[meshmod.Mesh],
                lanes_per_device: int = 0) -> int:
    """Lanes per wave (x3tpu's): a multiple of the mesh size covering the
    blocks, bounded by lanes_per_device (0 = unbounded) a device."""
    nd = mesh.size if mesh is not None else 1
    lanes = -(-nblocks // nd) * nd
    if lanes_per_device > 0:
        lanes = min(lanes, nd * lanes_per_device)
    return max(lanes, 1)


def _wave_mesh(mesh: Optional[meshmod.Mesh], device) -> meshmod.Mesh:
    """The mesh a wave runs on: ``mesh``, whose entries must be of
    ``device``'s type, or ``device`` alone."""
    dev = resolve_device(device)
    if mesh is None:
        return meshmod.single(dev)
    if any(d.type != dev.type for d in mesh.devices):
        raise ValueError(f"x3tpu_torch: device={str(device)!r} beside a "
                         f"mesh of {[str(d) for d in mesh.devices]}")
    return mesh


def _retry_caps(caps: CodecCaps, flags, out_field: str) -> CodecCaps:
    """The capacities of the attempt after an overflow of ``flags``: every
    state cap doubled (``CodecCaps.scaled``, x3tpu's retry); after a context
    overflow the pool of promoted rows too, which ``scaled`` keeps (so does
    x3tpu), or a block with more than ``ctx_promo_rows`` context rows past
    ``ctx_small_cap`` items overflows at every attempt (a 4 MiB block of
    the MB corpus has more than 4096 such ctx0 rows); after an output
    overflow the output's room, ``out_field``."""
    caps = caps.scaled(2)
    if "ctx0" in flags or "ctx1" in flags:
        caps = dataclasses.replace(caps,
                                   ctx_promo_rows=2 * caps.ctx_promo_rows)
    if "out" in flags:
        caps = dataclasses.replace(caps,
                                   **{out_field: 2 * getattr(caps, out_field)})
    return caps


def encode_wave(
    blocks_in: Sequence[bytes],
    params: X3Params,
    caps: CodecCaps,
    device="cuda",
    seeds=None,
    mem_budget: Optional[int] = None,
    mesh: Optional[meshmod.Mesh] = None,
    warm=None,
) -> RunResult:
    """Encode one wave of blocks with capacity auto-retry: any lane
    overflow, in any lane group, re-runs the wave at doubled capacities,
    up to MAX_RETRIES times (the output stays the exact reference-format
    stream).  Every lane starts from the dictionary ``seeds`` (strs u8
    [K, 32], lens i32 [K]; :func:`seeds_to_arrays`) and the warm state
    ``warm`` (``x3tpu_torch.warm.WarmArrays``) where given.  The
    wave runs on ``device``, or over ``mesh`` (padded with empty blocks to
    a multiple of its size); each attempt runs as launches of at most
    ``mesh.launch_lanes`` lanes (``mem_budget`` bytes a launch).  Neither the
    mesh nor the split changes a stream."""
    mesh = _wave_mesh(mesh, device)
    nblocks = len(blocks_in)
    lanes = _wave_lanes(nblocks, mesh)
    padded = list(blocks_in) + [b""] * (lanes - nblocks)
    for attempt in range(MAX_RETRIES + 1):
        text, tlen = codec.pack_blocks(padded, params, caps)
        words, byte_lens, counts, sizes, overflow = meshmod.encode_sharded(
            text, tlen, params, caps, mesh, seeds, mem_budget, warm)
        try:
            codec._check_overflow(overflow)
            break
        except codec.X3CapacityError as e:
            if attempt == MAX_RETRIES:
                raise
            caps = _retry_caps(caps, e.flags, "out_words_factor")
    payloads = codec.streams_from_words(words, byte_lens, nblocks)
    stats = CodecStats.from_arrays(counts[:nblocks].numpy(),
                                   sizes[:nblocks].numpy())
    return RunResult(payloads, stats)


def decode_wave(
    payloads: Sequence[bytes],
    orig_lens: Sequence[Optional[int]],
    caps: CodecCaps,
    device="cuda",
    seeds=None,
    mem_budget: Optional[int] = None,
    mesh: Optional[meshmod.Mesh] = None,
    warm=None,
) -> RunResult:
    """Decode one wave of streams with capacity auto-retry: an output
    overflow doubles ``block_bytes``, any overflow doubles the state caps,
    up to MAX_RETRIES times.  ``seeds`` and ``warm`` must be the
    encoder's.  The wave runs on ``device``, or over ``mesh``, its pad
    lanes holding EMPTY_STREAM (x3tpu's pad); each attempt runs as
    launches of at most ``mesh.launch_lanes`` lanes (``mem_budget``).  A
    stream shorter than the shortest valid one (MIN_STREAM bytes), a
    corrupt stream, and a block whose decoded length is not its
    ``orig_lens`` entry (None: any length) raise ValueError."""
    mesh = _wave_mesh(mesh, device)
    nblocks = len(payloads)
    if any(len(s) < MIN_STREAM for s in payloads):
        raise ValueError(f"malformed stream: shorter than {MIN_STREAM} "
                         f"bytes")
    lanes = _wave_lanes(nblocks, mesh)
    streams = list(payloads) + [EMPTY_STREAM] * (lanes - nblocks)
    iw = max(1, max((len(s) + 3) // 4 for s in streams))
    words = np.zeros((lanes, iw), np.uint32)
    byte_lens = np.zeros((lanes,), np.int32)
    for i, s in enumerate(streams):
        arr = np.frombuffer(s + b"\x00" * (-len(s) % 4), "<u4")
        words[i, : len(arr)] = arr
        byte_lens[i] = len(s)
    for attempt in range(MAX_RETRIES + 1):
        out, out_lens, counts, sizes, overflow = meshmod.decode_sharded(
            words, byte_lens, caps, mesh, seeds, mem_budget, warm)
        try:
            codec._check_overflow(overflow)
            break
        except codec.X3CapacityError as e:
            if attempt == MAX_RETRIES:
                raise
            caps = _retry_caps(caps, e.flags, "block_bytes")
    out_np = out.numpy()
    lens_np = out_lens.numpy()
    results = []
    for i in range(nblocks):
        n = int(lens_np[i])
        if orig_lens[i] is not None and orig_lens[i] != n:
            raise ValueError(f"block {i}: decoded {n} bytes, expected "
                             f"{orig_lens[i]}")
        results.append(out_np[i, :n].tobytes())
    stats = CodecStats.from_arrays(counts[:nblocks].numpy(),
                                   sizes[:nblocks].numpy())
    return RunResult(results, stats)


def compress(
    data: bytes,
    params: X3Params = X3Params(),
    block_bytes: Optional[int] = None,
    caps: Optional[CodecCaps] = None,
    stats_out: Optional[list] = None,
    dict_seed: bool = False,
    seed_k: int = 256,
    seed_sample: int = 64 * 1024,
    journal_path: Optional[str] = None,
    lanes_per_device: int = 32,
    device="cuda",
    mesh: Optional[meshmod.Mesh] = None,
    force_container: bool = False,
    warm_start: bool = False,
) -> bytes:
    """Compress ``data``.  Single block -> raw reference-format stream
    (``force_container``: an X3TC container of one block); multiple blocks
    -> X3TC container with per-block reference-format payloads
    (``x3tpu_torch.parallel.blocks``).  Waves of ``lanes_per_device``
    blocks a device run on ``device`` or over ``mesh``
    (``x3tpu_torch.parallel.mesh.make_mesh``); neither changes the
    output.

    ``dict_seed`` (x3tpu's extension, no reference counterpart) trains a
    seed dictionary of at most ``seed_k`` fragments on a strided sample of
    ``seed_sample`` bytes (the head of each block) and starts every block
    from it; the seeds travel in the container, so a seeded output is
    always one.  A single block is never seeded.  ``warm_start`` (x3tpu's
    extension; implies ``dict_seed``) also trains the warm-start tape on
    that sample and starts every block's context and pair models from
    its replay (``x3tpu_torch.warm``); the tape travels in the container
    too.  ``journal_path`` keeps a :class:`WaveJournal` there: a run of
    the same job resumes after the waves it records, and the file is
    removed on success."""
    if warm_start:
        dict_seed = True
    if block_bytes is None:
        block_bytes = max(len(data), 1)
    parts = blk.split_blocks(data, block_bytes)
    if caps is None:
        caps = caps_for_block(
            min(block_bytes, max(len(max(parts, key=len)), 1024)),
            window=params.window,
        )
    wave = _wave_lanes(len(parts), mesh, lanes_per_device)
    journal = None
    if journal_path is not None:
        # the wave width (the mesh size times lanes_per_device) is in the
        # fingerprint: waves recorded at another width hold other blocks
        fp = hashlib.sha256(
            repr((params, block_bytes, dict_seed, seed_k, len(data), wave,
                  warm_start)).encode() + data[:4096] + data[-4096:]
        ).hexdigest()
        journal = WaveJournal(journal_path, fp)

    seed_bytes: List[bytes] = []
    seeds = None
    warm_tape: List[int] = []
    warm = None
    if dict_seed and len(parts) > 1:
        # the journal keeps no tape: a warm start trains again (the same
        # sample gives the same seeds and tape)
        if (journal is not None and journal.seed_bytes is not None
                and not warm_start):
            seed_bytes = journal.seed_bytes
        else:
            from x3tpu_torch import host

            # a strided sample, one slice a block, usage-ranked: a head-only
            # sample over-fits the input's first file
            # (x3tpu/parallel/runtime.py:591-610)
            per = max(seed_sample // len(parts), 1)
            sample = b"".join(p[:per] for p in parts)
            k = min(seed_k, caps.dict_cap // 2)
            if warm_start:
                strs, lens, warm_tape = host.train_tape(sample, params, k)
            else:
                strs, lens = host.train_seeds(sample, params, k)
            seed_bytes = [strs[i, : lens[i]].tobytes()
                          for i in range(len(lens))]
            if journal is not None:
                journal.record_seeds(seed_bytes)
        if seed_bytes:
            seeds = seeds_to_arrays(seed_bytes)
        if warm_start and seed_bytes and warm_tape:
            # through the container's bytes (collapse and trim), so the
            # encoder replays exactly what the decoder reads back
            warm_tape, _ = wm.decode_tape(wm.encode_tape(warm_tape))
            warm = wm.pack(wm.replay(warm_tape, len(seed_bytes)))
            wm.check_fits(warm, caps.dict_cap, caps.pair_cap,
                          caps.ctx_small_cap, min(caps.dict_cap, 8192))
    all_payloads: List[bytes] = []
    all_stats = CodecStats.zero()
    for i in range(0, len(parts), wave):
        widx = i // wave
        if journal is not None and widx in journal.done:
            done_payloads, done_stats = journal.done[widx]
            all_payloads.extend(done_payloads)
            all_stats = all_stats.merge(done_stats)
            continue
        res = encode_wave(parts[i : i + wave], params, caps, device=device,
                          seeds=seeds, mesh=mesh, warm=warm)
        if journal is not None:
            journal.record(widx, res.payloads, res.stats)
        all_payloads.extend(res.payloads)
        all_stats = all_stats.merge(res.stats)
    if stats_out is not None:
        stats_out.append(all_stats)
    if journal is not None:
        journal.finish()
    if (len(all_payloads) == 1 and not force_container and not seed_bytes
            # a raw stream that begins with the container magic would be
            # misread as a container; wrap it
            and not blk.is_container(all_payloads[0])):
        return all_payloads[0]
    return blk.pack_container(all_payloads, [len(p) for p in parts],
                              block_bytes, seeds=seed_bytes,
                              warm_tape=warm_tape)


def decompress(
    data: bytes,
    caps: Optional[CodecCaps] = None,
    max_output: Optional[int] = None,
    stats_out: Optional[list] = None,
    lanes_per_device: int = 32,
    device="cuda",
    mesh: Optional[meshmod.Mesh] = None,
) -> bytes:
    """Decompress a raw reference-format stream or an X3TC container (its
    dictionary seeds and warm-start tape included), on ``device`` or over
    ``mesh``.  The
    stream is self-describing: no parameter shapes decoding.  A raw
    stream's output size is not recorded, so its buffer starts from a
    64:1 guess (``max_output`` overrides it) and grows on overflow.  A
    malformed stream raises ValueError."""
    if blk.is_container(data):
        (payloads, orig_lens, block_bytes, seed_bytes,
         warm_tape) = blk.unpack_container(data)
        seeds = seeds_to_arrays(seed_bytes) if seed_bytes else None
        warm = (wm.pack(wm.replay(warm_tape, len(seed_bytes)))
                if warm_tape else None)
        caps = caps or caps_for_block(max(block_bytes, 1024))
        if caps.block_bytes < block_bytes:
            caps = dataclasses.replace(caps, block_bytes=block_bytes)
        out_parts: List[bytes] = []
        all_stats = CodecStats.zero()
        wave = _wave_lanes(len(payloads), mesh, lanes_per_device)
        for i in range(0, len(payloads), wave):
            res = decode_wave(payloads[i : i + wave], orig_lens[i : i + wave],
                              caps, device=device, seeds=seeds, mesh=mesh,
                              warm=warm)
            out_parts.extend(res.payloads)
            all_stats = all_stats.merge(res.stats)
        if stats_out is not None:
            stats_out.append(all_stats)
        return b"".join(out_parts)
    guess = max_output or max(64 * len(data), 1 << 16)
    caps = caps or caps_for_block(guess)
    if caps.block_bytes < guess:
        caps = dataclasses.replace(caps, block_bytes=guess)
    res = decode_wave([data], [None], caps, device=device, mesh=mesh)
    if stats_out is not None:
        stats_out.append(res.stats)
    return res.payloads[0]
