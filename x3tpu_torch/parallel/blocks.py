"""Block splitting and the multi-block X3TC container format.

A copy of ``x3tpu.parallel.blocks`` (the port imports nothing of the JAX
package); the bytes it writes and reads are the same.  A single-block
compression is a *raw* reference-format x3 stream.  Multi-block output
wraps per-block reference-format payloads in a thin container so the
decoder knows block boundaries and exact decoded sizes:

    magic  "X3TC" (4)            — container marker
    ver    u8 = 1
    flags  u8                    — bit 0: seed dictionary present
    nblk   u16                   — reserved (0)
    count  u32                   — number of blocks
    block  u32                   — nominal uncompressed block size
    [seeds] if flag bit 0: count u16, then per seed: len u8 + bytes
    [tape]  if flag bit 1: the model warm-start tape
            (``x3tpu_torch.warm.encode_tape``: u32 count, then LEB128
            varints of the seed indices); requires the seed flag
    table  count x (orig_len u32, comp_len u32)
    payloads, concatenated in block order (each a raw x3 stream)

All integers little-endian.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

from x3tpu_torch import warm

MAGIC = b"X3TC"
VERSION = 1
FLAG_SEEDS = 1
FLAG_WARM = 2
_HEADER = struct.Struct("<4sBBHII")
_ENTRY = struct.Struct("<II")


def split_blocks(data: bytes, block_bytes: int) -> List[bytes]:
    """Split an input into independent blocks (last may be short)."""
    if block_bytes <= 0:
        raise ValueError("block_bytes must be positive")
    if not data:
        return [b""]
    return [data[i : i + block_bytes] for i in range(0, len(data), block_bytes)]


def pack_container(
    payloads: Sequence[bytes], orig_lens: Sequence[int], block_bytes: int,
    seeds: Sequence[bytes] = (), warm_tape: Sequence[int] = (),
) -> bytes:
    """The container of ``payloads`` (``seeds``: the dictionary seeds every
    block was coded from, each 1-32 bytes; ``warm_tape``: the warm-start
    tape over them, ``x3tpu_torch.warm``)."""
    if len(payloads) != len(orig_lens):
        raise ValueError(
            f"{len(payloads)} payloads but {len(orig_lens)} orig_lens"
        )
    if warm_tape and not seeds:
        raise ValueError("warm tape requires seeds")
    flags = (FLAG_SEEDS if seeds else 0) | (FLAG_WARM if warm_tape else 0)
    parts = [
        _HEADER.pack(MAGIC, VERSION, flags, 0, len(payloads), block_bytes)
    ]
    if seeds:
        parts.append(struct.pack("<H", len(seeds)))
        for frag in seeds:
            if not 1 <= len(frag) <= 32:
                raise ValueError(f"a seed of {len(frag)} bytes")
            parts.append(struct.pack("<B", len(frag)) + frag)
    if warm_tape:
        parts.append(warm.encode_tape(list(warm_tape)))
    for o, p in zip(orig_lens, payloads):
        parts.append(_ENTRY.pack(o, len(p)))
    parts.extend(payloads)
    return b"".join(parts)


def is_container(data: bytes) -> bool:
    return data[:4] == MAGIC


def unpack_container(data: bytes):
    """Returns (payloads, orig_lens, block_bytes, seeds, warm_tape).
    Raises ValueError on any malformed/truncated container."""
    try:
        return _unpack_container(data)
    except (struct.error, IndexError) as e:  # truncated header/seeds/table
        raise ValueError(f"corrupt container: {e}") from None


def _unpack_container(data: bytes):
    magic, ver, flags, _r, count, block_bytes = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("not an x3tpu container")
    if ver != VERSION:
        raise ValueError(f"unsupported container version {ver}")
    off = _HEADER.size
    seeds: List[bytes] = []
    if flags & FLAG_SEEDS:
        (nseeds,) = struct.unpack_from("<H", data, off)
        off += 2
        for _ in range(nseeds):
            ln = data[off]
            off += 1
            seeds.append(data[off : off + ln])
            off += ln
    warm_tape: List[int] = []
    if flags & FLAG_WARM:
        if not (flags & FLAG_SEEDS):
            raise ValueError("warm tape without seeds")
        warm_tape, off = warm.decode_tape(data, off)
    table = []
    for _ in range(count):
        table.append(_ENTRY.unpack_from(data, off))
        off += _ENTRY.size
    payloads, orig_lens = [], []
    for orig, comp in table:
        payloads.append(data[off : off + comp])
        orig_lens.append(orig)
        off += comp
    if off != len(data):
        raise ValueError("container length mismatch")
    return payloads, orig_lens, block_bytes, seeds, warm_tape
