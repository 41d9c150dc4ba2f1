"""The X3TC container, as the benchmark reads and expects it.

Written from the format (the port's ``parallel/blocks.py`` docstring
states it; this file imports nothing of the program):

    magic "X3TC" (4), version u8 = 1, flags u8, reserved u16 = 0,
    count u32, nominal block size u32,
    [seeds, if flags bit 0], [warm tape, if flags bit 1],
    count x (original length u32, stream length u32),
    the streams, in block order.

All integers little-endian.  The benchmark's cells run no seeds and no
warm start, so a container it expects has flags 0.
"""

from __future__ import annotations

import struct

MAGIC = b"X3TC"
HEADER = struct.Struct("<4sBBHII")
ENTRY = struct.Struct("<II")


def parse(blob: bytes):
    """``(header fields, [(orig_len, stream)])`` of an unseeded
    container; raises ValueError where it is no such container."""
    if len(blob) < HEADER.size:
        raise ValueError("container shorter than its header")
    magic, ver, flags, rsv, count, block = HEADER.unpack_from(blob, 0)
    if magic != MAGIC or ver != 1 or flags != 0 or rsv != 0:
        raise ValueError(f"header {(magic, ver, flags, rsv)}")
    off = HEADER.size
    if len(blob) < off + count * ENTRY.size:
        raise ValueError("container shorter than its table")
    table = [ENTRY.unpack_from(blob, off + i * ENTRY.size)
             for i in range(count)]
    off += count * ENTRY.size
    blocks = []
    for orig, comp in table:
        blocks.append((orig, blob[off : off + comp]))
        off += comp
    if off != len(blob):
        raise ValueError(f"container of {len(blob)} bytes, its table "
                         f"says {off}")
    return (count, block), blocks


def pack(streams: list, orig_lens: list, block_bytes: int) -> bytes:
    """The unseeded container of ``streams``."""
    parts = [HEADER.pack(MAGIC, 1, 0, 0, len(orig_lens), block_bytes)]
    parts += [ENTRY.pack(o, len(s)) for o, s in zip(orig_lens, streams)]
    return b"".join(parts + list(streams))
