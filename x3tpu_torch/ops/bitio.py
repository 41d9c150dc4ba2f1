"""Lane-parallel bit sink and bit source (``x3tpu.ops.bitio``).

LSB-first packing into little-endian u32 words, all L lanes at once under
an ``active`` mask.  Torch on the CPU has no uint32 shifts, so u32 values
live in int64 tensors and every place where the JAX version wraps mod 2^32
masks with ``M32``.  The word buffer is updated in place (each bit position
is written once, so OR == ADD); ``nbits`` and ``overflow`` are returned
fresh in a new :class:`BitSink`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from x3tpu_torch.ops import iota

I64 = torch.int64
M32 = 0xFFFFFFFF
SENTINEL = 0x80000000  # read-past-end word (bio.c:38)


class BitSink(NamedTuple):
    """Per-lane write stream: words[L, OW] plus total bits written."""

    words: torch.Tensor     # int64 [L, OW], u32 values
    nbits: torch.Tensor     # int64 [L]
    overflow: torch.Tensor  # bool [L]


def sink_init(lanes: int, out_words: int, device="cpu") -> BitSink:
    return BitSink(
        words=torch.zeros((lanes, out_words), dtype=I64, device=device),
        nbits=torch.zeros((lanes,), dtype=I64, device=device),
        overflow=torch.zeros((lanes,), dtype=torch.bool, device=device),
    )


def sink_put_bit(sink: BitSink, bit: torch.Tensor,
                 active: torch.Tensor) -> BitSink:
    """Append one bit per active lane; a lane whose buffer is full sets
    ``overflow`` and does not advance (bitio.sink_put_bit)."""
    cap = sink.words.shape[1]
    widx = sink.nbits >> 5
    oob = widx >= cap
    do = active & ~oob
    sink.words.scatter_add_(1, widx.clamp(max=cap - 1)[:, None],
                            ((bit * do) << (sink.nbits & 31))[:, None])
    return BitSink(sink.words, sink.nbits + do, sink.overflow | (active & oob))


def sink_byte_len(sink: BitSink) -> torch.Tensor:
    """Stream length in bytes after the word-granular close (bio.c:105-112)."""
    return ((sink.nbits + 31) >> 5) << 2


_REV16: Dict[torch.device, torch.Tensor] = {}


def _rev16(device: torch.device) -> torch.Tensor:
    """Bit-reversal table of all 16-bit values, one per device."""
    lut = _REV16.get(device)
    if lut is None:
        x = torch.arange(1 << 16, dtype=I64)
        x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
        x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
        x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
        lut = _REV16[device] = (((x & 0x00FF) << 8) | (x >> 8)).to(device)
    return lut


def bitrev32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the bits of each u32 (two 16-bit table lookups)."""
    lut = _rev16(x.device)
    return (lut[x & 0xFFFF] << 16) | lut[(x >> 16) & 0xFFFF]


def sink_put_bits(sink: BitSink, value: torch.Tensor, count: torch.Tensor,
                  active: torch.Tensor) -> BitSink:
    """Append up to 62 bits per active lane (LSB of ``value`` first).
    Words past the buffer are dropped and set ``overflow``; for counts up
    to 32 this is x3tpu's sink_put_bits (bitio.py:139-167) exactly, and a
    longer count writes what consecutive calls would."""
    cap = sink.words.shape[1]
    cnt = count * active
    v = value & ((1 << cnt) - 1)
    off = sink.nbits & 31
    lo = (v & M32) << off               # < 2^63
    hi = (v >> 32) << off               # < 2^61
    # the three words the bits can touch; adding zero elsewhere is a no-op
    w = torch.stack((lo & M32, (lo >> 32) | (hi & M32), hi >> 32), 1)
    idx = (sink.nbits >> 5)[:, None] + iota(3, w.device)
    ok = idx < cap
    sink.words.scatter_add_(1, idx.clamp(max=cap - 1), w * ok)
    end_bit = sink.nbits + cnt
    overflow = sink.overflow | ((cnt > 0) & (end_bit > cap * 32))
    return BitSink(sink.words, end_bit, overflow)


class BitSource(NamedTuple):
    """Per-lane read stream mirroring struct bio in READ mode."""

    words: torch.Tensor   # int64 [L, IW], u32 values
    nwords: torch.Tensor  # int64 [L] readable words (end-minus-3 rule, bio.c:11)
    widx: torch.Tensor    # int64 [L]
    acc: torch.Tensor     # int64 [L] current word (bio.b), u32 value
    used: torch.Tensor    # int64 [L] bits consumed of acc (init 32)


def source_init(words: torch.Tensor, byte_lens: torch.Tensor) -> BitSource:
    """``byte_lens`` are the per-lane compressed sizes in bytes; a word at
    byte offset o is readable iff o < size - 3 (bio.c:30-42)."""
    lanes = words.shape[0]
    z = torch.zeros((lanes,), dtype=I64, device=words.device)
    return BitSource(
        words=words,
        nwords=((byte_lens.to(I64) - 4).div(4, rounding_mode="floor")
                + 1).clamp(min=0),
        widx=z, acc=z, used=z + 32,
    )


def source_get_bits(src: BitSource, count: torch.Tensor,
                    active: torch.Tensor) -> Tuple[BitSource, torch.Tensor]:
    """Read up to 31 bits per active lane (first stream bit in the LSB);
    at most one word reload, and words past ``nwords`` read as the
    sentinel 0x80000000 (bitio.source_get_bits).  ``acc`` holds the
    32 - used bits not yet read, so a reload appends the next word above
    them."""
    cnt = count * active
    avail = 32 - src.used
    need2 = cnt > avail
    cur = src.words.gather(
        1, src.widx.clamp(max=src.words.shape[1] - 1)[:, None])[:, 0]
    loaded = torch.where(src.widx < src.nwords, cur, SENTINEL)
    # avail < cnt <= 31 where the word is appended
    bits = torch.where(need2, src.acc | (loaded << avail.clamp(max=31)),
                       src.acc)
    return BitSource(
        src.words, src.nwords, src.widx + need2, bits >> cnt,
        src.used + cnt - 32 * need2,
    ), bits & ((1 << cnt) - 1)
