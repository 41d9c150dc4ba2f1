"""Lane-parallel 31-bit arithmetic coder with closed-form renormalization
(``x3tpu.ops.ac``; derivations in its docstring).

u32 values are held in int64 and reduced mod 2^32 with ``M32`` wherever
the JAX version relies on u32 wraparound (``sub = (HALF << m) - HALF``).
The renormalized interval is written in the equivalent product form
``low2 = (low1 - HALF) * 2^m + HALF`` (mod 2^32).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from x3tpu_torch.ops.bitio import (
    M32,
    BitSink,
    BitSource,
    bitrev32,
    sink_put_bit,
    sink_put_bits,
    source_get_bits,
)

I64 = torch.int64

TOP = 0x7FFFFFFF
FIRST_QUARTER = 0x20000000
HALF = 0x40000000
M31 = 0x7FFFFFFF


class AcEnc(NamedTuple):
    low: torch.Tensor    # int64 [L], u32 values
    high: torch.Tensor   # int64 [L], u32 values
    scale: torch.Tensor  # int64 [L]


class AcDec(NamedTuple):
    low: torch.Tensor    # int64 [L], u32 values
    high: torch.Tensor   # int64 [L], u32 values
    buf: torch.Tensor    # int64 [L], u32 values


def enc_init(lanes: int, device="cpu") -> AcEnc:
    return AcEnc(
        low=torch.zeros((lanes,), dtype=I64, device=device),
        high=torch.full((lanes,), TOP, dtype=I64, device=device),
        scale=torch.zeros((lanes,), dtype=I64, device=device),
    )


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values (32 for 0); exact through float64."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(I64)


def _renorm_counts(low: torch.Tensor, high: torch.Tensor):
    """(n, v, low2, high2, m): E1/E2 emission count + bits and the fully
    renormalized interval.  Shift amounts are clamped into range; they only
    leave it on lanes whose results the caller discards."""
    n = _clz32(low ^ high) - 1                   # common leading bits
    nc = n.clamp(0, 31)
    v = (low >> (31 - nc)) * (n > 0)
    low1 = (low << nc) & M31
    high1 = (((high + 1) << nc) - 1) & M31       # (high << n) | (2^n - 1)
    # the ones after low1's top 0 and the zeros after high1's top 1
    m = _clz32(torch.stack((M32 - ((low1 << 2) & M32),
                            (high1 << 2) & M32))).amin(0).clamp(max=30)
    p2 = 1 << m
    low2 = ((low1 - HALF) * p2 + HALF) & M32     # (low1 << m) - H(2^m - 1)
    high2 = ((high1 - (HALF - 1)) * p2 + (HALF - 1)) & M32
    return n, v, low2, high2, m


def _emit_renorm(enc_scale: torch.Tensor, n: torch.Tensor, v: torch.Tensor,
                 sink: BitSink, active: torch.Tensor) -> Tuple[BitSink, torch.Tensor]:
    """Emit b0 (the MSB of v), the pending underflow run (``scale`` copies
    of !b0), and the n-1 remaining bits of v.  In LSB-first order the n
    bits of v are v bit-reversed; where all of it fits in 62 bits it goes
    out as one bit string, longer runs go out 31 bits at a time."""
    emit = active & (n > 0)
    rv = bitrev32(v) >> (32 - n.clamp(1, 31))    # v's bits, b0 first
    b0 = rv & 1
    sc = enc_scale.clamp(0, 61)
    run = (1 - b0) * ((1 << sc) - 1)
    total = n + enc_scale
    fits = total <= 62
    one = emit & fits
    sink = sink_put_bits(sink, b0 | (run << 1) | ((rv >> 1) << (1 + sc)),
                         total, one)

    long_run = emit & ~fits
    if bool(long_run.any()):
        sink = sink_put_bits(sink, b0, torch.ones_like(b0), long_run)
        left = enc_scale
        while True:
            do = long_run & (left > 0)
            if not bool(do.any()):
                break
            chunk = left.clamp(0, 31)
            sink = sink_put_bits(sink, (1 - b0) * ((1 << chunk) - 1), chunk, do)
            left = left - chunk * do
        sink = sink_put_bits(sink, rv >> 1, n - 1, long_run)
    return sink, enc_scale * ~emit


def ac_encode(enc: AcEnc, sink: BitSink, low_f: torch.Tensor,
              high_f: torch.Tensor, total: torch.Tensor,
              active: torch.Tensor) -> Tuple[AcEnc, BitSink]:
    """Code one symbol interval [low_f, high_f) / total per active lane
    (ac.c:77-85) and renormalize in closed form."""
    step = (enc.high - enc.low + 1) // total.clamp(min=1)
    high = (enc.low + step * high_f - 1) & M32
    low = (enc.low + step * low_f) & M32

    n, v, low2, high2, m = _renorm_counts(low, high)
    sink, scale_after_emit = _emit_renorm(enc.scale, n * active, v, sink,
                                          active)
    return AcEnc(
        torch.where(active, low2, enc.low),
        torch.where(active, high2, enc.high),
        torch.where(active, scale_after_emit + m, enc.scale),
    ), sink


def ac_flush(enc: AcEnc, sink: BitSink, active: torch.Tensor) -> BitSink:
    """Terminate the stream: 1 bit, or (scale+2) bits (ac.c:115-126)."""
    low_branch = enc.low < FIRST_QUARTER
    sink = sink_put_bit(sink, (~low_branch).to(I64), active)
    remaining = enc.scale + 1
    while True:
        do = active & low_branch & (remaining > 0)
        if not bool(do.any()):
            break
        chunk = remaining.clamp(0, 31)
        sink = sink_put_bits(sink, (1 << chunk) - 1, chunk, do)
        remaining = remaining - chunk * do
    return sink


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def dec_init(src: BitSource) -> Tuple[AcDec, BitSource]:
    """Prime the decode buffer with exactly 31 bits, MSB-first
    (ac.c:133-140)."""
    every = torch.ones_like(src.widx, dtype=torch.bool)
    src, raw = source_get_bits(src, torch.full_like(src.widx, 31), every)
    z = torch.zeros_like(src.widx)
    return AcDec(z, z + TOP, bitrev32(raw) >> 1), src


def ac_decode_value(dec: AcDec, total: torch.Tensor):
    """(step, value) of the pending symbol (ac.c:128-131, ac.c:183-185):
    exact u32 divisions, each divisor at least 1 (a corrupt stream can
    reach step 0)."""
    step = ((dec.high - dec.low + 1) & M32) // total.clamp(min=1)
    value = ((dec.buf - dec.low) & M32) // step.clamp(min=1)
    return step, value


def ac_decode_update(dec: AcDec, src: BitSource, step: torch.Tensor,
                     low_f: torch.Tensor, high_f: torch.Tensor,
                     active: torch.Tensor) -> Tuple[AcDec, BitSource]:
    """Narrow to the decoded symbol's interval and renormalize, consuming
    n+m stream bits in one read (ac.c:142-165, ac.c:192-195).  A corrupt
    stream can leave a wrapped interval whose bounds differ in bit 31;
    there n is taken as 0, and n+m stays at most 31."""
    high = (dec.low + step * high_f - 1) & M32
    low = (dec.low + step * low_f) & M32
    n, v, low2, high2, m = _renorm_counts(low, high)
    n = n.clamp(min=0)
    k = (n + m) * active
    src, raw = source_get_bits(src, k, active)
    # stream bits arrive LSB-first; the decoder shifts them in MSB-first
    # (k = 0 reads nothing, and the shift is then 0)
    grp = bitrev32(raw) >> ((32 - k) & 31)
    # E1/E2: buf1 = (buf << n) - (v << 31) + (first n bits of grp); E3:
    # buf2 = (buf1 << m) - H(2^m - 1) + (last m bits), that is
    # ((buf << n) - (v << 31) - H) * 2^m + grp + H (mod 2^32)
    buf1 = ((dec.buf << n) - ((v & 1) << 31) - HALF) & M32
    buf2 = ((buf1 << m) + grp + HALF) & M32
    return AcDec(
        torch.where(active, low2, dec.low),
        torch.where(active, high2, dec.high),
        torch.where(active, buf2, dec.buf),
    ), src
