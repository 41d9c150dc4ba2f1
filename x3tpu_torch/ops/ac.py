"""Lane-parallel 31-bit arithmetic encoder with closed-form renormalization
(the encoder half of ``x3tpu.ops.ac``; derivations in its docstring).

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
    bitrev32,
    sink_put_bit,
    sink_put_bits,
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
