"""Codec statistics and the reference-style stats report.

A copy of ``x3tpu.utils.stats`` (the port imports nothing of the JAX
package).  Reproduces the counters the reference maintains at every code
point (events[]/sizes[], x3.c:42-43) and its stderr report block
(x3.c:662-699).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from x3tpu_torch.config import E_CTX0, E_CTX1, E_IDX1, E_LAST, E_NEW


@dataclasses.dataclass
class CodecStats:
    events: np.ndarray  # i64 [5] summed over blocks
    sizes: np.ndarray   # f64 [5] estimated coded bits

    @classmethod
    def zero(cls) -> "CodecStats":
        return cls(np.zeros(E_LAST, np.int64), np.zeros(E_LAST, np.float64))

    @classmethod
    def from_arrays(cls, counts: np.ndarray, sizes: np.ndarray) -> "CodecStats":
        return cls(
            counts.astype(np.int64).sum(axis=0),
            sizes.astype(np.float64).sum(axis=0),
        )

    def merge(self, other: "CodecStats") -> "CodecStats":
        return CodecStats(self.events + other.events, self.sizes + other.sizes)

    @property
    def dict_hits(self) -> int:
        return int(self.events[E_CTX0] + self.events[E_CTX1] + self.events[E_IDX1])

    @property
    def estimated_bytes(self) -> int:
        total = math.ceil(float(self.sizes.sum()))
        return (int(total) + 7) // 8

    def report(self, input_size: int, output_size: int, elapsed: float = 0.0) -> str:
        """The reference stats block (x3.c:662-695), plus throughput.  The
        reference's final "context entries" line (x3.c:697) reports encoder
        state sizes, not event stats, and is left out."""
        s = self.sizes
        stream_dict = math.ceil(s[E_CTX0] + s[E_CTX1] + s[E_IDX1])
        stream_all = max(math.ceil(s[:E_NEW + 1].sum()), 1)
        new_bits = math.ceil(s[E_NEW])
        lines = [
            f"input stream size: {input_size}",
            f"output stream size: {(int(stream_all) + 7) // 8}",
            f"dictionary: hit {self.dict_hits}, miss {int(self.events[E_NEW])}",
            (
                f"codestream size: dictionary {(int(stream_dict) + 7) // 8} / "
                f"{100.0 * stream_dict / stream_all:f}%, new fragment "
                f"{(int(new_bits) + 7) // 8} / {100.0 * new_bits / stream_all:f}%"
            ),
            (
                f"est. compression ratio: "
                f"{input_size / max((int(stream_all) + 7) // 8, 1):f}"
            ),
            f"real compression ratio: {input_size / max(output_size, 1):f}",
            (
                f"number of events: ctx0 {int(self.events[E_CTX0])}, "
                f"ctx1 {int(self.events[E_CTX1])}, "
                f"miss1 {int(self.events[E_IDX1])}, "
                f"new {int(self.events[E_NEW])}"
            ),
            (
                f"event sizes: ctx0 {100.0 * math.ceil(s[E_CTX0]) / stream_all:f}%, "
                f"ctx1 {100.0 * math.ceil(s[E_CTX1]) / stream_all:f}%, "
                f"miss1 {100.0 * math.ceil(s[E_IDX1]) / stream_all:f}%, "
                f"new {100.0 * math.ceil(s[E_NEW]) / stream_all:f}%"
            ),
        ]
        if elapsed > 0:
            lines.append(
                f"elapsed time: {elapsed:f}  "
                f"({input_size / elapsed / 1e6:.3f} MB/s)"
            )
        return "\n".join(lines)
