"""Configuration for the PyTorch port: the format constants, ``X3Params``
and ``CodecCaps``.

A copy of ``x3tpu.config`` (the port imports nothing of the JAX package).
``CodecCaps`` has no ``engine`` field and no ``resolved()``: the port picks
its engine from the device (:func:`resolve_device`), with no fallback
between the two.
"""

from __future__ import annotations

import dataclasses

import torch

# Compile-time constant of the format: maximum match/fragment length is 32
# bytes and the match-size model has 32 symbols (backend.h:6-10, x3.c:246).
MATCH_LOGSIZE = 5
MAX_MATCH_LEN = 1 << MATCH_LOGSIZE

# Event alphabet (x3.c:33-40).  The order is load-bearing: event ids are
# symbols of the shared adaptive event model.
E_CTX0 = 0  # dictionary tag coded in the order-2 context
E_CTX1 = 1  # dictionary tag coded in the order-1 context
E_IDX1 = 2  # dictionary recency rank coded in the order-0 model
E_NEW = 3   # literal fragment (length + raw bytes)
E_EOF = 4   # end of stream
E_LAST = 5

# Initial frequencies of the event model (x3.c:238-244).
EVENT_INIT_FREQS = (1024, 1024, 1, 1, 1)


@dataclasses.dataclass(frozen=True)
class X3Params:
    """Encoder-side parameters.  These shape only the encoder's choices; the
    stream is self-describing and decodes under any parameters.

    Attributes mirror the reference flags:
      max_match_count  -t  threshold sweep start (backend.c:21, default 15)
      window           -w  forward search window in bytes (backend.c:8,
                           default 8 KiB)
      magic_factor1    -m  dictionary-preference veto factor (backend.c:33)
      magic_factor2    -n  second veto factor (backend.c:34, default off)
      nl_remap         -x  enable the nl() match-length remap (x3.c:357-370)
    """

    max_match_count: int = 15
    window: int = 8 * 1024
    magic_factor1: int = 4
    magic_factor2: int = 0
    nl_remap: bool = False


@dataclasses.dataclass(frozen=True)
class CodecCaps:
    """Static capacities of the fixed-shape codec state.  The reference
    grows each structure on demand (dict.c:26-36, tag_pair.c:62-65,
    context.c:7-18); here everything is allocated up front, and sticky
    overflow flags report a capacity that would have been exceeded so the
    caller can re-run larger."""

    dict_cap: int = 1 << 12        # max dictionary entries (tags)
    pair_cap: int = 1 << 13        # max (tag,tag) pairs == ctx0 contexts
    ctx_items_cap: int = 128       # promoted-row capacity, order-1 contexts
    ctx0_items_cap: int = 128      # promoted-row capacity, order-2 contexts
    ctx_small_cap: int = 16        # small-pool width (covers the p99)
    ctx_promo_rows: int = 0        # big rows per family (0 = derive)
    block_bytes: int = 1 << 20     # max uncompressed bytes per lane/block
    out_words_factor: int = 2      # compressed buffer headroom (x3.c:580: 2x)

    @property
    def out_words(self) -> int:
        return (self.block_bytes * self.out_words_factor + 3) // 4

    def scaled(self, factor: int) -> "CodecCaps":
        """Return capacities grown by ``factor`` (for overflow re-runs)."""
        return dataclasses.replace(
            self,
            dict_cap=self.dict_cap * factor,
            pair_cap=self.pair_cap * factor,
            ctx_items_cap=self.ctx_items_cap * factor,
            ctx0_items_cap=self.ctx0_items_cap * factor,
        )


def resolve_device(device) -> torch.device:
    """The device a call runs on: ``"cuda"`` runs the CUDA kernels and
    raises when there is no card; ``"cpu"`` runs the plain PyTorch codec.
    Nothing else is accepted."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "x3tpu_torch: device='cuda' but torch.cuda.is_available() "
                "is False (use device='cpu' for the plain PyTorch codec)"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"x3tpu_torch: unsupported device {device!r}")
