"""Lane-parallel adaptive frequency models (``x3tpu.models.adaptive``;
ac.c:200-273).  A model is a freq vector [L, M]."""

from __future__ import annotations

from typing import Tuple

import torch

from x3tpu_torch.ops import iota


def model_encode_stats(
    freqs: torch.Tensor, sym: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(low_f, span, total) for coding ``sym`` [L] from ``freqs`` [L, M]."""
    M = freqs.shape[1]
    low = (freqs * (iota(M, freqs.device)[None, :] < sym[:, None])).sum(1)
    span = freqs.gather(1, sym.clamp(max=M - 1)[:, None])[:, 0]
    return low, span, freqs.sum(1)


def model_decode_sym(freqs: torch.Tensor, value: torch.Tensor):
    """The symbol whose interval holds ``value`` [L]: with the exclusive
    prefix ``cum``, sym = (number of symbols with a nonzero freq and
    cum <= value) - 1, at least 0.  Returns (sym, low_f, span)."""
    cum = freqs.cumsum(1) - freqs
    sym = (((freqs > 0) & (cum <= value[:, None])).sum(1) - 1).clamp(min=0)
    return (sym, cum.gather(1, sym[:, None])[:, 0],
            freqs.gather(1, sym[:, None])[:, 0])


def model_inc(freqs: torch.Tensor, sym: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """freq[sym] += 1 per active lane (inc_model, ac.c:215-228), in place;
    returns ``freqs``."""
    M = freqs.shape[1]
    lane = iota(freqs.shape[0], freqs.device)
    return freqs.index_put_((lane, sym.clamp(max=M - 1)),
                            active.to(freqs.dtype), accumulate=True)


def f32_prob(span: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """f32 probability matching C float semantics ((float)freq / total,
    ac.c:108-113): one correctly rounded f32 division."""
    return span.to(torch.float32) / total.to(torch.float32)
