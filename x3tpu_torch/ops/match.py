"""Lane-parallel forward-window match finding (``x3tpu.ops.match``;
backend.c:56-100).

``window_counts`` gives count[i] = the number of window positions that
repeat the first i+1 bytes at p; ``best_match_sweep`` turns the
reference's two-level threshold sweep into an argmax over (level, i) of
the candidates that the magic-factor vetoes leave.
"""

from __future__ import annotations

from typing import Optional

import torch

from x3tpu_torch.config import MAX_MATCH_LEN, X3Params
from x3tpu_torch.models.dictionary import DictState, dict_probe_len
from x3tpu_torch.ops import iota

I64 = torch.int64


def gather_window(text: torch.Tensor, p: torch.Tensor, width: int) -> torch.Tensor:
    """text[l, p[l] : p[l]+width] as [L, width].  ``text`` is padded so
    the slice never leaves the row (codec.pack_blocks)."""
    idx = p[:, None] + iota(width, text.device)[None, :]
    return text.gather(1, idx)


def window_counts(win: torch.Tensor, window: int,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """count[i] over a pre-fetched window ``win`` [L, >= window] whose
    column 0 is position p: the positions s in [p+1, p+window-32)
    (backend.c:66) whose next i+1 bytes repeat those at p.  Only positions
    whose first byte repeats p's can count, so those are found first and
    their runs measured at once (a prefix-AND over 32 byte compares).
    Lanes outside ``active`` count nothing."""
    lanes = win.shape[0]
    counts = torch.zeros((lanes, MAX_MATCH_LEN), dtype=I64, device=win.device)
    S = window - MAX_MATCH_LEN - 1
    if S <= 0:
        return counts
    first = win[:, 1:1 + S] == win[:, :1]
    if active is not None:
        first &= active[:, None]
    lane, j = first.nonzero(as_tuple=True)
    seg = win[lane[:, None], (j + 1)[:, None] + iota(MAX_MATCH_LEN, win.device)]
    run = (seg == win[lane, :MAX_MATCH_LEN]).cumprod(1)
    return counts.index_add_(0, lane, run)


def select_window32(win: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """win[l, bi[l] : bi[l]+32] for bi in [0, 32)."""
    return gather_window(win, bi, MAX_MATCH_LEN)


def _argmax_key(ok: torch.Tensor, level: torch.Tensor, active: torch.Tensor):
    ii = iota(MAX_MATCH_LEN, ok.device)[None, :]
    key = torch.where(ok, level * MAX_MATCH_LEN + ii, -1)
    return torch.where(active & ok.any(1), key.argmax(1) + 1, 1)


def best_match_sweep(counts: torch.Tensor, win: torch.Tensor, d: DictState,
                     active: torch.Tensor, params: X3Params) -> torch.Tensor:
    """The chosen new-fragment length >= 1 per lane (find_best_match,
    backend.c:56-100).  Veto-probe targets come from the resident window."""
    lanes = counts.shape[0]
    T = params.max_match_count
    if T < 1:
        return torch.ones((lanes,), dtype=I64, device=counts.device)

    ii = iota(MAX_MATCH_LEN, counts.device)[None, :]
    cand0 = counts >= 2
    level = (counts - 1).clamp(max=T)
    f1 = params.magic_factor1
    f2 = params.magic_factor2

    if f1 == 0 and f2 == 0:
        return _argmax_key(cand0, level, active)

    if f2 > 0:
        # the veto probes vl[o] do not depend on the candidate, so the
        # sweep is the argmax over the candidates no veto removes; f2's
        # "some o <= i" test is a running max of vl[o] - o
        vl = torch.zeros((lanes, MAX_MATCH_LEN), dtype=I64, device=counts.device)
        for o in range(1, MAX_MATCH_LEN):
            vl[:, o] = dict_probe_len(d, win[:, o:o + MAX_MATCH_LEN])
        veto = torch.zeros_like(cand0)
        if f1 > 0:
            veto = (ii >= 2) & (vl > 0) & (vl * f1 > ii + 1)
        x = torch.where(ii >= 1, vl - ii, -(1 << 20))
        pm = torch.cummax(x, dim=1).values
        veto = veto | ((ii >= 1) & (pm * f2 > ii + 1))
        return _argmax_key(cand0 & ~veto, level, active)

    # f1 only: take the best remaining candidate, probe the dictionary at
    # its offset, and drop it if vetoed, until every lane resolves
    result = torch.where(active, 0, 1)
    remaining = cand0.clone()
    lane = iota(lanes, counts.device)
    while bool((result == 0).any()):
        unresolved = result == 0
        key = torch.where(remaining, level * MAX_MATCH_LEN + ii, -1)
        has = remaining.any(1)
        best_i = key.argmax(1)
        # out of candidates -> fall back to length 1 (backend.c:99)
        result = torch.where(unresolved & ~has, 1, result)
        pending = unresolved & has
        dlen = dict_probe_len(d, select_window32(win, best_i))
        vetoed = pending & (best_i >= 2) & (dlen > 0) & (dlen * f1 > best_i + 1)
        result = torch.where(pending & ~vetoed, best_i + 1, result)
        remaining[lane, best_i] = remaining[lane, best_i] & ~vetoed
    return result
