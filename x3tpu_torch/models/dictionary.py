"""Lane-parallel fragment dictionary with recency ranking
(``x3tpu.models.dictionary``; design notes in its docstring).

Entries are stored by insertion slot (slot == tag); the recency order is
the permutation pair ``rank_of`` / ``tag_of``, updated by move-to-front.
``strs`` and ``lens`` are written in place on insert.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from x3tpu_torch.config import MAX_MATCH_LEN
from x3tpu_torch.ops import const, iota

I64 = torch.int64


class DictState(NamedTuple):
    strs: torch.Tensor      # u8 [L, D, 32] fragment bytes by insertion slot
    lens: torch.Tensor      # int64 [L, D]
    n: torch.Tensor         # int64 [L] number of entries
    rank_of: torch.Tensor   # int64 [L, D] tag -> recency rank
    tag_of: torch.Tensor    # int64 [L, D] recency rank -> tag
    overflow: torch.Tensor  # bool [L]


def dict_init(lanes: int, cap: int, device="cpu") -> DictState:
    z = lambda *s: torch.zeros(s, dtype=I64, device=device)
    return DictState(
        strs=torch.zeros((lanes, cap, MAX_MATCH_LEN), dtype=torch.uint8,
                         device=device),
        lens=z(lanes, cap), n=z(lanes), rank_of=z(lanes, cap),
        tag_of=z(lanes, cap),
        overflow=torch.zeros((lanes,), dtype=torch.bool, device=device),
    )


# _BYTE_MASKS[b]: the low b bytes of a 64-bit word
_BYTE_MASKS = tuple((1 << (8 * b)) - 1 for b in range(8)) + (-1,)


def _prefix_ok(d: DictState, target: torch.Tensor):
    """(k, ok [L, k]): which live entries are a prefix of ``target``.

    Entries at or past every lane's count are all-zero rows that never
    match, so only the k rows below the largest count are looked at.  Only
    the live entries whose first byte is the target's can match; those are
    compared whole, eight bytes at a time: an entry matches when its first
    ``lens`` bytes equal the target's."""
    lanes = d.lens.shape[0]
    k = int(d.n.max()) if lanes else 0
    lens = d.lens[:, :k]
    first = ((d.strs[:, :k, 0] == target[:, :1]) & (lens > 0)
             & (iota(k, lens.device)[None, :] < d.n[:, None]))
    lane, e = first.nonzero(as_tuple=True)
    # a copy: a one-row slice is contiguous at any offset, and an int64
    # view needs one that is a multiple of 8
    x = (d.strs[lane, e].view(I64)
         ^ target.clone(memory_format=torch.contiguous_format)
         .view(I64)[lane])                                      # [m, 4]
    nbytes = (lens[lane, e][:, None] - 8 * iota(4, lens.device)).clamp(0, 8)
    masks = const(_BYTE_MASKS, lens.device)[nbytes]
    ok = torch.zeros_like(first)
    ok[lane, e] = ((x & masks) == 0).all(1)
    return k, ok


def dict_probe_ok(d: DictState, target: torch.Tensor):
    """The encoder's probe: (found, slot, best_len, ok) where ``ok``
    [L, k] marks the entries that prefix ``target`` (see
    :func:`dict_has_exact_ok`)."""
    k, ok = _prefix_ok(d, target)
    cand = d.lens[:, :k] * ok
    if k:
        best_len, slot = cand.amax(1), cand.argmax(1)
    else:
        best_len = slot = torch.zeros_like(d.n)
    return best_len > 0, slot, best_len, ok


def dict_has_exact_ok(d: DictState, ok: torch.Tensor,
                      frag_len: torch.Tensor) -> torch.Tensor:
    """dict_has_exact from :func:`dict_probe_ok`'s ``ok``: an entry of the
    fragment's length that prefixes the probe target equals it."""
    return (ok & (d.lens[:, :ok.shape[1]] == frag_len[:, None])).any(1)


def dict_probe(d: DictState, target: torch.Tensor):
    """Longest-prefix probe of ``target`` u8 [L, 32] against all entries.

    Returns (found [L] bool, slot [L] — the matching entry's tag, best_len
    [L], matchlen [L, D] — per-entry shared-prefix length).  The longest
    match is unique (entries are distinct strings), so argmax needs no
    tie-break."""
    found, slot, best_len, _ = dict_probe_ok(d, target)
    mism = d.strs != target[:, None, :]                       # [L, D, 32]
    matchlen = torch.where(mism.any(2), mism.to(torch.uint8).argmax(2),
                           MAX_MATCH_LEN).to(I64)
    return found, slot, best_len, matchlen


def dict_probe_len(d: DictState, target: torch.Tensor) -> torch.Tensor:
    """Best-match length only (the magic-factor vetoes); 0 when none."""
    return dict_probe_ok(d, target)[2]


def dict_has_exact(d: DictState, matchlen: torch.Tensor,
                   frag_len: torch.Tensor) -> torch.Tensor:
    """Whether an entry equals the fragment exactly, given ``matchlen`` from
    a probe at the fragment's position."""
    cap = d.lens.shape[1]
    valid = iota(cap, d.lens.device)[None, :] < d.n[:, None]
    dup = (valid & (d.lens == frag_len[:, None])
           & (matchlen >= frag_len[:, None]))
    return dup.any(1)


def dict_mtf(d: DictState, tag: torch.Tensor, active: torch.Tensor) -> DictState:
    """Move entry ``tag`` to recency rank 0 (dict.c:132-146), in place.
    Only ranks below a lane's count move, so only the columns below the
    largest count are touched."""
    lanes = d.lens.shape[0]
    k = max(1, int(d.n.max()))
    lane = iota(lanes, tag.device)
    tag = tag.clamp(max=k - 1)   # a live tag already is; others are masked
    rank_of, tag_of = d.rank_of[:, :k], d.tag_of[:, :k]
    r = rank_of[lane, tag]
    ii = iota(k, tag.device)[None, :]
    bump = (ii < d.n[:, None]) & active[:, None] & (rank_of < r[:, None])
    move = active[:, None] & (ii <= r[:, None])
    shifted = torch.roll(tag_of, 1, dims=1)
    rank_of += bump
    rank_of[lane, tag] = rank_of[lane, tag] * ~active
    tag_of.copy_(torch.where(move, shifted, tag_of))
    tag_of[:, 0] = torch.where(active, tag, tag_of[:, 0])
    return d


def dict_insert(d: DictState, frag: torch.Tensor, frag_len: torch.Tensor,
                active: torch.Tensor) -> Tuple[DictState, torch.Tensor]:
    """Append a fragment as a new entry (tag = n) at recency rank 0
    (dict.c:91-103), in place.  A full dictionary drops the insert and sets
    ``overflow``.  Past a lane's count ``tag_of`` is zero, so shifting it
    touches only the columns up to the largest count.  Returns (state,
    new_tag)."""
    lanes, cap = d.lens.shape
    lane = iota(lanes, frag.device)
    do = active & (d.n < cap)
    slot = d.n.clamp(max=cap - 1)
    d.strs[lane, slot] = torch.where(do[:, None], frag, d.strs[lane, slot])
    d.lens[lane, slot] = torch.where(do, frag_len, d.lens[lane, slot])
    k = min(cap, int(d.n.max()) + 1)
    rank_of, tag_of = d.rank_of[:, :k], d.tag_of[:, :k]
    ii = iota(k, frag.device)[None, :]
    shifted = torch.roll(tag_of, 1, dims=1)
    rank_of += do[:, None] & (ii < d.n[:, None])
    rank_of[lane, slot] = rank_of[lane, slot] * ~do
    tag_of.copy_(torch.where(do[:, None] & (ii > 0), shifted, tag_of))
    tag_of[:, 0] = torch.where(do, slot, tag_of[:, 0])
    return d._replace(n=d.n + do, overflow=d.overflow | (active & ~do)), slot
