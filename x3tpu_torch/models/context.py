"""Lane-parallel order-1/order-2 context tables with three-tier storage
(``x3tpu.models.context``; the tiers and the pair map folded into the
order-1 family are described in its docstring).

  * hub — context id 0, one full-capacity row per lane;
  * small pool — [S, CS] rows for ids >= 1;
  * promoted rows — [M, CB] big rows that a full small row moves to.

Every operation evaluates the three tiers and selects per lane, as the
JAX version does, so overflowed lanes behave identically too (clamped
rows, dropped writes).  :func:`ctx_update` writes the tables in place and
skips the scatters of a path that no lane takes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from x3tpu_torch.ops import iota

I64 = torch.int64


class CtxFamily(NamedTuple):
    hub_tags: torch.Tensor            # [L, H] context id 0
    hub_freqs: torch.Tensor           # [L, H]
    hub_pair: Optional[torch.Tensor]  # [L, H] | None (ctx1 family only)
    hub_n: torch.Tensor               # [L]
    tags: torch.Tensor                # [L, S, CS] small pool, id i at row i-1
    freqs: torch.Tensor               # [L, S, CS]
    pair: Optional[torch.Tensor]      # [L, S, CS] | None
    n: torch.Tensor                   # [L, S]
    promo: torch.Tensor               # [L, S] 0 = small; k > 0 = big row k-1
    big_tags: torch.Tensor            # [L, M, CB]
    big_freqs: torch.Tensor           # [L, M, CB]
    big_pair: Optional[torch.Tensor]  # [L, M, CB] | None
    big_n: torch.Tensor               # [L, M]
    promo_n: torch.Tensor             # [L] allocated big rows
    overflow: torch.Tensor            # bool [L]


class CtxView(NamedTuple):
    """Per-lane view of one context's table (tier resolved)."""

    cid: torch.Tensor      # [L]
    hub_sel: torch.Tensor  # bool [L]
    row: torch.Tensor      # [L] small row (cid-1 clamped)
    big_sel: torch.Tensor  # bool [L] promoted?
    brow: torch.Tensor     # [L] big row index (clamped)
    n: torch.Tensor        # [L] item count of the selected context


def promo_rows_for(pool_rows: int, promo_rows: int) -> int:
    """Big rows per family: ``promo_rows`` or the derived default."""
    return promo_rows or max(pool_rows // 8, 16)


def ctx_init(lanes: int, hub_cap: int, pool_rows: int, items_cap: int,
             with_pair: bool = False, small_cap: int = 16,
             promo_rows: int = 0, device="cpu") -> CtxFamily:
    M = promo_rows_for(pool_rows, promo_rows)
    small_cap = min(small_cap, items_cap)  # big rows must fit a small copy
    mk = lambda *s: torch.zeros(s, dtype=I64, device=device)
    return CtxFamily(
        hub_tags=mk(lanes, hub_cap), hub_freqs=mk(lanes, hub_cap),
        hub_pair=mk(lanes, hub_cap) if with_pair else None,
        hub_n=mk(lanes),
        tags=mk(lanes, pool_rows, small_cap),
        freqs=mk(lanes, pool_rows, small_cap),
        pair=mk(lanes, pool_rows, small_cap) if with_pair else None,
        n=mk(lanes, pool_rows), promo=mk(lanes, pool_rows),
        big_tags=mk(lanes, M, items_cap), big_freqs=mk(lanes, M, items_cap),
        big_pair=mk(lanes, M, items_cap) if with_pair else None,
        big_n=mk(lanes, M), promo_n=mk(lanes),
        overflow=torch.zeros((lanes,), dtype=torch.bool, device=device),
    )


def _lane(x: torch.Tensor) -> torch.Tensor:
    return iota(x.shape[0], x.device)


def ctx_view(fam: CtxFamily, cid: torch.Tensor) -> CtxView:
    lane = _lane(cid)
    hub_sel = cid == 0
    row = (cid - 1).clamp(0, fam.tags.shape[1] - 1)
    pr = fam.promo[lane, row]
    big_sel = ~hub_sel & (pr > 0)
    brow = (pr - 1).clamp(0, fam.big_tags.shape[1] - 1)
    n = torch.where(hub_sel, fam.hub_n,
                    torch.where(big_sel, fam.big_n[lane, brow], fam.n[lane, row]))
    return CtxView(cid, hub_sel, row, big_sel, brow, n)


def _tier(fam: CtxFamily, v: CtxView, hw: int):
    """The selected tier's place in the concatenated row [hub[:hw] | small
    row | big row]: its start per lane and the end of its live items (the
    count clamped to the tier's width, as x3tpu's per-tier masks clamp
    it)."""
    H = fam.hub_tags.shape[1]
    CS = fam.tags.shape[2]
    CB = fam.big_tags.shape[2]
    base = torch.where(v.hub_sel, 0, torch.where(v.big_sel, hw + CS, hw))
    width = torch.where(v.hub_sel, H, torch.where(v.big_sel, CB, CS))
    return base, base + torch.minimum(v.n, width), width


def _hub_width(fam: CtxFamily) -> int:
    """Hub columns worth reading: items past every lane's count are never
    live, so the hub is cut to the largest count (at least one column, for
    the unmasked read at item 0)."""
    return max(1, min(int(fam.hub_n.max()), fam.hub_tags.shape[1]))


def _cat_rows(hub: torch.Tensor, small: torch.Tensor, big: torch.Tensor,
              v: CtxView, hw: int) -> torch.Tensor:
    lane = _lane(v.cid)
    return torch.cat((hub[:, :hw], small[lane, v.row], big[lane, v.brow]), 1)


def ctx_find(fam: CtxFamily, v: CtxView, tag: torch.Tensor):
    """Locate ``tag`` in the context (ctx_query_tag_index, context.c:31-40).

    Returns (found, pos — insertion index == model symbol, pair_id — the
    (cid_tag, tag) pair's dense id; zeros for a family without pairs).  A
    tag that is absent gives pos 0 and the pair slot at the tier's item 0,
    as x3tpu's per-tier argmax does."""
    hw = _hub_width(fam)
    base, end, _ = _tier(fam, v, hw)
    rows = _cat_rows(fam.hub_tags, fam.tags, fam.big_tags, v, hw)
    ii = iota(rows.shape[1], tag.device)[None, :]
    m = (rows == tag[:, None]) & (ii >= base[:, None]) & (ii < end[:, None])
    found = m.any(1)
    at = torch.where(found, m.to(torch.uint8).argmax(1), base)
    pos = at - base
    if fam.hub_pair is None:
        return found, pos, torch.zeros_like(pos)
    pairs = _cat_rows(fam.hub_pair, fam.pair, fam.big_pair, v, hw)
    return found, pos, pairs.gather(1, at[:, None])[:, 0]


def ctx_encode_stats(fam: CtxFamily, v: CtxView, pos: torch.Tensor):
    """(low_f, span, total) of coding the item at ``pos`` through the
    context's throwaway model (context.c:95-133).  ``span`` is read at
    min(pos, width - 1) of the tier, live or not."""
    # the span read below may fall past the live items
    hw = max(_hub_width(fam), min(int(pos.max()) + 1, fam.hub_tags.shape[1]))
    base, end, width = _tier(fam, v, hw)
    rows = _cat_rows(fam.hub_freqs, fam.freqs, fam.big_freqs, v, hw)
    ii = iota(rows.shape[1], pos.device)[None, :]
    live = rows * ((ii >= base[:, None]) & (ii < end[:, None]))
    at = base + torch.minimum(pos, width - 1)
    low = (live * (ii < at[:, None])).sum(1)
    return low, rows.gather(1, at[:, None])[:, 0], live.sum(1)


def ctx_decode_pos(fam: CtxFamily, v: CtxView, value: torch.Tensor):
    """The item whose cumulative interval in the context's throwaway model
    holds ``value`` (index_of_value, ac.c:167-179): pos = (number of live
    items with cum <= value) - 1, at least 0.  Returns (pos, tag at pos,
    low_f, span); past the live items the span is 0."""
    hw = _hub_width(fam)
    base, end, _ = _tier(fam, v, hw)
    freqs = _cat_rows(fam.hub_freqs, fam.freqs, fam.big_freqs, v, hw)
    ii = iota(freqs.shape[1], value.device)[None, :]
    live = (ii >= base[:, None]) & (ii < end[:, None])
    f = freqs * live             # zero outside the tier: cum starts at base
    cum = f.cumsum(1) - f
    pos = ((live & (cum <= value[:, None])).sum(1) - 1).clamp(min=0)
    at = (base + pos)[:, None]
    tags = _cat_rows(fam.hub_tags, fam.tags, fam.big_tags, v, hw)
    return (pos, tags.gather(1, at)[:, 0], cum.gather(1, at)[:, 0],
            f.gather(1, at)[:, 0])


def _any(mask: torch.Tensor) -> bool:
    """Whether any lane takes a masked update (lets a pass with nothing to
    write skip its scatters)."""
    return bool(mask.any())


def _set(t: torch.Tensor, idx: Tuple[torch.Tensor, ...], val, do) -> None:
    """t[idx] = val where ``do`` (the JAX version's drop-mode scatter)."""
    t[idx] = torch.where(do, val, t[idx])


def ctx_update(fam: CtxFamily, v: CtxView, tag: torch.Tensor,
               found: torch.Tensor, pos: torch.Tensor, active: torch.Tensor,
               new_pair_id: Optional[torch.Tensor] = None) -> CtxFamily:
    """Post-event update: bump the tag's freq, or append it with freq 1
    (x3.c:197-209).  A small row that fills up is promoted: its items are
    copied into a freshly allocated big row and the context redirected.
    ``new_pair_id`` (ctx1 family) is stored in an appended item's pair slot
    — the reference's tag_pair_add (x3.c:213-222)."""
    H = fam.hub_tags.shape[1]
    S, CS = fam.tags.shape[1:]
    M, CB = fam.big_tags.shape[1:]
    lane = _lane(tag)
    app = active & ~found
    inc = active & found

    # ---------- hub path
    hub_room = fam.hub_n < H
    if _any(v.hub_sel & inc):
        hi = pos.clamp(max=H - 1)
        _set(fam.hub_freqs, (lane, hi), fam.hub_freqs[lane, hi] + 1,
             v.hub_sel & inc)
    happ = v.hub_sel & app & hub_room
    if _any(happ):
        ha = fam.hub_n.clamp(max=H - 1)
        _set(fam.hub_tags, (lane, ha), tag, happ)
        _set(fam.hub_freqs, (lane, ha), 1, happ)
        if new_pair_id is not None:
            _set(fam.hub_pair, (lane, ha), new_pair_id, happ)
    hub_n = fam.hub_n + happ.to(I64)

    # ---------- promotion: small row full and this append needs a big row
    need_promo = ~v.hub_sel & ~v.big_sel & app & (v.n >= CS)
    do_promo = need_promo & (fam.promo_n < M)
    new_brow = fam.promo_n.clamp(max=M - 1)
    if _any(do_promo):
        dp = do_promo[:, None]
        pad = lambda x: torch.nn.functional.pad(x, (0, CB - CS))
        _set(fam.big_tags, (lane, new_brow), pad(fam.tags[lane, v.row]), dp)
        _set(fam.big_freqs, (lane, new_brow), pad(fam.freqs[lane, v.row]), dp)
        if new_pair_id is not None:
            _set(fam.big_pair, (lane, new_brow), pad(fam.pair[lane, v.row]), dp)
        _set(fam.big_n, (lane, new_brow), v.n, do_promo)
        _set(fam.promo, (lane, v.row), new_brow + 1, do_promo)
    promo_n = fam.promo_n + do_promo.to(I64)
    big_now = v.big_sel | do_promo
    brow_now = torch.where(do_promo, new_brow, v.brow)

    # ---------- small path (not promoted)
    sdo = ~v.hub_sel & ~big_now
    if _any(sdo & inc):
        si = pos.clamp(max=CS - 1)
        _set(fam.freqs, (lane, v.row, si), fam.freqs[lane, v.row, si] + 1,
             sdo & inc)
    sapp = sdo & app
    if _any(sapp):
        sa = v.n.clamp(max=CS - 1)
        _set(fam.tags, (lane, v.row, sa), tag, sapp)
        _set(fam.freqs, (lane, v.row, sa), 1, sapp)
        if new_pair_id is not None:
            _set(fam.pair, (lane, v.row, sa), new_pair_id, sapp)
        _set(fam.n, (lane, v.row), fam.n[lane, v.row] + 1, sapp)

    # ---------- big path (promoted earlier or just now)
    bdo = ~v.hub_sel & big_now
    big_room = v.n < CB
    if _any(bdo & inc):
        bi = pos.clamp(max=CB - 1)
        _set(fam.big_freqs, (lane, brow_now, bi),
             fam.big_freqs[lane, brow_now, bi] + 1, bdo & inc)
    bapp = bdo & app & big_room
    if _any(bapp):
        ba = v.n.clamp(max=CB - 1)
        _set(fam.big_tags, (lane, brow_now, ba), tag, bapp)
        _set(fam.big_freqs, (lane, brow_now, ba), 1, bapp)
        if new_pair_id is not None:
            _set(fam.big_pair, (lane, brow_now, ba), new_pair_id, bapp)
        _set(fam.big_n, (lane, brow_now), fam.big_n[lane, brow_now] + 1, bapp)

    overflow = fam.overflow | (
        (v.hub_sel & app & ~hub_room)
        | (need_promo & ~do_promo)
        | (bdo & app & ~big_room)
    )
    return fam._replace(hub_n=hub_n, promo_n=promo_n, overflow=overflow)
