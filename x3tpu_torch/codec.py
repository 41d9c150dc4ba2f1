"""The lane-batched x3 encoder and decoder in plain PyTorch: the port of
x3tpu's XLA engine (``x3tpu.codec``) and the plain versions of the CUDA
kernels K1 and K2 (``x3tpu_torch.vm.driver``).

One event per iteration across all L lanes (independent blocks) in
lockstep, with masked sub-loops for literal bytes and arithmetic-coder
renormalization.  Encoder (compress loop, x3.c:372-434):

  probe -> window scan -> threshold sweep -> hit/miss decision ->
  mode selection by f32 product probabilities (x3.c:150-172) ->
  AC-code event + payload (+ literal bytes) -> dictionary MTF/insert ->
  context updates -> advance.

Decoder (decompress loop, x3.c:285-353):

  event symbol -> literal length and bytes | hit payload by mode (ctx0
  item, ctx1 item, recency rank) -> context updates -> dictionary
  MTF/insert (duplicate check) -> output bytes.

State is fixed-shape (capacities from ``CodecCaps``) with the XLA engine's
capacity semantics: writes that would exceed a capacity are dropped and
set a sticky per-lane overflow flag, so the host can re-run larger.  u32
values are held in int64; large tables are updated in place.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from x3tpu_torch import warm as wm
from x3tpu_torch.config import (
    CodecCaps,
    E_CTX0,
    E_CTX1,
    E_EOF,
    E_IDX1,
    E_LAST,
    E_NEW,
    EVENT_INIT_FREQS,
    MAX_MATCH_LEN,
    X3Params,
)
from x3tpu_torch.models import adaptive as am
from x3tpu_torch.models import context as cm
from x3tpu_torch.models import dictionary as dm
from x3tpu_torch.ops import ac as acm
from x3tpu_torch.ops import bitio, const, iota
from x3tpu_torch.ops.match import best_match_sweep, gather_window, window_counts

I64 = torch.int64
F32 = torch.float32


class Overflow(NamedTuple):
    """Sticky per-lane capacity-overflow flags."""

    dict: torch.Tensor
    ctx0: torch.Tensor
    ctx1: torch.Tensor
    pairs: torch.Tensor
    out: torch.Tensor

    def any_flag(self) -> torch.Tensor:
        return self.dict | self.ctx0 | self.ctx1 | self.pairs | self.out


class EncCarry(NamedTuple):
    text: torch.Tensor     # u8 [L, TB]
    tlen: torch.Tensor     # [L]
    p: torch.Tensor        # [L]
    prev_c1: torch.Tensor  # [L]
    c1: torch.Tensor       # [L]
    d: dm.DictState
    ctx0: cm.CtxFamily
    ctx1: cm.CtxFamily
    pair_n: torch.Tensor   # [L]
    ev: torch.Tensor       # [L, 5]
    ms: torch.Tensor       # [L, 32]
    ch: torch.Tensor       # [L, 256]
    ix: torch.Tensor       # [L, D]
    enc: acm.AcEnc
    sink: bitio.BitSink
    counts: torch.Tensor   # [L, 5] event counters (stats, x3.c:42)
    sizes: torch.Tensor    # f32 [L, 5] estimated coded bits (x3.c:43)
    pair_of: torch.Tensor  # bool [L]


def check_seeds(seeds, caps: CodecCaps, warm=None) -> int:
    """The number of seeds K of ``seeds`` ((strs u8 [K, 32], lens i32 [K])
    or None: 0); more seeds than ``caps.dict_cap``, and a warm state
    ``warm`` without seeds (its tape indexes them), raise ValueError."""
    if seeds is None:
        if warm is not None:
            raise ValueError("warm start requires dictionary seeds")
        return 0
    k = int(seeds[0].shape[0])
    if k > caps.dict_cap:
        raise ValueError(f"{k} dictionary seeds but dict_cap "
                         f"{caps.dict_cap}")
    return k


def warm_tables(warm, caps: CodecCaps):
    """The warm state ``warm`` (``x3tpu_torch.warm.WarmArrays``) as the
    tables of one lane (``x3tpu_torch.warm.dense``), rows as wide as both
    families' small pools.  Raises ValueError where ``caps`` cannot hold
    it (``warm.check_fits``; the hubs are ``dict_cap`` wide)."""
    width = min(caps.ctx_small_cap, caps.ctx_items_cap, caps.ctx0_items_cap)
    wm.check_fits(warm, caps.dict_cap, caps.pair_cap, width, caps.dict_cap)
    return wm.dense(warm, width)


def _warm_family(fam: cm.CtxFamily, hub: dict, pool: dict) -> cm.CtxFamily:
    """``fam`` (zeroed) with the warm ``hub`` row and small-pool rows
    ``pool`` (:func:`warm_tables`) written into every lane."""
    dev = fam.hub_tags.device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(I64)
    h, rows, w = hub["n"], t(pool["rows"]), pool["t"].shape[1]
    fam.hub_tags[:, :h] = t(hub["t"])
    fam.hub_freqs[:, :h] = t(hub["f"])
    if fam.hub_pair is not None:
        fam.hub_pair[:, :h] = t(hub["p"])
    fam.tags[:, rows, :w] = t(pool["t"])
    fam.freqs[:, rows, :w] = t(pool["f"])
    if fam.pair is not None:
        fam.pair[:, rows, :w] = t(pool["p"])
    fam.n[:, rows] = t(pool["n"])
    return fam._replace(hub_n=torch.full_like(fam.hub_n, h))


def _init_shared(lanes: int, caps: CodecCaps, device, seeds=None, warm=None):
    """Every lane's starting state.  ``seeds`` (strs u8 [K, 32], lens i32
    [K]; x3tpu/codec.py:89-125): every lane starts with the same K
    fragments in its dictionary, tags 0..K-1 at recency ranks 0..K-1, and
    one index-model symbol of freq 1 each.  ``warm``
    (``x3tpu_torch.warm.WarmArrays`` replayed from the tape over those
    seeds; x3tpu/codec.py:125-153): both context families start with its
    hub rows, small-pool rows and hub counts (the pair count is the
    carries').  Encoder and decoder must take the same seeds and warm
    state (the container carries both)."""
    k = check_seeds(seeds, caps, warm)
    tables = None if warm is None else warm_tables(warm, caps)
    d = dm.dict_init(lanes, caps.dict_cap, device)
    if k:
        ii = torch.arange(caps.dict_cap, device=device)
        d.strs[:, :k] = torch.as_tensor(seeds[0], dtype=torch.uint8,
                                        device=device)
        d.lens[:, :k] = torch.as_tensor(seeds[1], device=device).to(I64)
        d.rank_of.copy_(ii.expand(lanes, -1))
        d.tag_of.copy_(ii.expand(lanes, -1))
        d = d._replace(n=torch.full((lanes,), k, dtype=I64, device=device))
    ctx0 = cm.ctx_init(
        lanes, caps.dict_cap, caps.pair_cap, caps.ctx0_items_cap,
        with_pair=False, small_cap=caps.ctx_small_cap,
        promo_rows=caps.ctx_promo_rows, device=device,
    )
    ctx1 = cm.ctx_init(
        lanes, caps.dict_cap, caps.dict_cap, caps.ctx_items_cap,
        with_pair=True, small_cap=caps.ctx_small_cap,
        promo_rows=caps.ctx_promo_rows, device=device,
    )
    ev = torch.tensor(EVENT_INIT_FREQS, dtype=I64, device=device).repeat(lanes, 1)
    ms = torch.ones((lanes, MAX_MATCH_LEN), dtype=I64, device=device)
    ch = torch.ones((lanes, 256), dtype=I64, device=device)
    ix = torch.zeros((lanes, caps.dict_cap), dtype=I64, device=device)
    ix[:, :k] = 1
    if tables is not None:
        ctx0 = _warm_family(ctx0, tables["h0"], tables["c0"])
        ctx1 = _warm_family(ctx1, tables["h1"], tables["c1"])
    return d, ctx0, ctx1, ev, ms, ch, ix


def _bits(prob: torch.Tensor) -> torch.Tensor:
    """prob_to_bits (x3.c:52-55): f32 -log2."""
    return -torch.log2(prob.clamp(min=1e-38))


def _nl(dlen: torch.Tensor, params: X3Params) -> torch.Tensor:
    """The -x length remap (x3.c:357-370), vectorized."""
    if not params.nl_remap:
        return dlen
    lut = const((1, 4, 6, 8), dlen.device)
    return torch.where(dlen <= 4, lut[(dlen - 1).clamp(0, 3)], 9999)


def _hit_mode_stats(carry: EncCarry, tag: torch.Tensor, rank: torch.Tensor):
    """Resolve contexts and pick the cheapest coding mode for a dictionary
    hit by f32 product probability (x3.c:139-172)."""
    # pair (prev_c1, c1) -> ctx0 id; unknown -> 0 (x3.c:141-145)
    v_pair = cm.ctx_view(carry.ctx1, carry.prev_c1)
    pair_found, _, pair_id = cm.ctx_find(carry.ctx1, v_pair, carry.c1)
    cid0 = torch.where(pair_found, pair_id, 0)

    v0 = cm.ctx_view(carry.ctx0, cid0)
    f0, pos0, _ = cm.ctx_find(carry.ctx0, v0, tag)
    low0, span0, tot0 = cm.ctx_encode_stats(carry.ctx0, v0, pos0)

    v1 = cm.ctx_view(carry.ctx1, carry.c1)
    f1, pos1, _ = cm.ctx_find(carry.ctx1, v1, tag)
    low1, span1, tot1 = cm.ctx_encode_stats(carry.ctx1, v1, pos1)

    # index-model entries past every lane's dictionary count are zero
    kx = max(1, int(carry.d.n.max()))
    ixlow, ixspan, ixtot = am.model_encode_stats(carry.ix[:, :kx], rank)

    # the three modes' f32 products of f32 quotients, columns CTX0, CTX1,
    # IDX1 (E_CTX0, E_CTX1, E_IDX1 are 0, 1, 2)
    p_ev = am.f32_prob(carry.ev[:, :3], carry.ev.sum(1, keepdim=True))
    p_sym = am.f32_prob(torch.stack((span0, span1, ixspan), 1),
                        torch.stack((tot0, tot1, ixtot), 1).clamp(min=1))
    found = torch.stack((f0, f1, torch.ones_like(f0)), 1)
    prob0, prob1, probx = torch.where(found, p_ev * p_sym, 0.0).unbind(1)

    # strict-greater chain, IDX1 -> CTX0 -> CTX1 (x3.c:162-172)
    take0 = prob0 > probx
    mode = torch.where(take0, E_CTX0, E_IDX1)
    best = torch.where(take0, prob0, probx)
    take1 = prob1 > best
    mode = torch.where(take1, E_CTX1, mode)
    best = torch.where(take1, prob1, best)
    return dict(
        mode=mode, best_prob=best,
        v0=v0, f0=f0, pos0=pos0, low0=low0, span0=span0, tot0=tot0,
        v1=v1, f1=f1, pos1=pos1, low1=low1, span1=span1, tot1=tot1,
        ixlow=ixlow, ixspan=ixspan, ixtot=ixtot,
    )


def _literal_encode_loop(carry: EncCarry, miss: torch.Tensor,
                         mlen: torch.Tensor, frag32: torch.Tensor):
    """AC-code the fragment bytes through the 256-symbol char model
    (x3.c:263-267).  Byte k's interval is the base interval plus counts of
    earlier equal/smaller bytes of the same fragment, so the sub-loop runs
    bare AC steps and the model takes one histogram update."""
    W = MAX_MATCH_LEN
    dev = miss.device
    frag = frag32.to(I64)                                        # [L, 32]
    cum = carry.ch.cumsum(1) - carry.ch                          # excl prefix
    base_low = cum.gather(1, frag)
    base_span = carry.ch.gather(1, frag)
    base_total = carry.ch.sum(1)
    iw = iota(W, dev)
    jlt = (iw[:, None] < iw[None, :])[None]                      # j < k
    bj = frag[:, :, None]
    bk = frag[:, None, :]
    low_k = base_low + (jlt & (bj < bk)).sum(1)
    span_k = base_span + (jlt & (bj == bk)).sum(1)
    tot_k = base_total[:, None] + iw[None, :]
    inmask = miss[:, None] & (iw[None, :] < mlen[:, None])

    enc, sink = carry.enc, carry.sink
    for k in range(int(torch.where(miss, mlen, 0).max())):
        enc, sink = acm.ac_encode(enc, sink, low_k[:, k],
                                  low_k[:, k] + span_k[:, k], tot_k[:, k],
                                  miss & (k < mlen))

    ch = carry.ch.scatter_add(1, frag, inmask.to(I64))
    nbits = torch.where(inmask, _bits(span_k.to(F32) / tot_k.to(F32)), 0.0).sum(1)
    return ch, enc, sink, nbits


def _enc_body(carry: EncCarry, params: X3Params) -> EncCarry:
    """One event on every lane (x3tpu.codec._enc_body).  The hit-only and
    miss-only parts are skipped when no lane takes them: their results are
    masked out on every lane then, so skipping changes nothing."""
    lanes = carry.p.shape[0]
    lane = iota(lanes, carry.p.device)
    active = carry.p < carry.tlen

    # one window fetch per event feeds the probe target, the window scan,
    # the veto targets and the literal bytes
    W = max(params.window, MAX_MATCH_LEN)
    Wbuf = ((max(W, 2 * MAX_MATCH_LEN) + MAX_MATCH_LEN + 127) // 128) * 128
    win = gather_window(carry.text, carry.p, Wbuf)
    t32 = win[:, :MAX_MATCH_LEN]

    # (1) dictionary probe at p (x3.c:381)
    found, slot, dlen, ok = dm.dict_probe_ok(carry.d, t32)

    # (2) forward-window probe (x3.c:383 -> backend.c:56)
    counts = window_counts(win, params.window, active)
    fbm = best_match_sweep(counts, win, carry.d, active, params)

    # (3) selection (x3.c:381-383)
    hit = (active & found & (_nl(dlen, params) >= fbm)
           & (carry.p + dlen <= carry.tlen))
    miss = active & ~hit
    mlen = torch.minimum(fbm, carry.tlen - carry.p).clamp(1, MAX_MATCH_LEN)
    any_hit = bool(hit.any())
    any_miss = bool(miss.any())
    tag = slot

    # (4) event symbol
    if any_hit:
        rank = carry.d.rank_of[lane, tag]
        st = _hit_mode_stats(carry, tag, rank)
        esym = torch.where(hit, st["mode"], E_NEW)
    else:
        esym = torch.full_like(tag, E_NEW)
    elow, espan, etot = am.model_encode_stats(carry.ev, esym)
    enc, sink = acm.ac_encode(carry.enc, carry.sink, elow, elow + espan, etot,
                              active)
    ev = am.model_inc(carry.ev, esym, active)
    counts_arr = am.model_inc(carry.counts, esym, active)

    # (5) payload symbol: ctx0 item | ctx1 item | recency rank | length-1
    msst = am.model_encode_stats(carry.ms, mlen - 1)
    plow, pspan, ptot = msst
    ix = carry.ix
    if any_hit:
        is0 = esym == E_CTX0      # esym is a hit mode on hit lanes only
        is1 = esym == E_CTX1
        isx = esym == E_IDX1
        plow, pspan, ptot = (
            torch.where(is0, a, torch.where(is1, b, torch.where(isx, x, m)))
            for a, b, x, m in zip(
                (st["low0"], st["span0"], st["tot0"]),
                (st["low1"], st["span1"], st["tot1"]),
                (st["ixlow"], st["ixspan"], st["ixtot"]),
                msst,
            )
        )
        ix = am.model_inc(ix, rank, isx)
    enc, sink = acm.ac_encode(enc, sink, plow, plow + pspan, ptot, active)
    ms = am.model_inc(carry.ms, mlen - 1, miss)

    # (6) literal bytes (miss lanes)
    ch = carry.ch
    if any_miss:
        ch, enc, sink, lit_bits = _literal_encode_loop(
            carry._replace(enc=enc, sink=sink), miss, mlen, t32
        )

    # stats: hit events log the product probability once (x3.c:192-193);
    # E_NEW logs event + length + byte bits separately (x3.c:253-264)
    add = torch.zeros_like(carry.sizes[:, 0])
    if any_miss:
        ev_bits = _bits(am.f32_prob(espan, etot))
        ms_bits = _bits(am.f32_prob(msst[1], msst[2]))
        add = torch.where(miss, ev_bits + ms_bits + lit_bits, add)
    if any_hit:
        add = torch.where(hit, _bits(st["best_prob"]), add)
    sizes = carry.sizes.index_put_((lane, esym), add, accumulate=True)

    # (7) dictionary update: MTF on hit; insert on miss unless duplicate
    d = carry.d
    if any_hit:
        d = dm.dict_mtf(d, tag, hit)
    if any_miss:
        ins = miss & ~dm.dict_has_exact_ok(carry.d, ok, mlen)
        if bool(ins.any()):
            nidx = carry.d.n.clamp(max=ix.shape[1] - 1)
            ix[lane, nidx] = torch.where(ins & (carry.d.n < ix.shape[1]), 1,
                                         ix[lane, nidx])
            d, _ = dm.dict_insert(d, t32, mlen, ins)

    # (8) context updates + pair registration (hit lanes, x3.c:195-222)
    ctx0, ctx1 = carry.ctx0, carry.ctx1
    pair_of, pair_n = carry.pair_of, carry.pair_n
    if any_hit:
        ctx0 = cm.ctx_update(ctx0, st["v0"], tag, st["f0"], st["pos0"], hit)
        ctx1 = cm.ctx_update(ctx1, st["v1"], tag, st["f1"], st["pos1"], hit,
                             new_pair_id=pair_n)
        new_pair = hit & ~st["f1"]
        # pair ids run 0..S (0 = hub); flag when the id about to be
        # assigned is the last representable one, one early, so a clamped
        # row index can never alias a live context before the sticky flag
        # is set
        pair_of = pair_of | (new_pair & (pair_n >= ctx0.tags.shape[1]))
        pair_n = pair_n + new_pair

    # (9) advance
    prev_c1 = torch.where(hit, carry.c1, carry.prev_c1 * ~miss)
    c1 = torch.where(hit, tag, carry.c1 * ~miss)
    p = carry.p + torch.where(hit, dlen, mlen * miss)

    return EncCarry(
        carry.text, carry.tlen, p, prev_c1, c1, d, ctx0, ctx1, pair_n,
        ev, ms, ch, ix, enc, sink, counts_arr, sizes, pair_of,
    )


def _pair_n0(lanes: int, dev, warm) -> torch.Tensor:
    """Every lane's starting pair count: the warm state's, else 0."""
    return torch.full((lanes,), 0 if warm is None else int(warm.pair_n),
                      dtype=I64, device=dev)


def enc_init_carry(text: torch.Tensor, tlen: torch.Tensor, params: X3Params,
                   caps: CodecCaps, seeds=None, warm=None) -> EncCarry:
    """Initial encoder carry for L blocks.  ``text`` u8 [L, TB] must be
    zero-padded past each block (:func:`pack_blocks`); ``seeds`` and
    ``warm`` as :func:`_init_shared` takes them."""
    lanes = text.shape[0]
    dev = text.device
    d, ctx0, ctx1, ev, ms, ch, ix = _init_shared(lanes, caps, dev, seeds,
                                                 warm)
    z = lambda: torch.zeros((lanes,), dtype=I64, device=dev)
    return EncCarry(
        text=text, tlen=tlen.to(I64), p=z(), prev_c1=z(), c1=z(),
        d=d, ctx0=ctx0, ctx1=ctx1, pair_n=_pair_n0(lanes, dev, warm),
        ev=ev, ms=ms, ch=ch, ix=ix,
        enc=acm.enc_init(lanes, dev),
        sink=bitio.sink_init(lanes, caps.out_words, dev),
        counts=torch.zeros((lanes, E_LAST), dtype=I64, device=dev),
        sizes=torch.zeros((lanes, E_LAST), dtype=F32, device=dev),
        pair_of=torch.zeros((lanes,), dtype=torch.bool, device=dev),
    )


def enc_active(carry: EncCarry) -> bool:
    """Any lane still encoding."""
    return bool((carry.p < carry.tlen).any())


def enc_chunk(carry: EncCarry, params: X3Params, nsteps: int) -> EncCarry:
    """Run up to ``nsteps`` events."""
    for _ in range(nsteps):
        if not enc_active(carry):
            break
        carry = _enc_body(carry, params)
    return carry


def enc_finalize(carry: EncCarry):
    """EOF + flush (x3.c:432-433, x3.c:603); returns
    (words, byte_lens, counts, sizes, overflow)."""
    lanes = carry.p.shape[0]
    every = torch.ones((lanes,), dtype=torch.bool, device=carry.p.device)
    eofsym = torch.full((lanes,), E_EOF, dtype=I64, device=carry.p.device)
    elow, espan, etot = am.model_encode_stats(carry.ev, eofsym)
    enc, sink = acm.ac_encode(carry.enc, carry.sink, elow, elow + espan, etot,
                              every)
    sink = acm.ac_flush(enc, sink, every)
    overflow = Overflow(
        dict=carry.d.overflow, ctx0=carry.ctx0.overflow,
        ctx1=carry.ctx1.overflow, pairs=carry.pair_of, out=sink.overflow,
    )
    return sink.words, bitio.sink_byte_len(sink), carry.counts, carry.sizes, overflow


@torch.inference_mode()
def encode_blocks_chunked(text, tlen, params: X3Params, caps: CodecCaps,
                          seeds=None, warm=None):
    """Encode L blocks: ``text`` u8 [L, TB] and ``tlen`` [L] (tensors or
    arrays; the work runs on ``text``'s device), every lane from the
    dictionary ``seeds`` (strs u8 [K, 32], lens i32 [K]) and the warm
    state ``warm`` (``x3tpu_torch.warm.WarmArrays``) where given.
    Returns (words u32-in-int64 [L, out_words], byte_lens, counts, sizes,
    Overflow)."""
    text = torch.as_tensor(text)
    tlen = torch.as_tensor(tlen, device=text.device)
    carry = enc_init_carry(text, tlen, params, caps, seeds, warm)
    while enc_active(carry):
        carry = _enc_body(carry, params)
    return enc_finalize(carry)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class DecCarry(NamedTuple):
    out: torch.Tensor      # u8 [L, OB]
    opos: torch.Tensor     # [L]
    done: torch.Tensor     # bool [L]
    prev_c1: torch.Tensor  # [L]
    c1: torch.Tensor       # [L]
    d: dm.DictState
    ctx0: cm.CtxFamily
    ctx1: cm.CtxFamily
    pair_n: torch.Tensor   # [L]
    ev: torch.Tensor       # [L, 5]
    ms: torch.Tensor       # [L, 32]
    ch: torch.Tensor       # [L, 256]
    ix: torch.Tensor       # [L, D]
    dec: acm.AcDec
    src: bitio.BitSource
    counts: torch.Tensor   # [L, 5]
    sizes: torch.Tensor    # f32 [L, 5]
    pair_of: torch.Tensor  # bool [L]
    out_of: torch.Tensor   # bool [L]
    # the port's own: a symbol's value lay at or past its model's total
    # (x3host.cpp Model::find throws there); the lane has ended
    corrupt: torch.Tensor  # bool [L]


def _scatter_bytes(out: torch.Tensor, opos: torch.Tensor, data: torch.Tensor,
                   length: torch.Tensor, active: torch.Tensor) -> None:
    """out[l, opos[l]+j] = data[l, j] for j < length[l] on active lanes, in
    place.  The caller has checked that every write fits."""
    lanes, width = data.shape
    j = iota(width, data.device)[None, :]
    mask = active[:, None] & (j < length[:, None])
    flat = iota(lanes, data.device)[:, None] * out.shape[1] + opos[:, None] + j
    out.view(-1)[flat[mask]] = data[mask]


def _literal_decode_loop(carry: DecCarry, is_new: torch.Tensor,
                         length: torch.Tensor):
    """Decode fragment bytes through the 256-symbol char model (x3.c:300);
    returns (frag u8 [L, 32], ch, dec, src, nbits, bad): ``bad`` marks the
    lanes where a byte's value lay at or past the model's total."""
    lanes = is_new.shape[0]
    dev = is_new.device
    frag = torch.zeros((lanes, MAX_MATCH_LEN), dtype=torch.uint8, device=dev)
    nbits = torch.zeros((lanes,), dtype=F32, device=dev)
    bad = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    ch, dec, src = carry.ch, carry.dec, carry.src
    # byte k of a fragment follows k bytes of the same fragment, each of
    # which added one to the char model's total
    tot0 = ch.sum(1)
    syms = []
    for k in range(int(torch.where(is_new, length, 0).max())):
        act = is_new & (k < length)
        step, value = acm.ac_decode_value(dec, tot0 + k)
        bad |= act & (value >= tot0 + k)
        sym, low, span = am.model_decode_sym(ch, value)
        dec, src = acm.ac_decode_update(dec, src, step, low, low + span, act)
        ch = am.model_inc(ch, sym, act)
        nbits = nbits + torch.where(act, _bits(am.f32_prob(span, tot0 + k)),
                                    0.0)
        syms.append(sym)
    if syms:
        k = len(syms)
        mask = is_new[:, None] & (iota(k, dev)[None, :] < length[:, None])
        frag[:, :k] = torch.stack(syms, 1) * mask
    return frag, ch, dec, src, nbits, bad


def _dec_body(carry: DecCarry) -> DecCarry:
    """One event on every lane (x3tpu.codec._dec_body).  The E_NEW-only and
    hit-only parts are skipped when no lane takes them: their results are
    masked out on every lane then, so skipping changes nothing."""
    lanes = carry.opos.shape[0]
    dev = carry.opos.device
    lane = iota(lanes, dev)
    active = ~carry.done

    # (1) event symbol (x3.c:293); E_EOF is never counted (x3.c bumps
    # events[] only in the hit and E_NEW branches)
    etot = carry.ev.sum(1)
    step, value = acm.ac_decode_value(carry.dec, etot)
    # every search's value must lie below its model's total; past it the
    # stream is corrupt (x3host.cpp Model::find): the lane ends after this
    # event, which completes as x3tpu's clamped search has it (as in K2)
    bad = active & (value >= etot)
    esym, elow, espan = am.model_decode_sym(carry.ev, value)
    esym = torch.where(active, esym, E_EOF)
    dec, src = acm.ac_decode_update(carry.dec, carry.src, step, elow,
                                    elow + espan, active)
    ev = am.model_inc(carry.ev, esym, active)
    counts = am.model_inc(carry.counts, esym, active & (esym != E_EOF))
    eof = active & (esym == E_EOF)
    is_new = active & (esym == E_NEW)
    hit = active & ~eof & ~is_new
    any_new, any_hit = bool(is_new.any()), bool(hit.any())
    ev_bits = _bits(am.f32_prob(espan, etot))
    add = torch.where(eof, ev_bits, 0.0)

    # (2) E_NEW: length (x3.c:274) and fragment bytes
    ms, ch = carry.ms, carry.ch
    frag = torch.zeros((lanes, MAX_MATCH_LEN), dtype=torch.uint8, device=dev)
    length_new = torch.ones_like(carry.opos)
    if any_new:
        mstot = carry.ms.sum(1)
        step, value = acm.ac_decode_value(dec, mstot)
        bad |= is_new & (value >= mstot)
        lsym, lslow, lsspan = am.model_decode_sym(carry.ms, value)
        dec, src = acm.ac_decode_update(dec, src, step, lslow,
                                        lslow + lsspan, is_new)
        ms_bits = _bits(am.f32_prob(lsspan, mstot))
        ms = am.model_inc(carry.ms, lsym, is_new)
        length_new = lsym + 1
        frag, ch, dec, src, lit_bits, lit_bad = _literal_decode_loop(
            carry._replace(dec=dec, src=src), is_new, length_new)
        bad |= lit_bad
        add = torch.where(is_new, ev_bits + ms_bits + lit_bits, add)

    # (3) hit: resolve contexts, decode the payload by mode (x3.c:57-129)
    d, ix = carry.d, carry.ix
    ctx0, ctx1 = carry.ctx0, carry.ctx1
    pair_of, pair_n = carry.pair_of, carry.pair_n
    tag = torch.zeros_like(carry.opos)
    hlen = torch.zeros_like(carry.opos)
    hstr = frag
    if any_hit:
        v_pair = cm.ctx_view(ctx1, carry.prev_c1)
        pair_found, _, pair_id = cm.ctx_find(ctx1, v_pair, carry.c1)
        v0 = cm.ctx_view(ctx0, torch.where(pair_found, pair_id, 0))
        v1 = cm.ctx_view(ctx1, carry.c1)
        is0 = hit & (esym == E_CTX0)
        is1 = hit & (esym == E_CTX1)
        isx = hit & (esym == E_IDX1)
        # totals differ per mode; one shared AC step.  Index-model entries
        # past every lane's dictionary count are zero.
        kx = max(1, int(d.n.max()))
        modes = ((is0, ctx0, v0), (is1, ctx1, v1))
        zero = torch.zeros_like(tag)
        ptot = ix[:, :kx].sum(1)
        for sel, fam, v in modes:
            if bool(sel.any()):
                ptot = torch.where(sel, cm.ctx_encode_stats(fam, v, zero)[2],
                                   ptot)
        step, value = acm.ac_decode_value(dec, ptot)
        bad |= hit & (value >= ptot)
        ptot = ptot.clamp(min=1)
        rank, plow, pspan = am.model_decode_sym(ix[:, :kx], value)
        tag = d.tag_of[lane, rank]
        for sel, fam, v in modes:
            if bool(sel.any()):
                _, ctag, clow, cspan = cm.ctx_decode_pos(fam, v, value)
                tag = torch.where(sel, ctag, tag)
                plow = torch.where(sel, clow, plow)
                pspan = torch.where(sel, cspan, pspan)
        dec, src = acm.ac_decode_update(dec, src, step, plow, plow + pspan,
                                        hit)
        ix = am.model_inc(ix, rank, isx)
        add = torch.where(hit, ev_bits + _bits(am.f32_prob(pspan, ptot)), add)

        # context updates (decode mirror, x3.c:99-127)
        f0, pos0, _ = cm.ctx_find(ctx0, v0, tag)
        f1, pos1, _ = cm.ctx_find(ctx1, v1, tag)
        ctx0 = cm.ctx_update(ctx0, v0, tag, f0, pos0, hit)
        ctx1 = cm.ctx_update(ctx1, v1, tag, f1, pos1, hit, new_pair_id=pair_n)
        new_pair = hit & ~f1
        # the same one-early boundary as the encoder (_enc_body step 8)
        pair_of = pair_of | (new_pair & (pair_n >= ctx0.tags.shape[1]))
        pair_n = pair_n + new_pair

        # the entry's bytes, read before this event's dictionary update
        at = tag.clamp(max=d.lens.shape[1] - 1)
        hlen, hstr = d.lens[lane, at], d.strs[lane, at]
        d = dm.dict_mtf(d, tag, hit)
    sizes = carry.sizes.index_put_((lane, esym), add, accumulate=True)

    # (4) E_NEW: insert unless an exact duplicate (x3.c:309-317)
    if any_new:
        ins = is_new & ~dm.dict_has_exact_ok(d, dm.dict_probe_ok(d, frag)[3],
                                             length_new)
        if bool(ins.any()):
            nidx = d.n.clamp(max=ix.shape[1] - 1)
            ix[lane, nidx] = torch.where(ins & (d.n < ix.shape[1]), 1,
                                         ix[lane, nidx])
            d, _ = dm.dict_insert(d, frag, length_new, ins)

    # (5) output bytes; an event that does not fit ends the lane with the
    # out flag and writes nothing
    length = torch.where(is_new, length_new, hlen)
    data = torch.where(is_new[:, None], frag, hstr)
    emit = is_new | hit
    out_of = carry.out_of | (emit & (carry.opos + length > carry.out.shape[1]))
    ok_emit = emit & ~out_of
    _scatter_bytes(carry.out, carry.opos, data, length, ok_emit)
    opos = carry.opos + length * ok_emit

    prev_c1 = torch.where(hit, carry.c1, carry.prev_c1 * ~is_new)
    c1 = torch.where(hit, tag, carry.c1 * ~is_new)
    return DecCarry(
        carry.out, opos, carry.done | eof | out_of | bad, prev_c1, c1, d,
        ctx0, ctx1, pair_n, ev, ms, ch, ix, dec, src, counts, sizes, pair_of,
        out_of, carry.corrupt | bad,
    )


def dec_init_carry(words: torch.Tensor, byte_lens: torch.Tensor,
                   caps: CodecCaps, seeds=None, warm=None) -> DecCarry:
    """Initial decoder carry for L streams: ``words`` [L, IW] (u32 values)
    and ``byte_lens`` [L]; ``seeds`` and ``warm`` as :func:`_init_shared`
    takes them.  A lane whose ``byte_lens`` is <= 0 starts done
    (x3tpu/vm/driver.py _init_state_dec)."""
    lanes = words.shape[0]
    dev = words.device
    d, ctx0, ctx1, ev, ms, ch, ix = _init_shared(lanes, caps, dev, seeds,
                                                 warm)
    byte_lens = byte_lens.to(I64)
    dec, src = acm.dec_init(bitio.source_init(words.to(I64), byte_lens))
    z = lambda: torch.zeros((lanes,), dtype=I64, device=dev)
    f = lambda: torch.zeros((lanes,), dtype=torch.bool, device=dev)
    return DecCarry(
        out=torch.zeros((lanes, caps.block_bytes), dtype=torch.uint8,
                        device=dev),
        opos=z(), done=byte_lens <= 0, prev_c1=z(), c1=z(),
        d=d, ctx0=ctx0, ctx1=ctx1, pair_n=_pair_n0(lanes, dev, warm),
        ev=ev, ms=ms, ch=ch, ix=ix, dec=dec, src=src,
        counts=torch.zeros((lanes, E_LAST), dtype=I64, device=dev),
        sizes=torch.zeros((lanes, E_LAST), dtype=F32, device=dev),
        pair_of=f(), out_of=f(), corrupt=f(),
    )


def dec_active(carry: DecCarry) -> bool:
    """Any lane still decoding."""
    return bool((~carry.done).any())


def dec_chunk(carry: DecCarry, nsteps: int) -> DecCarry:
    """Run up to ``nsteps`` events."""
    for _ in range(nsteps):
        if not dec_active(carry):
            break
        carry = _dec_body(carry)
    return carry


def dec_finalize(carry: DecCarry):
    """(out u8 [L, block_bytes], out_lens, counts, sizes, Overflow)."""
    overflow = Overflow(
        dict=carry.d.overflow, ctx0=carry.ctx0.overflow,
        ctx1=carry.ctx1.overflow, pairs=carry.pair_of, out=carry.out_of,
    )
    return carry.out, carry.opos, carry.counts, carry.sizes, overflow


def malformed(events: int) -> ValueError:
    """The error of a lane still decoding after ``events`` events: every
    event of a valid stream but the final EOF emits at least one byte, so
    a valid stream ends within block_bytes + 1 events."""
    return ValueError(f"malformed stream: a lane did not end within "
                      f"{events} events")


def corrupt() -> ValueError:
    """The error of a lane whose symbol search ran past its model's total
    while none of its capacities had overflowed: a valid stream's values
    always lie below it (x3host.cpp Model::find throws there)."""
    return ValueError("malformed stream: a symbol's value lies past its "
                      "model's total")


@torch.inference_mode()
def decode_blocks_chunked(words, byte_lens, caps: CodecCaps, seeds=None,
                          warm=None):
    """Decode L streams: ``words`` [L, IW] (u32 values; tensors or arrays,
    the work runs on ``words``' device) and ``byte_lens`` [L], every lane
    from the encoder's dictionary ``seeds`` (strs u8 [K, 32], lens i32
    [K]) and warm state ``warm`` where given.  The stream is
    self-describing: no parameter shapes decoding.  Returns (out u8 [L,
    block_bytes], out_lens, counts, sizes, Overflow); raises ValueError
    for a corrupt stream (a symbol past its model's total) and when a lane
    runs past the event bound."""
    words = torch.as_tensor(words)
    byte_lens = torch.as_tensor(byte_lens, device=words.device)
    carry = dec_init_carry(words, byte_lens, caps, seeds, warm)
    carry = dec_chunk(carry, caps.block_bytes + 1)
    result = dec_finalize(carry)
    # a lane whose state overflowed decodes past its capacities, where its
    # values may run past a total: that is the overflow's to report (a
    # retry at larger capacities), not the stream's
    if bool((carry.corrupt & ~result[4].any_flag()).any()):
        raise corrupt()
    if dec_active(carry):
        raise malformed(caps.block_bytes + 1)
    return result


# ---------------------------------------------------------------------------
# Carry <-> NumPy (field for field with x3tpu.codec.EncCarry / DecCarry)
# ---------------------------------------------------------------------------

# fields holding u32 values; every other integer field is i32 in x3tpu
_U32_FIELDS = {"enc.low", "enc.high", "sink.words", "dec.low", "dec.high",
               "dec.buf", "src.words", "src.acc"}


def _flatten(tree, prefix="") -> Dict[str, object]:
    out = {}
    for name, val in zip(tree._fields, tree):
        key = prefix + name
        if val is None:
            continue
        if hasattr(val, "_fields"):
            out.update(_flatten(val, key + "."))
        else:
            out[key] = val
    return out


# fields of the port's carries that x3tpu's have not: left out of the
# NumPy form, and started afresh by carry_from_numpy
_PORT_ONLY = {"corrupt"}


def carry_to_numpy(carry) -> Dict[str, np.ndarray]:
    """``{"field.sub": array}`` with x3tpu's names, layouts and dtypes.
    Also accepts an x3tpu ``EncCarry`` or ``DecCarry``, so the carries of
    both packages flatten alike."""
    out = {}
    for key, val in _flatten(carry).items():
        if key in _PORT_ONLY:
            continue
        arr = val
        if isinstance(val, torch.Tensor):
            arr = val.detach().cpu().numpy()
            if arr.dtype == np.int64:
                arr = arr.astype(np.uint32 if key in _U32_FIELDS else np.int32)
        out[key] = np.array(arr)  # a copy: the port updates tables in place
    return out


def carry_from_numpy(fields: Dict[str, np.ndarray], device="cpu"):
    """Build an :class:`EncCarry` or, from a decoder's fields, a
    :class:`DecCarry` out of :func:`carry_to_numpy`'s dict (e.g. one taken
    from a running x3tpu encoder or decoder)."""

    def leaf(key):
        if key not in fields:
            return None   # a family without pair payloads
        arr = np.asarray(fields[key])
        if arr.dtype in (np.int32, np.uint32):
            arr = arr.astype(np.int64)
        return torch.tensor(arr, device=device)

    def build(cls, prefix):
        return cls(*(
            build(_SUBTREES[name], name + ".") if not prefix and name in _SUBTREES
            else leaf(prefix + name)
            for name in cls._fields
        ))

    if "opos" not in fields:
        return build(EncCarry, "")
    carry = build(DecCarry, "")
    return carry._replace(corrupt=torch.zeros_like(carry.done))


_SUBTREES = {
    "d": dm.DictState, "ctx0": cm.CtxFamily, "ctx1": cm.CtxFamily,
    "enc": acm.AcEnc, "sink": bitio.BitSink,
    "dec": acm.AcDec, "src": bitio.BitSource,
}


# ---------------------------------------------------------------------------
# Host wrappers
# ---------------------------------------------------------------------------


class X3CapacityError(RuntimeError):
    """A static capacity was exceeded; re-run with larger CodecCaps."""

    def __init__(self, flags: dict):
        self.flags = flags
        super().__init__(f"codec capacity overflow: {flags}")


def _check_overflow(overflow: Overflow) -> None:
    flags = {
        name: np.asarray(getattr(overflow, name).cpu())
        for name in ("dict", "ctx0", "ctx1", "pairs", "out")
    }
    bad = {k: v.nonzero()[0].tolist() for k, v in flags.items() if v.any()}
    if bad:
        raise X3CapacityError(bad)


def text_bytes(params: X3Params, caps: CodecCaps) -> int:
    """TB, the padded width of a lane's text row (x3tpu's): the zero
    padding past each block covers the window reads (x3.c:579/590)."""
    wbuf = ((max(params.window, 2 * MAX_MATCH_LEN) + MAX_MATCH_LEN + 127)
            // 128) * 128
    return caps.block_bytes + ((wbuf + 1023) // 1024) * 1024 + 64


def pack_blocks(blocks: Sequence[bytes], params: X3Params,
                caps: CodecCaps) -> Tuple[np.ndarray, np.ndarray]:
    """Pad blocks into the [L, TB] text buffer (TB = :func:`text_bytes`)."""
    text = np.zeros((len(blocks), text_bytes(params, caps)), np.uint8)
    tlen = np.zeros((len(blocks),), np.int32)
    for i, b in enumerate(blocks):
        if len(b) > caps.block_bytes:
            raise ValueError(f"block {i} larger than caps.block_bytes")
        text[i, : len(b)] = np.frombuffer(b, np.uint8)
        tlen[i] = len(b)
    return text, tlen


def streams_from_words(words, byte_lens, count: int) -> List[bytes]:
    """Per-lane streams: the first ``byte_lens[i]`` bytes of LE u32 words."""
    words_np = np.asarray(torch.as_tensor(words).cpu()).astype("<u4")
    lens_np = np.asarray(torch.as_tensor(byte_lens).cpu())
    return [words_np[i].tobytes()[: lens_np[i]] for i in range(count)]
