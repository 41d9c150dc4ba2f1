"""The port's lane-parallel ops and models against x3tpu's, function by
function: the same seeded inputs go through both, and every output and
every state field must agree exactly (all of it is integer state)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x3tpu.config import X3Params as JX3Params
from x3tpu.models import adaptive as jam
from x3tpu.models import context as jcm
from x3tpu.models import dictionary as jdm
from x3tpu.ops import ac as jac
from x3tpu.ops import bitio as jbitio
from x3tpu.ops import match as jmatch
from x3tpu_torch.config import MAX_MATCH_LEN, X3Params
from x3tpu_torch.models import adaptive as tam
from x3tpu_torch.models import context as tcm
from x3tpu_torch.models import dictionary as tdm
from x3tpu_torch.ops import ac as tac
from x3tpu_torch.ops import bitio as tbitio
from x3tpu_torch.ops import match as tmatch

from test_torch_codec import one_thread  # noqa: F401  (autouse)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    return x.astype(np.int64) if x.dtype != np.bool_ else x


def _same(a, b, what):
    """Equal NamedTuples (field by field) or arrays; None fields match."""
    if hasattr(a, "_fields"):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if x is None or y is None:
                assert x is None and y is None, f"{what}.{name}"
            else:
                _same(x, y, f"{what}.{name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=what)


def _both(arr, jdtype):
    arr = np.asarray(arr)
    t = torch.from_numpy(arr.astype(np.bool_ if arr.dtype == np.bool_
                                    else np.int64))
    return jnp.asarray(arr, jdtype), t


def _valid_intervals(rng, lanes):
    total = rng.integers(1, 1 << 16, lanes)
    a = rng.integers(0, total)
    b = rng.integers(0, total)
    low_f = np.minimum(a, b)
    high_f = np.maximum(a, b) + 1
    return low_f, high_f, total


def test_ac_encode_and_flush():
    """Seeded interval sequences, random activity, lanes that start with
    long underflow runs, and a sink that overflows part way."""
    rng = np.random.default_rng(1)
    lanes, out_words = 8, 10
    j_enc, t_enc = jac.enc_init(lanes), tac.enc_init(lanes)
    # pending underflow runs past one 31-bit chunk and past 62 bits
    scale = np.array([0, 3, 31, 33, 61, 62, 90, 0])
    j_enc = j_enc._replace(scale=jnp.asarray(scale, jnp.int32))
    t_enc = t_enc._replace(scale=torch.from_numpy(scale))
    j_sink, t_sink = jbitio.sink_init(lanes, out_words), tbitio.sink_init(
        lanes, out_words)
    j_step = jax.jit(jac.ac_encode)
    for step in range(160):
        low_f, high_f, total = _valid_intervals(rng, lanes)
        jl, tl = _both(low_f, jnp.uint32)
        jh, th = _both(high_f, jnp.uint32)
        jt, tt = _both(total, jnp.uint32)
        ja, ta = _both(rng.random(lanes) < 0.8, jnp.bool_)
        j_enc, j_sink = j_step(j_enc, j_sink, jl, jh, jt, ja)
        t_enc, t_sink = tac.ac_encode(t_enc, t_sink, tl, th, tt, ta)
        _same(j_enc, t_enc, f"enc@{step}")
        _same(j_sink, t_sink, f"sink@{step}")
    assert np.asarray(j_sink.overflow).any() and not np.asarray(
        j_sink.overflow).all()
    ja, ta = _both(np.array([True] * 7 + [False]), jnp.bool_)
    _same(jax.jit(jac.ac_flush)(j_enc, j_sink, ja),
          tac.ac_flush(t_enc, t_sink, ta), "flush")


def test_ac_decode_and_source():
    """The decoder's priming, (step, value) and interval update with its
    multi-bit source reads, on seeded words: streams shorter than their
    buffer (the sentinel past the end), byte counts that are not a
    multiple of 4 or exceed the buffer (x3tpu's clamped read), random
    activity and symbol intervals."""
    rng = np.random.default_rng(12)
    lanes, iw = 8, 6
    words = rng.integers(0, 1 << 32, (lanes, iw), dtype=np.uint64)
    byte_lens = np.array([0, 3, 4, 9, 17, 24, 30, 40])
    jw, tw = _both(words.astype(np.int64), jnp.uint32)
    jl, tl = _both(byte_lens, jnp.int32)
    j_src, t_src = jbitio.source_init(jw, jl), tbitio.source_init(tw, tl)
    _same(j_src, t_src, "source_init")
    (j_dec, j_src), (t_dec, t_src) = (jac.dec_init(j_src, lanes),
                                      tac.dec_init(t_src))
    _same((j_dec, j_src), (t_dec, t_src), "dec_init")
    j_value, j_update = jax.jit(jac.ac_decode_value), jax.jit(
        jac.ac_decode_update)
    for step in range(120):
        low_f, high_f, total = _valid_intervals(rng, lanes)
        jt, tt = _both(total, jnp.uint32)
        jv, tv = j_value(j_dec, jt), tac.ac_decode_value(t_dec, tt)
        _same(tuple(jv), tuple(tv), f"value@{step}")
        jlo, tlo = _both(low_f, jnp.uint32)
        jhi, thi = _both(high_f, jnp.uint32)
        ja, ta = _both(rng.random(lanes) < 0.8, jnp.bool_)
        j_dec, j_src = j_update(j_dec, j_src, jv[0], jlo, jhi, ja)
        t_dec, t_src = tac.ac_decode_update(t_dec, t_src, tv[0], tlo, thi, ta)
        _same((j_dec, j_src), (t_dec, t_src), f"update@{step}")
    # lanes read the sentinel past their readable words, and the lane whose
    # byte count exceeds the buffer read its clamped last word
    widx, nwords = np.asarray(j_src.widx), np.asarray(j_src.nwords)
    assert (widx > nwords)[:7].all() and nwords[7] > iw and widx[7] > iw


def test_model_and_context_decode_search():
    """model_decode_sym (a zero freq does not count) and ctx_decode_pos
    over hub, small and promoted rows, at values inside and past the
    totals."""
    rng = np.random.default_rng(13)
    lanes = 6
    freqs = rng.integers(0, 4, (lanes, 40))
    freqs[:, 30:] = 0
    jf, tf = _both(freqs, jnp.int32)
    for step in range(20):
        value = rng.integers(0, 120, lanes)
        jv, tv = _both(value, jnp.uint32)
        _same(tuple(jax.jit(jam.model_decode_sym)(jf, jv)),
              tuple(tam.model_decode_sym(tf, tv)), f"model@{step}")
    jfam = jcm.ctx_init(lanes, 10, 8, 7, with_pair=True, small_cap=3,
                        promo_rows=3)
    tfam = tcm.ctx_init(lanes, 10, 8, 7, with_pair=True, small_cap=3,
                        promo_rows=3)
    j_upd, j_find = jax.jit(jcm.ctx_update), jax.jit(jcm.ctx_find)
    j_dec = jax.jit(jcm.ctx_decode_pos)
    pair_id = np.zeros(lanes, np.int64)
    for step in range(60):
        cid = rng.integers(0, 6, lanes)
        cid[rng.random(lanes) < 0.3] = 0
        jcid, tcid = _both(cid, jnp.int32)
        jv, tv = jax.jit(jcm.ctx_view)(jfam, jcid), tcm.ctx_view(tfam, tcid)
        value = rng.integers(0, 12, lanes)
        jval, tval = _both(value, jnp.uint32)
        _same(tuple(j_dec(jfam, jv, jval)),
              tuple(tcm.ctx_decode_pos(tfam, tv, tval)), f"decode@{step}")
        jtag, ttag = _both(rng.integers(0, 9, lanes), jnp.int32)
        jr, tr = j_find(jfam, jv, jtag), tcm.ctx_find(tfam, tv, ttag)
        jp, tp = _both(pair_id, jnp.int32)
        ja, ta = _both(np.ones(lanes, bool), jnp.bool_)
        jfam = j_upd(jfam, jv, jtag, jr[0], jr[1], ja, jp)
        tfam = tcm.ctx_update(tfam, tv, ttag, tr[0], tr[1], ta, tp)
        pair_id += ~np.asarray(jr[0])
    assert np.asarray(jfam.promo_n).any()


def test_sink_put_bits():
    """Up to 32 bits a call into a buffer that fills up: dropped words and
    the sticky overflow flag as in x3tpu."""
    rng = np.random.default_rng(2)
    lanes, out_words = 6, 20
    j_sink, t_sink = jbitio.sink_init(lanes, out_words), tbitio.sink_init(
        lanes, out_words)
    j_put = jax.jit(jbitio.sink_put_bits)
    for step in range(60):
        value = rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
        count = rng.integers(0, 33, lanes)
        jv, tv = _both(value.astype(np.int64), jnp.uint32)
        jc, tc = _both(count, jnp.int32)
        ja, ta = _both(rng.random(lanes) < 0.9, jnp.bool_)
        j_sink = j_put(j_sink, jv, jc, ja)
        t_sink = tbitio.sink_put_bits(t_sink, tv, tc, ta)
        _same(j_sink, t_sink, f"sink@{step}")
    assert np.asarray(j_sink.overflow).any()
    np.testing.assert_array_equal(
        _np(tbitio.sink_byte_len(t_sink)),
        _np(jbitio.sink_byte_len(j_sink)))


def _text(rng, n):
    """Text from a small vocabulary, so fragments repeat."""
    words = [b"the ", b"cat ", b"sat ", b"on ", b"a ", b"mat. ", b"x", b"\n"]
    out = b"".join(words[i] for i in rng.integers(0, len(words), n))
    return np.frombuffer(out, np.uint8)


def _dicts(rng, text, lanes, cap, nins):
    """The same dictionaries built through both packages' dict_insert."""
    jd, td = jdm.dict_init(lanes, cap), tdm.dict_init(lanes, cap)
    j_ins = jax.jit(jdm.dict_insert)
    for _ in range(nins):
        p = rng.integers(0, len(text) - MAX_MATCH_LEN, lanes)
        frag = np.stack([text[q:q + MAX_MATCH_LEN] for q in p])
        flen = rng.integers(1, 9, lanes)
        jf, tf = jnp.asarray(frag), torch.from_numpy(frag)
        jl, tl = _both(flen, jnp.int32)
        jd, _ = j_ins(jd, jf, jl, jnp.ones((lanes,), jnp.bool_))
        td, _ = tdm.dict_insert(td, tf, tl, torch.ones(lanes, dtype=torch.bool))
    return jd, td


def test_dictionary_probe_mtf_insert():
    """Probe, exact-duplicate query, move-to-front and insert, through a
    dictionary that fills up (the overflow flag and dropped inserts)."""
    rng = np.random.default_rng(3)
    lanes, cap = 4, 24
    text = _text(rng, 400)
    jd, td = jdm.dict_init(lanes, cap), tdm.dict_init(lanes, cap)
    j_probe, j_exact = jax.jit(jdm.dict_probe), jax.jit(jdm.dict_has_exact)
    j_mtf, j_ins = jax.jit(jdm.dict_mtf), jax.jit(jdm.dict_insert)
    for step in range(50):
        p = rng.integers(0, len(text) - MAX_MATCH_LEN, lanes)
        target = np.stack([text[q:q + MAX_MATCH_LEN] for q in p])
        jt, tt = jnp.asarray(target), torch.from_numpy(target)
        jr, tr = j_probe(jd, jt), tdm.dict_probe(td, tt)
        _same(tuple(jr), tuple(tr), f"probe@{step}")
        flen = rng.integers(1, 9, lanes)
        jl, tl = _both(flen, jnp.int32)
        jdup = j_exact(jd, jr[3], jl)
        _same(jdup, tdm.dict_has_exact(td, tr[3], tl), f"exact@{step}")
        hit = np.asarray(jr[0]) & (rng.random(lanes) < 0.5)
        ins = ~hit & ~np.asarray(jdup) & (rng.random(lanes) < 0.8)
        jh, th = _both(hit, jnp.bool_)
        jd = j_mtf(jd, jr[1], jh)
        td = tdm.dict_mtf(td, tr[1], th)
        ji, ti = _both(ins, jnp.bool_)
        jd, jslot = j_ins(jd, jt, jl, ji)
        td, tslot = tdm.dict_insert(td, tt, tl, ti)
        _same(jslot, tslot, f"slot@{step}")
        _same(jd, td, f"dict@{step}")
    assert np.asarray(jd.overflow).any()


def test_window_counts():
    rng = np.random.default_rng(4)
    lanes, window = 5, 256
    text = _text(rng, 300)
    width = 384
    p = rng.integers(0, len(text) - width, lanes)
    win = np.stack([text[q:q + width] for q in p])
    jc = jax.jit(jmatch.window_counts, static_argnums=1)(jnp.asarray(win),
                                                         window)
    _same(jc, tmatch.window_counts(torch.from_numpy(win), window), "counts")
    assert np.asarray(jc)[:, 3].any()


@pytest.mark.parametrize("f1,f2", [(4, 0), (0, 0), (4, 2), (0, 3)])
def test_best_match_sweep(f1, f2):
    """All three branches of the threshold sweep (f1 only, no vetoes, f2
    with or without f1) on windows whose fragments the dictionary holds,
    so the vetoes fire."""
    rng = np.random.default_rng(5 + f1 + 7 * f2)
    lanes, window, width = 8, 256, 384
    fields = dict(max_match_count=6, window=window, magic_factor1=f1,
                  magic_factor2=f2)
    text = _text(rng, 300)
    jd, td = _dicts(rng, text, lanes, 64, 40)
    p = rng.integers(0, len(text) - width, lanes)
    win = np.stack([text[q:q + width] for q in p])
    jw, tw = jnp.asarray(win), torch.from_numpy(win)
    jcounts = jmatch.window_counts(jw, window)
    ja, ta = _both(np.arange(lanes) != 2, jnp.bool_)
    jbest = jax.jit(jmatch.best_match_sweep, static_argnames="params")(
        jcounts, jw, jd, ja, params=JX3Params(**fields))
    tbest = tmatch.best_match_sweep(
        tmatch.window_counts(tw, window), tw, td, ta, X3Params(**fields))
    _same(jbest, tbest, "best")
    assert (np.asarray(jbest) > 1).any()


@pytest.mark.parametrize("with_pair", [False, True])
def test_context_find_stats_update(with_pair):
    """View, find, stats and update of one context family at capacities
    small enough that rows get promoted and every overflow case fires."""
    rng = np.random.default_rng(6 + with_pair)
    lanes, hub_cap, pool_rows, items, small, promo = 6, 10, 8, 7, 3, 3
    jf = jcm.ctx_init(lanes, hub_cap, pool_rows, items, with_pair=with_pair,
                      small_cap=small, promo_rows=promo)
    tf = tcm.ctx_init(lanes, hub_cap, pool_rows, items, with_pair=with_pair,
                      small_cap=small, promo_rows=promo)
    j_view, j_find = jax.jit(jcm.ctx_view), jax.jit(jcm.ctx_find)
    j_stats, j_upd = jax.jit(jcm.ctx_encode_stats), jax.jit(jcm.ctx_update)
    pair_id = np.zeros(lanes, np.int64)
    for step in range(60):
        cid = rng.integers(0, pool_rows + 3, lanes)
        cid[rng.random(lanes) < 0.3] = 0
        tag = rng.integers(0, 14, lanes)
        jcid, tcid = _both(cid, jnp.int32)
        jtag, ttag = _both(tag, jnp.int32)
        jv, tv = j_view(jf, jcid), tcm.ctx_view(tf, tcid)
        _same(jv, tv, f"view@{step}")
        jr, tr = j_find(jf, jv, jtag), tcm.ctx_find(tf, tv, ttag)
        _same(tuple(jr), tuple(tr), f"find@{step}")
        _same(tuple(j_stats(jf, jv, jr[1])),
              tuple(tcm.ctx_encode_stats(tf, tv, tr[1])), f"stats@{step}")
        ja, ta = _both(rng.random(lanes) < 0.85, jnp.bool_)
        if with_pair:
            jp, tp = _both(pair_id, jnp.int32)
            jf = j_upd(jf, jv, jtag, jr[0], jr[1], ja, jp)
            tf = tcm.ctx_update(tf, tv, ttag, tr[0], tr[1], ta, tp)
            pair_id += ~np.asarray(jr[0]) & np.asarray(ja)
        else:
            jf = j_upd(jf, jv, jtag, jr[0], jr[1], ja)
            tf = tcm.ctx_update(tf, tv, ttag, tr[0], tr[1], ta)
        _same(jf, tf, f"family@{step}")
    assert np.asarray(jf.overflow).any() and np.asarray(jf.promo_n).any()
