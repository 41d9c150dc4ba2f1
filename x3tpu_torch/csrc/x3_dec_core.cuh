// The x3 decoder event loop for one lane (one stream), written once for
// the CUDA kernel K2 (x3_decoder.cu, one CTA per lane) and for a host build
// of the same source (x3_core_host.cpp, tests only).  The dictionary,
// context-row, reduction and rank-update code is the encoder's
// (x3_core.cuh).
//
// Semantics are those of x3tpu's XLA engine (x3tpu/codec.py _dec_body and
// the ops/ and models/ modules it calls), with its capacity model; the
// plain PyTorch twin is x3tpu_torch/codec.py (decode_blocks_chunked).
//
// Work split.  The leader thread runs the serial chain: the bit source,
// the AC decoder, the small models (event, length, char), the literal
// bytes, the model and context updates, pair registration and the output
// writes.  The CTA shares the O(D) and O(items) parts: the duplicate probe
// of a decoded fragment, the context-row finds and totals, the symbol
// search over a context row or the index model, and the rank updates.
//
// Every index taken from the stream is clamped or bounded before it
// addresses memory, and a lane stops after block_bytes + 1 events with
// OF_STEPS: a corrupt stream ends in a flag, never in a fault or a hang.
#pragma once

#include "x3_core.cuh"

namespace x3 {

constexpr uint32_t SENTINEL = 0x80000000u;  // read-past-end word (bio.c:38)

struct DecIO {
  const uint32_t* words;  // the lane's stream words [iw]
  int nbytes, iw;
  int32_t* scr;           // the lane's zeroed scratch (Layout::words)
  uint8_t* out;           // the lane's zeroed output row [block_bytes]
  int block_bytes;
  int32_t* out_len;
  int32_t* counts;        // [5]
  float* sizes;           // [5]
  int32_t* flags;
};

// ---------------------------------------------------------------------------
// Bit source and arithmetic decoder (leader only; x3tpu/ops/bitio.py,
// x3tpu/ops/ac.py).
// ---------------------------------------------------------------------------

// Up to 31 bits, first stream bit in the LSB; at most one word reload.
// A readable word past the buffer (byte count over 4 * iw) reads the last
// one, as x3tpu's clamped gather does.
X3_HD uint32_t get_bits(Lane& R, const uint32_t* words, int iw, int count) {
  if (count <= 0) return 0u;
  const int take1 = imin(count, 32 - R.used);
  uint32_t r = R.acc & ((1u << take1) - 1u);
  const int rem = count - take1;
  if (rem > 0) {
    const uint32_t w =
        R.widx < R.nwords ? words[imin(R.widx, iw - 1)] : SENTINEL;
    r |= (w & ((1u << rem) - 1u)) << take1;
    R.acc = w >> rem;
    R.used = rem;
    R.widx += 1;
  } else {
    R.acc >>= take1;
    R.used += take1;
  }
  return r;
}

// (step, value) of the pending symbol (ac.c:128-131, 183-185): exact u32
// divisions, each divisor at least 1 (a corrupt stream can reach step 0).
X3_HD void dec_value(const Lane& R, uint32_t total, uint32_t& step,
                     uint32_t& value) {
  step = (R.high - R.low + 1u) / (total < 1u ? 1u : total);
  value = (R.buf - R.low) / (step < 1u ? 1u : step);
}

// Narrow to [low_f, high_f) and renormalize in closed form, consuming n+m
// stream bits in one read (ac.c:142-165, 192-195).  A corrupt stream can
// leave a wrapped interval whose bounds differ in bit 31: there n is 0.
X3_HD void dec_update(Lane& R, const DecIO& io, uint32_t step,
                      uint32_t low_f, uint32_t high_f) {
  const uint32_t high = R.low + step * high_f - 1u;
  const uint32_t low = R.low + step * low_f;
  const int n = imax(clz32(low ^ high) - 1, 0);
  const uint32_t v = n > 0 ? low >> (31 - n) : 0u;
  const uint32_t low1 = (low << n) & M31;
  const uint32_t high1 = ((high << n) | ((1u << n) - 1u)) & M31;
  const int m = imin(imin(clz32(~(low1 << 2)), clz32(high1 << 2)), 30);
  const uint32_t sub = (HALF << m) - HALF;  // H * (2^m - 1) mod 2^32
  const int k = n + m;                      // <= 31
  const uint32_t raw = get_bits(R, io.words, io.iw, k);
  // stream bits arrive LSB-first; the decoder shifts them in MSB-first
  const uint32_t grp = k > 0 ? bitrev32(raw) >> (32 - k) : 0u;
  const uint32_t buf1 = (R.buf << n) - (v << 31) + (grp >> m);
  R.buf = (buf1 << m) - sub + (grp & ((1u << m) - 1u));
  R.low = (low1 << m) - sub;
  R.high = (high1 << m) - sub + (1u << m) - 1u;
}

struct Sym { int sym, low, span; };

// The symbol whose interval holds value (model_decode_sym): with the
// exclusive prefix cum, sym = (symbols with a nonzero freq and
// cum <= value) - 1, at least 0.  Leader-only, for the small models.
X3_HD Sym small_decode(const int* f, int m, uint32_t value) {
  int cnt = 0;
  uint32_t c = 0;
  for (int i = 0; i < m; ++i) {
    if (f[i] > 0 && c <= value) ++cnt;
    c += (uint32_t)f[i];
  }
  Sym s = {imax(cnt - 1, 0), 0, 0};
  for (int i = 0; i < s.sym; ++i) s.low += f[i];
  s.span = f[s.sym];
  return s;
}

// The same search over w freqs, shared by the CTA (each thread takes a
// contiguous chunk; a block scan gives each chunk its base).  by_freq: a
// model, whose symbols count when their freq is nonzero (the index
// model); else a context row's w live items, which all count
// (ctx_decode_pos).  Past the live items the span is 0.
template <class P>
X3_HD Sym decode_search(const P& par, const int32_t* f, int w, bool by_freq,
                        uint32_t value) {
  const int chunk = (w + par.nthr() - 1) / par.nthr();
  const int a = imin(par.tid() * chunk, w), b = imin(a + chunk, w);
  uint64_t s = 0;
  for (int i = a; i < b; ++i) s += (uint32_t)f[i];
  uint64_t c = par.scan_excl(s), cnt = 0;
  for (int i = a; i < b; ++i) {
    const uint32_t fi = (uint32_t)f[i];
    if ((!by_freq || fi > 0) && c <= value) ++cnt;
    c += fi;
  }
  Sym r;
  r.sym = imax((int)par.reduce(cnt, OpSum()) - 1, 0);
  uint64_t low = 0;
  for (int i = a; i < imin(b, r.sym); ++i) low += (uint32_t)f[i];
  r.low = (int)par.reduce(low, OpSum());
  r.span = r.sym < w ? f[r.sym] : 0;
  return r;
}

// Write an event's bytes; one that does not fit ends the lane with OF_OUT
// and writes nothing (x3tpu codec.py _dec_body step 6).
X3_HD void emit(Lane& R, const DecIO& io, const uint8_t* data, int len) {
  if (R.opos + len > io.block_bytes) {
    R.flags |= OF_OUT;
    R.done = 1;
    return;
  }
  for (int k = 0; k < len; ++k) io.out[R.opos + k] = data[k];
  R.opos += len;
}

// ---------------------------------------------------------------------------
// One lane, start to finish (decompress loop, x3.c:285-353).
// ---------------------------------------------------------------------------

template <class P>
X3_HD void decode_lane(const P& par, const Layout& L, const DecIO& io,
                       Lane& R, Shared& sh) {
  const Planes pl = resolve(L, io.scr, nullptr, nullptr);
  uint8_t* strs = pl.strs;
  int32_t* lens = pl.lens;
  int32_t* rank_of = pl.rank_of;
  int32_t* tag_of = pl.tag_of;
  int32_t* ix = pl.ix;
  const int D = L.D;

  if (par.leader()) {
    R.low = 0;
    R.high = TOP;
    R.flags = R.opos = 0;
    R.done = io.nbytes <= 0;  // x3tpu/vm/driver.py _init_state_dec
    R.prev_c1 = R.c1 = R.pair_n = R.dn = 0;
    R.hub_n[0] = R.hub_n[1] = R.promo_n[0] = R.promo_n[1] = 0;
    for (int e = 0; e < E_LAST; ++e) {
      R.ev[e] = event_init_freq(e);
      R.counts[e] = 0;
      R.sizes[e] = 0.0f;
    }
    for (int i = 0; i < MML; ++i) R.ms[i] = 1;
    // a word at byte offset o is readable iff o < nbytes - 3 (bio.c:11)
    R.nwords = io.nbytes >= 4 ? (io.nbytes - 4) / 4 + 1 : 0;
    R.widx = 0;
    R.acc = 0;
    R.used = 32;
    // prime with exactly 31 bits, MSB-first (ac.c:133-140)
    R.buf = bitrev32(get_bits(R, io.words, io.iw, 31)) >> 1;
  }
  for (int i = par.tid(); i < 256; i += par.nthr()) R.ch[i] = 1;
  par.sync();

  // every event of a valid stream but EOF emits at least one byte
  for (int steps = 0; !R.done; ++steps) {
    if (steps > io.block_bytes) {
      if (par.leader()) R.flags |= OF_STEPS;
      break;
    }

    // (1) leader: the event symbol (x3.c:293); for E_NEW its length and
    // bytes (x3.c:274, 300); E_EOF ends the lane
    if (par.leader()) {
      uint32_t step, value;
      const int etot = small_stats(R.ev, E_LAST, 0).total;
      dec_value(R, etot, step, value);
      const Sym e = small_decode(R.ev, E_LAST, value);
      dec_update(R, io, step, e.low, e.low + e.span);
      R.ev[e.sym] += 1;
      if (e.sym != E_EOF) R.counts[e.sym] += 1;  // x3.c never counts EOF
      sh.esym = e.sym;
      sh.evbits = bits(prob(e.span, etot));
      sh.op = OP_NONE;
      if (e.sym == E_EOF) {
        R.sizes[E_EOF] = fadd(R.sizes[E_EOF], sh.evbits);
        R.done = 1;
      } else if (e.sym == E_NEW) {
        const int mtot = small_stats(R.ms, MML, 0).total;
        dec_value(R, mtot, step, value);
        const Sym l = small_decode(R.ms, MML, value);
        dec_update(R, io, step, l.low, l.low + l.span);
        R.ms[l.sym] += 1;
        const int len = l.sym + 1;
        // byte k follows k bytes of the fragment, each of which added one
        // to the char model's total
        const int ctot = small_stats(R.ch, 256, 0).total;
        float lit = 0.0f;
        for (int k = 0; k < MML; ++k) {
          if (k >= len) {
            sh.t32[k] = 0;
            continue;
          }
          dec_value(R, ctot + k, step, value);
          const Sym c = small_decode(R.ch, 256, value);
          dec_update(R, io, step, c.low, c.low + c.span);
          R.ch[c.sym] += 1;
          lit = fadd(lit, bits(prob(c.span, ctot + k)));
          sh.t32[k] = (uint8_t)c.sym;
        }
        sh.flen = len;
        const float msb = bits(prob(l.span, mtot));
        R.sizes[E_NEW] = fadd(R.sizes[E_NEW], fadd(fadd(sh.evbits, msb), lit));
      }
    }
    par.sync();
    const int esym = sh.esym;

    if (esym == E_NEW) {
      // (2) E_NEW: insert unless an exact duplicate (x3.c:309-317), emit
      const Probe pr = probe(par, strs, lens, R.dn, sh.t32);
      if (par.leader()) {
        const int len = sh.flen;
        sh.op_n = R.dn;
        if (!((pr.okmask >> (len - 1)) & 1u)) {
          if (R.dn < D) {
            ix[R.dn] = 1;
            for (int i = 0; i < MML; ++i)
              strs[(int64_t)R.dn * MML + i] = sh.t32[i];
            lens[R.dn] = len;
            sh.op = OP_INSERT;
            R.dn += 1;
          } else {
            R.flags |= OF_DICT;
          }
        }
        emit(R, io, sh.t32, len);
        R.prev_c1 = 0;
        R.c1 = 0;
      }
    } else if (esym != E_EOF) {
      // (3) hit: resolve contexts, decode the payload by mode (x3.c:57-129)
      const View vp = view(pl.f1, R.hub_n[1], R.prev_c1);
      const Found fp = find(par, pl.f1, vp, R.hub_n[1], R.c1);
      const View v0 = view(pl.f0, R.hub_n[0], fp.found ? fp.pair_id : 0);
      const View v1 = view(pl.f1, R.hub_n[1], R.c1);
      const bool c0 = esym == E_CTX0;
      const FamP F = c0 ? pl.f0 : pl.f1;  // a copy: no table's address taken
      const View& v = c0 ? v0 : v1;
      const int hub_n = R.hub_n[c0 ? 0 : 1];
      int ptot;
      if (esym == E_IDX1) ptot = model_stats(par, ix, D, 0).total;
      else ptot = ctx_stats(par, F, v, hub_n, 0).total;
      ptot = imax(ptot, 1);
      uint32_t step, value;
      dec_value(R, ptot, step, value);
      Sym ps;
      int tag;
      if (esym == E_IDX1) {
        ps = decode_search(par, ix, D, true, value);
        tag = tag_of[imin(ps.sym, D - 1)];
      } else {
        const Row r = row_of(F, v, hub_n);
        ps = decode_search(par, freqs_of(F, v) + r.at, r.n, false, value);
        tag = tags_of(F, v)[r.at + ps.sym];  // ps.sym < max(r.n, 1)
      }
      // (4) contexts: find the tag in both, then update (x3.c:99-127)
      const Found f0 = find(par, pl.f0, v0, R.hub_n[0], tag);
      const Found f1 = find(par, pl.f1, v1, R.hub_n[1], tag);
      par.sync();  // every thread is done reading R and the tables
      if (par.leader()) {
        dec_update(R, io, step, ps.low, ps.low + ps.span);
        if (esym == E_IDX1) ix[imin(ps.sym, D - 1)] += 1;
        R.sizes[esym] =
            fadd(R.sizes[esym], fadd(sh.evbits, bits(prob(ps.span, ptot))));
        ctx_update(pl.f0, R, 0, OF_CTX0, v0, tag, f0, 0, -1);
        ctx_update(pl.f1, R, 1, OF_CTX1, v1, tag, f1, R.pair_n, -1);
        if (!f1.found) {
          // the encoder's one-early pair flag
          if (R.pair_n >= L.f0.S) R.flags |= OF_PAIRS;
          R.pair_n += 1;
        }
        const int t = iclamp(tag, 0, D - 1);
        sh.op = OP_MTF;
        sh.op_n = R.dn;
        sh.op_r = rank_of[t];
        sh.op_tag = tag;
        emit(R, io, strs + (int64_t)t * MML, lens[t]);
        R.prev_c1 = R.c1;
        R.c1 = tag;
      }
    }
    par.sync();

    // (5) dictionary recency ranks and rank -> tag map
    update_ranks(par, sh, rank_of, tag_of);
    par.sync();
  }

  if (par.leader()) {
    *io.out_len = R.opos;
    for (int e = 0; e < E_LAST; ++e) {
      io.counts[e] = R.counts[e];
      io.sizes[e] = R.sizes[e];
    }
    *io.flags = R.flags;
  }
}

}  // namespace x3
