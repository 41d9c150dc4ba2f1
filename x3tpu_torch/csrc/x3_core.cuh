// The x3 encoder event loop for one lane (one independent block), and the
// pieces the decoder (x3_dec_core.cuh) shares with it, written once for
// the CUDA kernels (x3_encoder.cu, x3_decoder.cu: one CTA per lane) and for
// a host build of the same source (x3_core_host.cpp, tests only).
//
// Semantics are those of x3tpu's XLA engine (x3tpu/codec.py _enc_body and
// the ops/ and models/ modules it calls), including its capacity model:
// three-tier context storage, drop-and-flag writes, sticky overflow bits.
// The plain PyTorch twin is x3tpu_torch/codec.py.
//
// Work split.  Every thread of the CTA runs encode_lane().  The O(D) and
// O(W) parts are shared by all threads through the Par policy: the
// dictionary probe, the window scan, context-row find and sums, the index
// model sums and the dictionary rank updates.  The serial chain (AC coder
// and bit sink, models, mode choice, context updates, pair registration,
// advance, EOF and flush) runs on the leader thread alone.  Values every
// thread needs are either reduction results (identical in all threads) or
// live in the Lane/Shared structs, written by the leader before a sync.
// On the host, Par is one thread: loops run serially, reductions and scans
// are the identity and syncs are no-ops.
#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif
#define X3_HD __host__ __device__ __forceinline__

namespace x3 {

constexpr int MML = 32;  // MAX_MATCH_LEN
constexpr int E_CTX0 = 0, E_CTX1 = 1, E_IDX1 = 2, E_NEW = 3, E_EOF = 4;
constexpr int E_LAST = 5;
constexpr uint32_t TOP = 0x7FFFFFFFu, FIRST_QUARTER = 0x20000000u;
constexpr uint32_t HALF = 0x40000000u, M31 = 0x7FFFFFFFu;
// EVENT_INIT_FREQS (x3.c:238-244): 1024 for CTX0 and CTX1, 1 for the rest
X3_HD int event_init_freq(int e) { return e < E_IDX1 ? 1024 : 1; }

// per-lane flag bits returned to the wrapper (x3tpu_torch/vm/driver.py)
constexpr int OF_DICT = 1, OF_CTX0 = 2, OF_CTX1 = 4, OF_PAIRS = 8;
constexpr int OF_OUT = 16, OF_STEPS = 32;

struct Params { int T, W, f1, f2, nl; };

struct Caps { int D, pair_cap, items1, items0, small_cap, promo_rows, out_words; };

// One context family's tables: offsets, in int32 words, into a lane's
// scratch (x3tpu/models/context.py CtxFamily; hub_n, promo_n and the
// overflow bit live in Lane).
struct Fam {
  int H, S, CS, M, CB, with_pair;
  int64_t hub_tags, hub_freqs, hub_pair, tags, freqs, pair, n, promo;
  int64_t big_tags, big_freqs, big_pair, big_n;
};

// Scratch layout of one lane.  The dictionary keeps strs (D x 32 bytes),
// lens, rank_of, tag_of (recency rank -> tag) and the index model ix; only
// the decoder keeps tag_of, and the encoder leaves it zero.
struct Layout {
  int D;
  int64_t strs, lens, rank_of, tag_of, ix;
  Fam f0, f1;
  int64_t words;  // int32 words per lane
};

X3_HD int imin(int a, int b) { return a < b ? a : b; }
X3_HD int imax(int a, int b) { return a > b ? a : b; }
X3_HD int iclamp(int x, int lo, int hi) { return imin(imax(x, lo), hi); }

X3_HD Fam make_fam(int H, int S, int items, int small_cap, int promo_rows,
                   int with_pair, int64_t& at) {
  Fam f;
  f.H = H;
  f.S = S;
  f.CS = imin(small_cap, items);  // big rows must fit a small copy
  f.M = promo_rows ? promo_rows : imax(S / 8, 16);
  f.CB = items;
  f.with_pair = with_pair;
  const int64_t hs = H, ss = (int64_t)S * f.CS, bs = (int64_t)f.M * f.CB;
  f.hub_tags = at; at += hs;
  f.hub_freqs = at; at += hs;
  f.hub_pair = at; at += with_pair ? hs : 0;
  f.tags = at; at += ss;
  f.freqs = at; at += ss;
  f.pair = at; at += with_pair ? ss : 0;
  f.n = at; at += S;
  f.promo = at; at += S;
  f.big_tags = at; at += bs;
  f.big_freqs = at; at += bs;
  f.big_pair = at; at += with_pair ? bs : 0;
  f.big_n = at; at += f.M;
  return f;
}

// x3tpu/codec.py _init_shared: ctx0 (pair contexts, no pair payload) has
// pair_cap small rows; ctx1 has dict_cap rows and carries pair ids.
X3_HD Layout make_layout(const Caps& c) {
  Layout L;
  int64_t at = 0;
  L.D = c.D;
  L.strs = at; at += (int64_t)c.D * (MML / 4);
  L.lens = at; at += c.D;
  L.rank_of = at; at += c.D;
  L.tag_of = at; at += c.D;
  L.ix = at; at += c.D;
  L.f0 = make_fam(c.D, c.pair_cap, c.items0, c.small_cap, c.promo_rows, 0, at);
  L.f1 = make_fam(c.D, c.D, c.items1, c.small_cap, c.promo_rows, 1, at);
  L.words = at;
  return L;
}

// Scalar state of one lane.  Shared memory on the device.
struct Lane {
  uint32_t low, high;  // AC interval
  int scale;           // pending underflow bits (encoder)
  int nbits;           // bits written to the sink (encoder)
  uint32_t buf;        // AC decode buffer (decoder)
  uint32_t acc;        // bit source: current word (decoder)
  int used, widx, nwords;  // bit source: bits used of acc, next word, words
  int opos, done;      // output bytes written, lane finished (decoder)
  int flags;           // OF_* bits
  int p, tlen, prev_c1, c1, pair_n, dn;
  int hub_n[2], promo_n[2];
  int ev[E_LAST], counts[E_LAST];
  float sizes[E_LAST];
  int ms[MML];
  int ch[256];
};

// Per-event values handed from the leader or the whole CTA to all threads.
struct Shared {
  uint8_t t32[MML];    // text[p, p+32) or the decoded fragment, zero-padded
  int hist[MML + 1];   // window scan: positions by run length
  int counts[MML];     // count[i] = positions repeating the first i+1 bytes
  int cumch[256];      // exclusive prefix of the char model
  int op, op_n, op_r, op_tag;  // dictionary rank update for this event
  int esym, flen;      // decoder: the event and an E_NEW fragment's length
  float evbits;        // decoder: the event symbol's size estimate
  unsigned long long red[32];  // block-reduction and scan scratch
};

enum { OP_NONE = 0, OP_MTF = 1, OP_INSERT = 2 };

struct OpOr { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a | b; } };
struct OpMax { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a > b ? a : b; } };
struct OpMin { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a < b ? a : b; } };
struct OpSum { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a + b; } };

// The host policy: one thread does everything.
struct ParHost {
  X3_HD int tid() const { return 0; }
  X3_HD int nthr() const { return 1; }
  X3_HD bool leader() const { return true; }
  X3_HD void sync() const {}
  template <class Op> X3_HD uint64_t reduce(uint64_t v, Op) const { return v; }
  X3_HD uint64_t scan_excl(uint64_t) const { return 0; }  // exclusive prefix
  X3_HD void hist_add(int* h, int bin) const { h[bin] += 1; }
};

#ifdef __CUDACC__
// The device policy: the CTA's threads, block reductions and scans through
// shared memory, shared-memory atomics for the scan histogram.  nvcc's host
// pass compiles the kernels' bodies too; there the policy is the one-thread
// ParHost, which is never run.
struct ParDev
#ifndef __CUDA_ARCH__
    : ParHost
#endif
{
  unsigned long long* scratch;  // >= blockDim.x / 32 entries, shared
#ifdef __CUDA_ARCH__
  __device__ int tid() const { return threadIdx.x; }
  __device__ int nthr() const { return blockDim.x; }
  __device__ bool leader() const { return threadIdx.x == 0; }
  __device__ void sync() const { __syncthreads(); }
  __device__ void hist_add(int* h, int bin) const { atomicAdd(h + bin, 1); }
  template <class Op>
  __device__ uint64_t reduce(uint64_t v, Op op) const {
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, (uint64_t)__shfl_down_sync(0xffffffffu, (unsigned long long)v, o));
    const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    __syncthreads();  // the previous reduction's readers are done
    if ((threadIdx.x & 31) == 0) scratch[w] = v;
    __syncthreads();
    uint64_t r = scratch[0];
    for (int i = 1; i < nw; ++i) r = op(r, (uint64_t)scratch[i]);
    return r;
  }
  // Sum of v over the threads before this one.
  __device__ uint64_t scan_excl(uint64_t v) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    uint64_t x = v;  // inclusive prefix within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y =
          (uint64_t)__shfl_up_sync(0xffffffffu, (unsigned long long)x, o);
      if (lane >= o) x += y;
    }
    __syncthreads();  // the previous reduction's readers are done
    if (lane == 31) scratch[w] = x;
    __syncthreads();
    uint64_t base = 0;
    for (int i = 0; i < w; ++i) base += scratch[i];
    return base + x - v;
  }
#endif
};
#endif

// ---------------------------------------------------------------------------
// f32 arithmetic as the reference's C floats: round-to-nearest, no
// contraction (the mode choice is a strict-greater chain over products of
// quotients, so a fused or approximate operation changes streams).
// ---------------------------------------------------------------------------

X3_HD float fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
X3_HD float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
X3_HD float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
X3_HD float prob(int span, int total) { return fdiv((float)span, (float)total); }
// prob_to_bits (x3.c:52-55)
X3_HD float bits(float p) { return -log2f(p > 1e-38f ? p : 1e-38f); }

X3_HD int clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz((int)x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

X3_HD uint32_t bitrev32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __brev(x);
#else
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  return (x << 16) | (x >> 16);
#endif
}

// ---------------------------------------------------------------------------
// Bit sink and arithmetic coder (leader only; x3tpu/ops/bitio.py,
// x3tpu/ops/ac.py).  Words past out_words are dropped and set OF_OUT.
// ---------------------------------------------------------------------------

X3_HD void put_bits(Lane& R, uint32_t* words, int cap, uint32_t value, int count) {
  if (count <= 0) return;
  const uint32_t v = value & (count >= 32 ? 0xFFFFFFFFu : (1u << count) - 1u);
  const int widx = R.nbits >> 5;
  const uint32_t off = R.nbits & 31;
  if (widx < cap) words[widx] += v << off;
  const uint32_t spill = off == 0 ? 0u : v >> ((32u - off) & 31u);
  if (spill != 0 && widx + 1 < cap) words[widx + 1] += spill;
  const int end = R.nbits + count;
  if (end > cap * 32) R.flags |= OF_OUT;
  R.nbits = end;
}

X3_HD void put_bit(Lane& R, uint32_t* words, int cap, uint32_t bit) {
  const int widx = R.nbits >> 5;
  if (widx >= cap) {
    R.flags |= OF_OUT;
    return;
  }
  words[widx] += bit << (R.nbits & 31);
  R.nbits += 1;
}

// Code [low_f, high_f) / total and renormalize in closed form (ac.c:77-85,
// E1/E2/E3 as derived in x3tpu/ops/ac.py).
X3_HD void ac_encode(Lane& R, uint32_t* words, int cap, uint32_t low_f,
                     uint32_t high_f, uint32_t total) {
  const uint32_t tot = total < 1u ? 1u : total;
  const uint32_t step = (R.high - R.low + 1u) / tot;
  const uint32_t high = R.low + step * high_f - 1u;
  const uint32_t low = R.low + step * low_f;

  const int n = clz32(low ^ high) - 1;  // common leading bits (< 2^31)
  const uint32_t v = n > 0 ? low >> (31 - n) : 0u;
  const uint32_t ones = (1u << n) - 1u;
  const uint32_t low1 = (low << n) & M31;
  const uint32_t high1 = ((high << n) | ones) & M31;
  const int m1 = clz32(~(low1 << 2));  // ones after low1's top 0
  const int m2 = clz32(high1 << 2);    // zeros after high1's top 1
  const int m = imin(imin(m1, m2), 30);
  const uint32_t sub = (HALF << m) - HALF;  // H * (2^m - 1) mod 2^32
  const uint32_t low2 = (low1 << m) - sub;
  const uint32_t high2 = (high1 << m) - sub + (1u << m) - 1u;

  int scale = R.scale;
  if (n > 0) {
    // b0, then `scale` copies of !b0, then the n-1 remaining bits
    const uint32_t b0 = (v >> (n - 1)) & 1u;
    put_bits(R, words, cap, b0, 1);
    for (int left = scale; left > 0; left -= 31) {
      const int chunk = imin(left, 31);
      put_bits(R, words, cap, b0 ? 0u : (1u << chunk) - 1u, chunk);
    }
    const int tail_n = n - 1;
    if (tail_n > 0) {
      const uint32_t tail = v & ((1u << tail_n) - 1u);
      put_bits(R, words, cap, bitrev32(tail) >> ((32 - tail_n) & 31), tail_n);
    }
    scale = 0;
  }
  R.low = low2;
  R.high = high2;
  R.scale = scale + m;
}

// Terminate the stream: 1 bit, or (scale+2) bits (ac.c:115-126).
X3_HD void ac_flush(Lane& R, uint32_t* words, int cap) {
  const bool low_branch = R.low < FIRST_QUARTER;
  put_bit(R, words, cap, low_branch ? 0u : 1u);
  if (low_branch)
    for (int left = R.scale + 1; left > 0; left -= 31) {
      const int chunk = imin(left, 31);
      put_bits(R, words, cap, (1u << chunk) - 1u, chunk);
    }
}

// ---------------------------------------------------------------------------
// Collective pieces (all threads): dictionary probe, window scan, row find
// and sums.  Each returns the same value in every thread.
// ---------------------------------------------------------------------------

struct Probe {
  uint32_t okmask;  // bit k-1: an entry of length k prefixes the target
  int len;          // longest such entry (0 = none)
  int slot;         // its tag (0 when none, as x3tpu's argmax)
};

// Longest dictionary entry that prefixes tgt (dict.c:105-130).  Entries
// are distinct strings, so the longest match is unique and needs no
// tie-break; okmask also answers the exact-duplicate query
// (dict_has_exact) for any fragment length.
template <class P>
X3_HD Probe probe(const P& par, const uint8_t* strs, const int32_t* lens, int n,
                  const uint8_t* tgt) {
  uint32_t mask = 0;
  uint64_t best = 0;
  for (int e = par.tid(); e < n; e += par.nthr()) {
    const int len = lens[e];
    if (len <= 0) continue;
    const uint8_t* s = strs + (int64_t)e * MML;
    int k = 0;
    while (k < len && s[k] == tgt[k]) ++k;
    if (k == len) {
      mask |= 1u << (len - 1);
      const uint64_t key = ((uint64_t)len << 32) | (uint32_t)e;
      if (key > best) best = key;
    }
  }
  Probe r;
  r.okmask = (uint32_t)par.reduce(mask, OpOr());
  best = par.reduce(best, OpMax());
  r.len = (int)(best >> 32);
  r.slot = r.len ? (int)(best & 0xFFFFFFFFu) : 0;
  return r;
}

// count[i] = window positions s in [p+1, p+W-32) whose next i+1 bytes
// repeat those at p (backend.c:66-74): each position's run length goes
// into a histogram, and suffix sums give the counts.
template <class P>
X3_HD void window_counts(const P& par, const uint8_t* win, int W, Shared& sh) {
  const int S = W - MML - 1;
  for (int i = par.tid(); i <= MML; i += par.nthr()) sh.hist[i] = 0;
  par.sync();
  for (int j = par.tid(); j < S; j += par.nthr()) {
    const uint8_t* s = win + 1 + j;
    int r = 0;
    while (r < MML && s[r] == sh.t32[r]) ++r;
    if (r) par.hist_add(sh.hist, r);
  }
  par.sync();
  if (par.leader()) {
    int acc = 0;
    for (int i = MML - 1; i >= 0; --i) {
      acc += sh.hist[i + 1];
      sh.counts[i] = acc;
    }
  }
  par.sync();
}

X3_HD int argmax_key(uint32_t ok, const int* level) {
  int best = -1, key = -1;
  for (int i = 0; i < MML; ++i)
    if (((ok >> i) & 1u) && level[i] * MML + i > key) {
      key = level[i] * MML + i;
      best = i;
    }
  return best;
}

// The chosen new-fragment length >= 1 (find_best_match, backend.c:56-100;
// x3tpu/ops/match.py best_match_sweep, all three branches).
template <class P>
X3_HD int sweep(const P& par, const Params& prm, const Shared& sh,
                const uint8_t* strs, const int32_t* lens, int n,
                const uint8_t* win) {
  if (prm.T < 1) return 1;
  uint32_t cand = 0;
  int level[MML];
  for (int i = 0; i < MML; ++i) {
    if (sh.counts[i] >= 2) cand |= 1u << i;
    level[i] = imin(sh.counts[i] - 1, prm.T);
  }
  if (prm.f1 == 0 && prm.f2 == 0) {
    const int bi = argmax_key(cand, level);
    return bi < 0 ? 1 : bi + 1;
  }
  if (prm.f2 > 0) {
    // vl[o] does not depend on the candidate, and a vetoed candidate is
    // vetoed at every threshold: argmax over the survivors
    uint32_t veto = 0;
    int pm = -(1 << 20);
    for (int i = 1; i < MML; ++i) {
      const int vl = probe(par, strs, lens, n, win + i).len;
      pm = imax(pm, vl - i);
      const bool v1 = prm.f1 > 0 && i >= 2 && vl > 0 && vl * prm.f1 > i + 1;
      const bool v2 = pm * prm.f2 > i + 1;
      if (v1 || v2) veto |= 1u << i;
    }
    const int bi = argmax_key(cand & ~veto, level);
    return bi < 0 ? 1 : bi + 1;
  }
  // f1 only: best remaining candidate, probe at its offset, drop if vetoed
  uint32_t rem = cand;
  for (;;) {
    const int bi = argmax_key(rem, level);
    if (bi < 0) return 1;  // out of candidates (backend.c:99)
    if (bi < 2) return bi + 1;
    const int dl = probe(par, strs, lens, n, win + bi).len;
    if (!(dl > 0 && dl * prm.f1 > bi + 1)) return bi + 1;
    rem &= ~(1u << bi);
  }
}

// A context's table with its tier resolved (x3tpu ctx_view).
struct View {
  bool hub, big;
  int row, brow, n;
};

X3_HD View view(const Fam& F, const int32_t* scr, int hub_n, int cid) {
  View v;
  v.hub = cid == 0;
  v.row = iclamp(cid - 1, 0, F.S - 1);
  const int pr = scr[F.promo + v.row];
  v.big = !v.hub && pr > 0;
  v.brow = iclamp(pr - 1, 0, F.M - 1);
  v.n = v.hub ? hub_n : (v.big ? scr[F.big_n + v.brow] : scr[F.n + v.row]);
  return v;
}

// Row of the selected tier: offset of item 0, capacity, items in use.
struct Row { int64_t at; int cap, n; };

X3_HD Row row_of(const Fam& F, const View& v, int hub_n) {
  Row r;
  if (v.hub) {
    r.at = 0;
    r.cap = F.H;
    r.n = imin(hub_n, F.H);
  } else if (v.big) {
    r.at = (int64_t)v.brow * F.CB;
    r.cap = F.CB;
    r.n = imin(v.n, F.CB);
  } else {
    r.at = (int64_t)v.row * F.CS;
    r.cap = F.CS;
    r.n = imin(v.n, F.CS);
  }
  return r;
}

X3_HD int64_t tags_of(const Fam& F, const View& v) {
  return v.hub ? F.hub_tags : (v.big ? F.big_tags : F.tags);
}
X3_HD int64_t freqs_of(const Fam& F, const View& v) {
  return v.hub ? F.hub_freqs : (v.big ? F.big_freqs : F.freqs);
}
X3_HD int64_t pairs_of(const Fam& F, const View& v) {
  return v.hub ? F.hub_pair : (v.big ? F.big_pair : F.pair);
}

struct Found {
  bool found;
  int pos;      // insertion index == model symbol (0 when not found)
  int pair_id;  // pair slot at pos (ctx1 family)
};

// Locate tag in the context (ctx_query_tag_index, context.c:31-40).
template <class P>
X3_HD Found find(const P& par, const Fam& F, const int32_t* scr, const View& v,
                 int hub_n, int tag) {
  const Row r = row_of(F, v, hub_n);
  const int32_t* tags = scr + tags_of(F, v) + r.at;
  uint64_t first = 0xFFFFFFFFu;
  for (int i = par.tid(); i < r.n; i += par.nthr())
    if (tags[i] == tag && (uint64_t)i < first) first = i;
  first = par.reduce(first, OpMin());
  Found f;
  f.found = first != 0xFFFFFFFFu;
  f.pos = f.found ? (int)first : 0;
  f.pair_id = F.with_pair ? scr[pairs_of(F, v) + r.at + f.pos] : 0;
  return f;
}

struct Stats { int low, span, total; };

// (low_f, span, total) of the item at pos in the context's throwaway model
// (context.c:95-133).  span is read unmasked at min(pos, cap-1).
template <class P>
X3_HD Stats ctx_stats(const P& par, const Fam& F, const int32_t* scr,
                      const View& v, int hub_n, int pos) {
  const Row r = row_of(F, v, hub_n);
  const int32_t* fr = scr + freqs_of(F, v) + r.at;
  uint64_t acc = 0;  // total << 32 | low
  for (int i = par.tid(); i < r.n; i += par.nthr()) {
    const uint64_t f = (uint32_t)fr[i];
    acc += (f << 32) | (i < pos ? f : 0u);
  }
  acc = par.reduce(acc, OpSum());
  Stats s;
  s.low = (int)(acc & 0xFFFFFFFFu);
  s.total = (int)(acc >> 32);
  s.span = fr[imin(pos, r.cap - 1)];
  return s;
}

// (low_f, span, total) of symbol sym of a model of width m (adaptive.py).
template <class P>
X3_HD Stats model_stats(const P& par, const int32_t* freqs, int m, int sym) {
  uint64_t acc = 0;
  for (int i = par.tid(); i < m; i += par.nthr()) {
    const uint64_t f = (uint32_t)freqs[i];
    acc += (f << 32) | (i < sym ? f : 0u);
  }
  acc = par.reduce(acc, OpSum());
  Stats s;
  s.low = (int)(acc & 0xFFFFFFFFu);
  s.total = (int)(acc >> 32);
  s.span = freqs[imin(sym, m - 1)];
  return s;
}

// Leader-only serial model stats for the small models in Lane.
X3_HD Stats small_stats(const int* freqs, int m, int sym) {
  Stats s = {0, freqs[imin(sym, m - 1)], 0};
  for (int i = 0; i < m; ++i) {
    if (i < sym) s.low += freqs[i];
    s.total += freqs[i];
  }
  return s;
}

// ---------------------------------------------------------------------------
// Context update (leader only; x3tpu/models/context.py ctx_update for an
// active lane): bump the tag's freq, or append it with freq 1, promoting a
// full small row to a fresh big row.  Writes that do not fit are dropped
// and set the family's overflow bit, as in x3tpu.
// ---------------------------------------------------------------------------

X3_HD void ctx_update(const Fam& F, int32_t* scr, Lane& R, int fam, int ofbit,
                      const View& v, int tag, const Found& f, int new_pair_id) {
  const bool app = !f.found, inc = f.found;
  int& hub_n = R.hub_n[fam];
  int& promo_n = R.promo_n[fam];

  const bool hub_room = hub_n < F.H;
  if (v.hub && inc) scr[F.hub_freqs + imin(f.pos, F.H - 1)] += 1;
  if (v.hub && app && hub_room) {
    scr[F.hub_tags + hub_n] = tag;
    scr[F.hub_freqs + hub_n] = 1;
    if (F.with_pair) scr[F.hub_pair + hub_n] = new_pair_id;
    hub_n += 1;
  }

  const bool need_promo = !v.hub && !v.big && app && v.n >= F.CS;
  const bool do_promo = need_promo && promo_n < F.M;
  const int new_brow = promo_n;
  if (do_promo) {
    // copy the CS small items into the first CS slots of the (zero) big row
    const int64_t src = (int64_t)v.row * F.CS, dst = (int64_t)new_brow * F.CB;
    for (int i = 0; i < F.CS; ++i) {
      scr[F.big_tags + dst + i] = scr[F.tags + src + i];
      scr[F.big_freqs + dst + i] = scr[F.freqs + src + i];
      if (F.with_pair) scr[F.big_pair + dst + i] = scr[F.pair + src + i];
    }
    scr[F.big_n + new_brow] = v.n;
    scr[F.promo + v.row] = new_brow + 1;
    promo_n += 1;
  }
  const bool big_now = v.big || do_promo;
  const int brow_now = do_promo ? new_brow : v.brow;

  const bool sdo = !v.hub && !big_now;
  const int64_t srow = (int64_t)v.row * F.CS;
  if (sdo && inc) scr[F.freqs + srow + imin(f.pos, F.CS - 1)] += 1;
  if (sdo && app) {
    // v.n < CS unless a promotion failed (then the last slot is reused,
    // exactly as x3tpu's clamped scatter does)
    const int64_t i = srow + imin(v.n, F.CS - 1);
    scr[F.tags + i] = tag;
    scr[F.freqs + i] = 1;
    if (F.with_pair) scr[F.pair + i] = new_pair_id;
    scr[F.n + v.row] += 1;
  }

  const bool bdo = !v.hub && big_now;
  const bool big_room = v.n < F.CB;
  const int64_t brow = (int64_t)brow_now * F.CB;
  if (bdo && inc) scr[F.big_freqs + brow + imin(f.pos, F.CB - 1)] += 1;
  if (bdo && app && big_room) {
    const int64_t i = brow + imin(v.n, F.CB - 1);
    scr[F.big_tags + i] = tag;
    scr[F.big_freqs + i] = 1;
    if (F.with_pair) scr[F.big_pair + i] = new_pair_id;
    scr[F.big_n + brow_now] += 1;
  }

  if ((v.hub && app && !hub_room) || (need_promo && !do_promo) ||
      (bdo && app && !big_room))
    R.flags |= ofbit;
}

// Recency ranks after this event's dictionary op (dict.c:132-146): MTF
// bumps the entries more recent than the hit one and moves it to rank 0; an
// insert bumps all older entries (the new one, at op_n, has rank 0).  The
// ranks stay a permutation of the live entries, so tag_of (rank -> tag,
// the decoder's; nullptr for the encoder) changes exactly where a rank
// does.  Only changed entries are stored: after an MTF that is the few
// more recent than the hit one.
template <class P>
X3_HD void update_ranks(const P& par, const Shared& sh, int32_t* rank_of,
                        int32_t* tag_of) {
  if (sh.op == OP_NONE) return;
  const bool mtf = sh.op == OP_MTF;
  for (int e = par.tid(); e < sh.op_n; e += par.nthr()) {
    const int old = rank_of[e];
    int rk = old;
    if (!mtf) rk += 1;
    else if (e == sh.op_tag) rk = 0;
    else if (rk < sh.op_r) rk += 1;
    if (rk != old) {
      rank_of[e] = rk;
      if (tag_of) tag_of[rk] = e;
    }
  }
  if (!mtf && tag_of && par.leader()) tag_of[0] = sh.op_n;
}

// ---------------------------------------------------------------------------
// One lane, start to finish.
// ---------------------------------------------------------------------------

struct LaneIO {
  const uint8_t* text;  // the lane's padded text row
  int tlen;
  int32_t* scr;         // the lane's zeroed scratch (Layout::words)
  uint32_t* words;      // the lane's zeroed output row (out_words)
  int32_t* byte_len;
  int32_t* counts;      // [5]
  float* sizes;         // [5]
  int32_t* flags;
};

template <class P>
X3_HD void encode_lane(const P& par, const Params& prm, const Caps& cp,
                       const Layout& L, const LaneIO& io, Lane& R, Shared& sh) {
  int32_t* scr = io.scr;
  uint8_t* strs = (uint8_t*)(scr + L.strs);
  int32_t* lens = scr + L.lens;
  int32_t* rank_of = scr + L.rank_of;
  int32_t* ix = scr + L.ix;
  const int cap = cp.out_words;

  if (par.leader()) {
    R.low = 0;
    R.high = TOP;
    R.scale = R.nbits = R.flags = 0;
    R.p = R.prev_c1 = R.c1 = R.pair_n = R.dn = 0;
    R.tlen = io.tlen;
    R.hub_n[0] = R.hub_n[1] = R.promo_n[0] = R.promo_n[1] = 0;
    for (int e = 0; e < E_LAST; ++e) {
      R.ev[e] = event_init_freq(e);
      R.counts[e] = 0;
      R.sizes[e] = 0.0f;
    }
    for (int i = 0; i < MML; ++i) R.ms[i] = 1;
  }
  for (int i = par.tid(); i < 256; i += par.nthr()) R.ch[i] = 1;
  par.sync();

  // every event consumes at least one byte, so tlen events always suffice
  for (int steps = 0; R.p < R.tlen; ++steps) {
    if (steps >= io.tlen) {
      if (par.leader()) R.flags |= OF_STEPS;
      break;
    }
    const int p = R.p;
    const uint8_t* win = io.text + p;
    for (int i = par.tid(); i < MML; i += par.nthr()) sh.t32[i] = win[i];
    par.sync();

    // (1) dictionary probe at p (x3.c:381)
    const Probe pr = probe(par, strs, lens, R.dn, sh.t32);
    // (2) forward-window scan and threshold sweep (x3.c:383)
    window_counts(par, win, prm.W, sh);
    const int fbm = sweep(par, prm, sh, strs, lens, R.dn, win);

    // (3) selection (x3.c:381-383)
    int nl = pr.len;
    if (prm.nl) {
      const int lut[4] = {1, 4, 6, 8};
      nl = pr.len <= 4 ? lut[iclamp(pr.len - 1, 0, 3)] : 9999;
    }
    const bool hit = pr.len > 0 && nl >= fbm && p + pr.len <= R.tlen;
    const int mlen = iclamp(imin(fbm, R.tlen - p), 1, MML);
    const int tag = pr.slot;

    // (4) a hit's contexts and index model (x3.c:139-160)
    View vp, v0, v1;
    Found fp, f0, f1;
    Stats s0 = {0, 0, 0}, s1 = {0, 0, 0}, sx = {0, 0, 0};
    int rank = 0;
    if (hit) {
      vp = view(L.f1, scr, R.hub_n[1], R.prev_c1);
      fp = find(par, L.f1, scr, vp, R.hub_n[1], R.c1);
      v0 = view(L.f0, scr, R.hub_n[0], fp.found ? fp.pair_id : 0);
      f0 = find(par, L.f0, scr, v0, R.hub_n[0], tag);
      s0 = ctx_stats(par, L.f0, scr, v0, R.hub_n[0], f0.pos);
      v1 = view(L.f1, scr, R.hub_n[1], R.c1);
      f1 = find(par, L.f1, scr, v1, R.hub_n[1], tag);
      s1 = ctx_stats(par, L.f1, scr, v1, R.hub_n[1], f1.pos);
      rank = rank_of[tag];
      sx = model_stats(par, ix, L.D, rank);
    }

    // (5) the serial chain
    if (par.leader()) {
      const Stats es0 = small_stats(R.ev, E_LAST, 0);
      const int ev_tot = es0.total;
      int esym = E_NEW;
      float best = 0.0f;
      if (hit) {
        // strict-greater chain IDX1 -> CTX0 -> CTX1 over f32 products
        const float p0 = f0.found
            ? fmul(prob(R.ev[E_CTX0], ev_tot), prob(s0.span, imax(s0.total, 1)))
            : 0.0f;
        const float p1 = f1.found
            ? fmul(prob(R.ev[E_CTX1], ev_tot), prob(s1.span, imax(s1.total, 1)))
            : 0.0f;
        const float px =
            fmul(prob(R.ev[E_IDX1], ev_tot), prob(sx.span, imax(sx.total, 1)));
        esym = E_IDX1;
        best = px;
        if (p0 > best) { esym = E_CTX0; best = p0; }
        if (p1 > best) { esym = E_CTX1; best = p1; }
      }

      // event symbol
      const Stats es = small_stats(R.ev, E_LAST, esym);
      ac_encode(R, io.words, cap, es.low, es.low + es.span, es.total);
      R.ev[esym] += 1;
      R.counts[esym] += 1;

      // payload: ctx0 item | ctx1 item | recency rank | length-1
      const Stats ms = small_stats(R.ms, MML, mlen - 1);
      const Stats pl = esym == E_CTX0 ? s0 : esym == E_CTX1 ? s1
                       : esym == E_IDX1 ? sx : ms;
      ac_encode(R, io.words, cap, pl.low, pl.low + pl.span, pl.total);

      if (hit) {
        if (esym == E_IDX1) ix[imin(rank, L.D - 1)] += 1;
        R.sizes[esym] = fadd(R.sizes[esym], bits(best));
      } else {
        R.ms[mlen - 1] += 1;
        // literal bytes (x3.c:263-267): byte k's interval is the base
        // interval plus the earlier equal/smaller bytes of the fragment
        int acc = 0;
        for (int s = 0; s < 256; ++s) {
          sh.cumch[s] = acc;
          acc += R.ch[s];
        }
        float lit = 0.0f;
        for (int k = 0; k < mlen; ++k) {
          const int sym = sh.t32[k];
          int low = sh.cumch[sym], span = R.ch[sym];
          for (int j = 0; j < k; ++j) {
            low += sh.t32[j] < sym;
            span += sh.t32[j] == sym;
          }
          const int tot = acc + k;
          ac_encode(R, io.words, cap, low, low + span, tot);
          lit = fadd(lit, bits(prob(span, tot)));
        }
        for (int k = 0; k < mlen; ++k) R.ch[sh.t32[k]] += 1;
        const float evb = bits(prob(es.span, es.total));
        const float msb = bits(prob(ms.span, ms.total));
        R.sizes[E_NEW] = fadd(R.sizes[E_NEW], fadd(fadd(evb, msb), lit));
      }

      // dictionary: MTF on hit; insert on miss unless an exact duplicate
      sh.op = OP_NONE;
      sh.op_n = R.dn;
      if (hit) {
        sh.op = OP_MTF;
        sh.op_r = rank;
        sh.op_tag = tag;
      } else if (!((pr.okmask >> (mlen - 1)) & 1u)) {
        if (R.dn < L.D) {
          ix[R.dn] = 1;
          for (int i = 0; i < MML; ++i) strs[(int64_t)R.dn * MML + i] = sh.t32[i];
          lens[R.dn] = mlen;
          sh.op = OP_INSERT;
          R.dn += 1;
        } else {
          R.flags |= OF_DICT;
        }
      }

      // contexts and pair registration (x3.c:195-222)
      if (hit) {
        ctx_update(L.f0, scr, R, 0, OF_CTX0, v0, tag, f0, 0);
        ctx_update(L.f1, scr, R, 1, OF_CTX1, v1, tag, f1, R.pair_n);
        if (!f1.found) {
          // flag one id early, as x3tpu: a clamped row index can never
          // alias a live context before the sticky flag is set
          if (R.pair_n >= L.f0.S) R.flags |= OF_PAIRS;
          R.pair_n += 1;
        }
        R.prev_c1 = R.c1;
        R.c1 = tag;
        R.p = p + pr.len;
      } else {
        R.prev_c1 = 0;
        R.c1 = 0;
        R.p = p + mlen;
      }
    }
    par.sync();

    // (6) dictionary recency ranks (dict.c:132-146)
    update_ranks(par, sh, rank_of, nullptr);
    par.sync();
  }

  // EOF and flush (x3.c:432-433)
  if (par.leader()) {
    const Stats es = small_stats(R.ev, E_LAST, E_EOF);
    ac_encode(R, io.words, cap, es.low, es.low + es.span, es.total);
    ac_flush(R, io.words, cap);
    *io.byte_len = ((R.nbits + 31) >> 5) << 2;
    for (int e = 0; e < E_LAST; ++e) {
      io.counts[e] = R.counts[e];
      io.sizes[e] = R.sizes[e];
    }
    *io.flags = R.flags;
  }
}

}  // namespace x3
