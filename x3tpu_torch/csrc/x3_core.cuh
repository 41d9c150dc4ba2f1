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
// Memory.  A lane's tables live in a zeroed global scratch (make_layout);
// the encoder moves the hot planes of it (the text row, the dictionary
// planes, both hubs, the ctx1 row maps, the index model's tree) into the
// CTA's dynamic shared memory where the launch's plan puts them
// (place_smem; the plan itself is x3tpu_torch/vm/driver.py smem_plan).
// Every access goes through a pointer resolved once per lane (Planes), so
// both placements run the same code.
//
// Work split (encoder, one event).  Pass 1 ends in one barrier: every
// warp takes a share of the previous event's rank update; the second warp
// indexes the last new dictionary entry, probes the dictionary's hash
// index (a lookup a lane) and adds the last event's gain to the index
// model's tree (a node a lane); every other warp but the first takes the
// window scan (word-wide compares, a byte compare of four positions to
// skip the ones whose first byte differs, a histogram per warp); the
// first warp applies the previous hit's context updates and resolves this
// event's ctx0 and ctx1 rows; single warps take the char and length
// models' prefix sums and the literal bytes' duplicate corrections.  Every
// warp then derives the sweep from the histograms itself (a vetoed
// candidate costs each warp its own lookups, and no barrier).
// Pass 2 (hits) ends in one barrier: the ctx0 row and the ctx1 row are
// searched and summed, and the index model's tree read (a node a lane), by
// separate warps at once, each with its mode's f32 probability.  The
// leader thread then picks the mode, pushes the AC symbols into a
// shared-memory queue that K1's coder warp drains (code_lane), and updates
// the models and the dictionary while the rest wait at the event's last
// barrier.
//
// On the host, Par is one thread and one one-lane warp: loops run
// serially, reductions and scans are the identity and syncs are no-ops.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

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

// per-lane flag bits returned to the wrapper (x3tpu_torch/vm/driver.py);
// OF_CORRUPT: the decoder met a symbol value past its model's total
constexpr int OF_DICT = 1, OF_CTX0 = 2, OF_CTX1 = 4, OF_PAIRS = 8;
constexpr int OF_OUT = 16, OF_STEPS = 32, OF_CORRUPT = 64;

// Shared memory of one CTA (x3tpu_torch/vm/driver.py mirrors both): what a
// block may use on the card, and the most the kernels' static part (Lane,
// Shared) may take; the plan's planes get the rest.
constexpr int64_t SMEM_BLOCK_MAX = 232448;
constexpr int64_t SMEM_STATIC = 16384;
constexpr int NW_MAX = 32;  // warps in a CTA of at most 1024 threads

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

// The planes that may live in shared memory, in the plan's order (hottest
// first, then K1's index model tree); x3tpu_torch/vm/driver.py
// SMEM_PLANES names them.
enum {
  PL_TEXT, PL_STRS, PL_LENS, PL_RANK_OF, PL_IX, PL_F1_HUB_TAGS,
  PL_F1_HUB_FREQS, PL_F1_HUB_PAIR, PL_F0_HUB_TAGS, PL_F0_HUB_FREQS, PL_F1_N,
  PL_F1_PROMO, PL_IX_TREE, PL_COUNT
};

// Scratch layout of one lane.  The dictionary keeps strs (D x 32 bytes),
// lens, rank_of, tag_of (recency rank -> tag) and the index model ix; only
// the decoder reads tag_of.  Past the dictionary's live entries every
// plane is zero.  A seeded start (x3tpu/codec.py _init_shared) writes the
// K seeds' strs and lens, rank_of = tag_of = 0..K-1 and ix over its first
// K entries (seed_dict) before the launch; both kernels read the same
// planes, but K1 keeps ix as freqs (1 a seed; their tree, ix_tree_seed,
// past the layout) and K2 as their inclusive cumulative sum (1..K).
// sm[k] is plane k's byte offset in the CTA's dynamic shared memory, or -1
// where the plane stays in the scratch (the text row then stays in the
// kernel's input).
struct Layout {
  int D;
  int64_t strs, lens, rank_of, tag_of, ix;
  Fam f0, f1;
  int64_t words;  // int32 words per lane
  int64_t sm[PL_COUNT];
  int64_t smem_bytes;  // dynamic shared memory of a CTA
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
// pair_cap small rows; ctx1 has dict_cap rows and carries pair ids.  Every
// plane is in the scratch; place_smem moves some.
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
  for (int k = 0; k < PL_COUNT; ++k) L.sm[k] = -1;
  L.smem_bytes = 0;
  return L;
}

// K1's planes past the layout's words (K2's scratch has neither): the
// dictionary's hash index, hash_slots(D) u32 slots (the least power of two
// >= 2D), then the index model's tree, ix_tree_words(D) u32 nodes.
X3_HD int64_t hash_slots(int D) {
  int64_t h = 1;
  while (h < 2 * (int64_t)D) h <<= 1;
  return h;
}
X3_HD int64_t ix_tree_words(int D) { return (int64_t)D + 1; }

// Bytes of plane k (tb: the text row's width).
X3_HD int64_t plane_bytes(const Layout& L, int64_t tb, int k) {
  if (k == PL_TEXT) return tb;
  if (k == PL_STRS) return (int64_t)L.D * MML;
  if (k == PL_F1_N || k == PL_F1_PROMO) return 4 * (int64_t)L.f1.S;
  if (k == PL_IX_TREE) return 4 * ix_tree_words(L.D);
  return 4 * (int64_t)L.D;  // lens, rank_of, ix and the hubs (H = D)
}

// Put the planes of `mask` (bit k: plane k) into dynamic shared memory,
// packed in plane order at 16-byte boundaries.
X3_HD void place_smem(Layout& L, int64_t tb, uint32_t mask) {
  int64_t at = 0;
  for (int k = 0; k < PL_COUNT; ++k) {
    L.sm[k] = -1;
    if ((mask >> k) & 1u) {
      L.sm[k] = at;
      at += (plane_bytes(L, tb, k) + 15) & ~(int64_t)15;
    }
  }
  L.smem_bytes = at;
}

// The seeded start of a lane's zeroed scratch (the host build's; the
// wrapper writes the same planes with PyTorch, x3tpu_torch/vm/driver.py
// seed_scratch): the K seeds' strings (zero-padded, K x 32 bytes) and
// lengths at tags 0..K-1, rank_of = tag_of = 0..K-1, and the index model,
// freq 1 a seed (cumulative: 1..K, the decoder's inclusive sum).
inline void seed_dict(const Layout& L, int32_t* scr, const uint8_t* strs,
                      const int32_t* lens, int K, bool cumulative) {
  if (K <= 0) return;
  memcpy((uint8_t*)(scr + L.strs), strs, (size_t)K * MML);
  for (int j = 0; j < K; ++j) {
    scr[L.lens + j] = lens[j];
    scr[L.rank_of + j] = j;
    scr[L.tag_of + j] = j;
    scr[L.ix + j] = cumulative ? j + 1 : 1;
  }
}

// A family's planes as scratch offsets, in x3tpu_torch/vm/driver.py
// FAM_PLANES' order: out [12] (the layout query of warm_scratch).
X3_HD void fam_offsets(const Fam& F, long long* out) {
  const int64_t at[12] = {F.hub_tags, F.hub_freqs, F.hub_pair, F.tags,
                          F.freqs, F.pair, F.n, F.promo, F.big_tags,
                          F.big_freqs, F.big_pair, F.big_n};
  for (int k = 0; k < 12; ++k) out[k] = at[k];
}

// Scratch offset, in int32 words, of plane k (not PL_TEXT) of the plan.
X3_HD int64_t plane_offset(const Layout& L, int k) {
  switch (k) {
    case PL_STRS: return L.strs;
    case PL_LENS: return L.lens;
    case PL_RANK_OF: return L.rank_of;
    case PL_IX: return L.ix;
    case PL_F1_HUB_TAGS: return L.f1.hub_tags;
    case PL_F1_HUB_FREQS: return L.f1.hub_freqs;
    case PL_F1_HUB_PAIR: return L.f1.hub_pair;
    case PL_F0_HUB_TAGS: return L.f0.hub_tags;
    case PL_F0_HUB_FREQS: return L.f0.hub_freqs;
    case PL_F1_N: return L.f1.n;
    case PL_IX_TREE: return L.words + hash_slots(L.D);
    default: return L.f1.promo;  // PL_F1_PROMO
  }
}

// The counts a warm start begins from (x3tpu_torch/warm.py; x3tpu's
// R_PAIR_N, R_HUB0_N, R_HUB1_N): the registered pairs and both hubs'
// items, the same for every lane; all 0 without warm start.
struct WarmN {
  int pair_n, hub_n[2];
  X3_HD bool any() const { return (pair_n | hub_n[0] | hub_n[1]) != 0; }
};

// One context family's tables, resolved to pointers (scratch or shared).
struct FamP {
  int H, S, CS, M, CB, with_pair;
  int32_t *hub_tags, *hub_freqs, *hub_pair, *tags, *freqs, *pair, *n, *promo;
  int32_t *big_tags, *big_freqs, *big_pair, *big_n;
};

// A lane's planes, resolved once: every access goes through these.
struct Planes {
  const uint8_t* text;  // the lane's padded text row
  uint8_t* strs;
  int32_t *lens, *rank_of, *tag_of, *ix;
  FamP f0, f1;
};

// Plane k (-1: a plane that never moves) at scratch offset off.
X3_HD int32_t* plane_at(const Layout& L, int k, int32_t* scr, uint8_t* smem,
                        int64_t off) {
  return k >= 0 && L.sm[k] >= 0 ? (int32_t*)(smem + L.sm[k]) : scr + off;
}

X3_HD FamP resolve_fam(const Layout& L, const Fam& F, int32_t* scr,
                       uint8_t* smem, int hub_tags, int hub_freqs,
                       int hub_pair, int n, int promo) {
  FamP P;
  P.H = F.H;
  P.S = F.S;
  P.CS = F.CS;
  P.M = F.M;
  P.CB = F.CB;
  P.with_pair = F.with_pair;
  P.hub_tags = plane_at(L, hub_tags, scr, smem, F.hub_tags);
  P.hub_freqs = plane_at(L, hub_freqs, scr, smem, F.hub_freqs);
  P.hub_pair = plane_at(L, hub_pair, scr, smem, F.hub_pair);
  P.tags = scr + F.tags;
  P.freqs = scr + F.freqs;
  P.pair = scr + F.pair;
  P.n = plane_at(L, n, scr, smem, F.n);
  P.promo = plane_at(L, promo, scr, smem, F.promo);
  P.big_tags = scr + F.big_tags;
  P.big_freqs = scr + F.big_freqs;
  P.big_pair = scr + F.big_pair;
  P.big_n = scr + F.big_n;
  return P;
}

X3_HD Planes resolve(const Layout& L, int32_t* scr, uint8_t* smem,
                     const uint8_t* text) {
  Planes P;
  P.text = L.sm[PL_TEXT] >= 0 ? smem + L.sm[PL_TEXT] : text;
  P.strs = (uint8_t*)plane_at(L, PL_STRS, scr, smem, L.strs);
  P.lens = plane_at(L, PL_LENS, scr, smem, L.lens);
  P.rank_of = plane_at(L, PL_RANK_OF, scr, smem, L.rank_of);
  P.tag_of = scr + L.tag_of;
  P.ix = plane_at(L, PL_IX, scr, smem, L.ix);
  P.f0 = resolve_fam(L, L.f0, scr, smem, PL_F0_HUB_TAGS, PL_F0_HUB_FREQS, -1,
                     -1, -1);
  P.f1 = resolve_fam(L, L.f1, scr, smem, PL_F1_HUB_TAGS, PL_F1_HUB_FREQS,
                     PL_F1_HUB_PAIR, PL_F1_N, PL_F1_PROMO);
  return P;
}

// A context's table with its tier resolved (x3tpu ctx_view).
struct View {
  bool hub, big;
  int row, brow, n;
};

struct Found {
  bool found;
  int pos;      // insertion index == model symbol (0 when not found)
  int pair_id;  // pair slot at pos (ctx1 family)
};

struct Stats { int low, span, total; };

// Scalar state of one lane (K1).  Shared memory on the device.  The
// first nine fields belonged to an earlier decoder and are unused; they
// keep K1's shared-memory layout the one its times were measured with
// (removing them measured about 1 % slower, PERF.md §6).
struct Lane {
  uint32_t low, high, buf, acc;
  int used, widx, nwords, opos, done;
  int flags;           // OF_* bits
  int p, tlen, prev_c1, c1, pair_n, dn;
  int hub_n[2], promo_n[2];
  int ev[E_LAST], counts[E_LAST];
  float sizes[E_LAST];
  int ms[MML];
  int ch[256];
};

// K1's AC coder queue: the leader pushes each symbol's interval in order
// and goes on; the coder warp codes them (code_lane).  head and tail count
// symbols; done is set once the EOF symbol and the final flags are in.
constexpr int QCAP = 256;
struct CodeQueue {
  uint32_t e[QCAP][3];  // low_f, high_f, total
  int head, tail, done, flags;
};

// Per-event values handed from the leader or the whole CTA to all threads
// (K1).  esym and evbits are unused, as in Lane; t32 and flen are an
// inserted entry's key, for the hash index's warp.
struct Shared {
  alignas(16) uint8_t t32[MML];
  int op, op_n, op_r, op_tag;  // dictionary rank update for this event
  int esym, flen;
  float evbits;
  // block reductions and scans: two buffers of two values a warp
  unsigned long long red[2][2 * NW_MAX];
  // encoder, pass 1: per warp, the scan's positions repeating the first
  // i+1 bytes at p (a histogram of run lengths, then its suffix sums)
  int wcnt[NW_MAX][MML];
  int chpre[256], chw[8];  // char model: prefix within each 32, group sums
  int mspre[MML], mstot;   // length model: exclusive prefix, total
  uint8_t litlow[MML], litspan[MML];  // literal k: earlier bytes <, ==
  View v0, v1;             // a hit's ctx0 and ctx1 rows
  int ctx0_id;             // the ctx0 id if the last update gave it, else -1
  // encoder, pass 2 (hits): each mode's item, its stats and probability
  Found f0, f1;
  Stats s0, s1, sx;
  int rank;
  float p0, p1, px;
  CodeQueue q;
};

enum { OP_NONE = 0, OP_MTF = 1, OP_INSERT = 2 };

struct OpOr { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a | b; } };
struct OpMax { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a > b ? a : b; } };
struct OpSum { X3_HD uint64_t operator()(uint64_t a, uint64_t b) const { return a + b; } };

// The host policy: one thread, one warp of one lane, does everything.
struct ParHost {
  static constexpr int WS = 1;  // lanes a warp
  X3_HD int tid() const { return 0; }
  X3_HD int nthr() const { return 1; }
  X3_HD int lane() const { return 0; }
  X3_HD int warp() const { return 0; }
  X3_HD int nwarps() const { return 1; }
  X3_HD bool leader() const { return true; }
  X3_HD void sync() const {}
  X3_HD void syncwarp() const {}
  template <class Op> X3_HD uint64_t reduce(uint64_t v, Op) const { return v; }
  template <class OpA, class OpB>
  X3_HD void reduce2(uint64_t&, OpA, uint64_t&, OpB) const {}
  X3_HD uint64_t scan_excl(uint64_t) const { return 0; }  // exclusive prefix
  X3_HD void hist_add(int* h, int bin) const { h[bin] += 1; }
  // warp-wide: every lane gets the result
  X3_HD uint32_t wor(uint32_t v) const { return v; }
  X3_HD int wmax(int v) const { return v; }
  X3_HD uint32_t wminu(uint32_t v) const { return v; }
  X3_HD int wsum(int v) const { return v; }
  X3_HD int wscan_excl(int) const { return 0; }    // sum over lanes below
  X3_HD int wsuffix_excl(int) const { return 0; }  // sum over lanes above
};

#ifdef __CUDACC__
// The device policy: the CTA's threads but K1's coder warp.  A block
// reduction or scan costs
// one barrier: its warps' partials go to one of two buffers in turn (the
// barrier of reduction k+1 keeps reduction k+2 from overwriting what a slow
// thread still reads of reduction k).  Warp-wide operations are shuffles
// and the sm_80 warp reductions.  nvcc's host pass compiles the kernels'
// bodies too; there the policy is the one-thread ParHost, never run.
struct ParDev
#ifndef __CUDA_ARCH__
    : ParHost
#endif
{
  unsigned long long* scratch;  // Shared::red
  int n;                        // threads 0..n-1 take part (whole warps)
  mutable int buf = 0;          // the reduction buffer next in turn
#ifdef __CUDA_ARCH__
  static constexpr int WS = 32;
  __device__ int tid() const { return threadIdx.x; }
  __device__ int nthr() const { return n; }
  __device__ int lane() const { return threadIdx.x & 31; }
  __device__ int warp() const { return threadIdx.x >> 5; }
  __device__ int nwarps() const { return n >> 5; }
  __device__ bool leader() const { return threadIdx.x == 0; }
  // a barrier of the n threads (named barrier 1: K1's coder warp is not
  // one of them)
  __device__ void sync() const {
    asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
  }
  __device__ void syncwarp() const { __syncwarp(); }
  __device__ void hist_add(int* h, int bin) const { atomicAdd(h + bin, 1); }
  template <class Op>
  __device__ static uint64_t warp_reduce(uint64_t v, Op op) {
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, (uint64_t)__shfl_xor_sync(0xffffffffu, (unsigned long long)v, o));
    return v;
  }
  __device__ unsigned long long* next_buf() const {
    unsigned long long* b = scratch + buf * 2 * NW_MAX;
    buf ^= 1;
    return b;
  }
  template <class Op>
  __device__ uint64_t reduce(uint64_t v, Op op) const {
    v = warp_reduce(v, op);
    unsigned long long* b = next_buf();
    if (lane() == 0) b[warp()] = v;
    sync();
    uint64_t r = b[0];
    for (int i = 1; i < nwarps(); ++i) r = op(r, (uint64_t)b[i]);
    return r;
  }
  // Two reductions in one round.
  template <class OpA, class OpB>
  __device__ void reduce2(uint64_t& a, OpA opa, uint64_t& c, OpB opc) const {
    a = warp_reduce(a, opa);
    c = warp_reduce(c, opc);
    unsigned long long* b = next_buf();
    if (lane() == 0) {
      b[warp()] = a;
      b[NW_MAX + warp()] = c;
    }
    sync();
    a = b[0];
    c = b[NW_MAX];
    for (int i = 1; i < nwarps(); ++i) {
      a = opa(a, (uint64_t)b[i]);
      c = opc(c, (uint64_t)b[NW_MAX + i]);
    }
  }
  // Sum of v over the threads before this one.
  __device__ uint64_t scan_excl(uint64_t v) const {
    const int l = lane();
    uint64_t x = v;  // inclusive prefix within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y =
          (uint64_t)__shfl_up_sync(0xffffffffu, (unsigned long long)x, o);
      if (l >= o) x += y;
    }
    unsigned long long* b = next_buf();
    if (l == 31) b[warp()] = x;
    sync();
    uint64_t base = 0;
    for (int i = 0; i < warp(); ++i) base += b[i];
    return base + x - v;
  }
  __device__ uint32_t wor(uint32_t v) const { return __reduce_or_sync(0xffffffffu, v); }
  __device__ int wmax(int v) const { return __reduce_max_sync(0xffffffffu, v); }
  __device__ uint32_t wminu(uint32_t v) const { return __reduce_min_sync(0xffffffffu, v); }
  __device__ int wsum(int v) const { return __reduce_add_sync(0xffffffffu, v); }
  __device__ int wscan_excl(int v) const {
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane() >= o) x += y;
    }
    return x - v;
  }
  __device__ int wsuffix_excl(int v) const {
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane() + o < 32) x += y;
    }
    return x - v;
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

// trailing zero bits of x != 0
X3_HD int ctz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

X3_HD int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
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

// The little-endian word at p, which is 4-byte aligned.
X3_HD uint32_t load_word(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *(const uint32_t*)p;
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// Store v as the little-endian word at p, which is 4-byte aligned.
X3_HD void store_word(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  *(uint32_t*)p = v;
#else
  memcpy(p, &v, 4);
#endif
}

// Bytes [pos, pos+4) of t as a little-endian word, at any alignment (the
// device reads the two aligned words around them, up to 7 bytes past pos).
X3_HD uint32_t text_word(const uint8_t* t, int pos) {
#ifdef __CUDA_ARCH__
  const uintptr_t a = (uintptr_t)(t + pos);
  const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
  return __funnelshift_r(w[0], w[1], (unsigned)(a & 3) * 8);
#else
  uint32_t v;
  memcpy(&v, t + pos, 4);
  return v;
#endif
}

// 0xFF in each byte where a and b4 agree.
X3_HD uint32_t eq_bytes(uint32_t a, uint32_t b4) {
#ifdef __CUDA_ARCH__
  return __vcmpeq4(a, b4);
#else
  uint32_t m = 0;
  for (int i = 0; i < 32; i += 8)
    if (((a >> i) & 0xFFu) == ((b4 >> i) & 0xFFu)) m |= 0xFFu << i;
  return m;
#endif
}

// 0xFF in bytes a..b-1 of a word (0 <= a, b <= 4).
X3_HD uint32_t byte_span(int a, int b) {
  const uint32_t below_b = b >= 4 ? 0xFFFFFFFFu : (1u << (8 * b)) - 1u;
  const uint32_t below_a = a >= 4 ? 0xFFFFFFFFu : (1u << (8 * a)) - 1u;
  return below_b & ~below_a;
}

// How many of the bytes of a flagged in m (0xFF a byte) are below, and
// equal to, the byte b4 repeats.
X3_HD int bytes_below(uint32_t a, uint32_t b4, uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(__vcmpltu4(a, b4) & m) >> 3;
#else
  int n = 0;
  for (int i = 0; i < 32; i += 8)
    n += ((m >> i) & 0xFFu) && ((a >> i) & 0xFFu) < ((b4 >> i) & 0xFFu);
  return n;
#endif
}
X3_HD int bytes_equal(uint32_t a, uint32_t b4, uint32_t m) {
  return popc32(eq_bytes(a, b4) & m) >> 3;
}

// ---------------------------------------------------------------------------
// Bit sink and arithmetic coder (leader only; x3tpu/ops/bitio.py,
// x3tpu/ops/ac.py).  The coder's state lives in registers, the word being
// filled too (cur); each word is stored to the output once, when it is
// complete or at the flush.  Words past out_words are dropped and set
// OF_OUT.
// ---------------------------------------------------------------------------

struct Coder {
  uint32_t low, high;  // AC interval
  int scale;           // pending underflow bits
  int nbits;           // bits written to the sink
  uint32_t cur;        // word nbits / 32, filled below bit nbits % 32
  int of_out;          // OF_OUT once a bit was dropped
};

X3_HD void put_bits(Coder& C, uint32_t* words, int cap, uint32_t value, int count) {
  if (count <= 0) return;
  const uint32_t v = value & (count >= 32 ? 0xFFFFFFFFu : (1u << count) - 1u);
  const int widx = C.nbits >> 5;
  const int off = C.nbits & 31;
  C.cur |= v << off;
  if (off + count >= 32) {  // word widx is complete
    if (widx < cap) words[widx] = C.cur;
    C.cur = off == 0 ? 0u : v >> (32 - off);
  }
  const int end = C.nbits + count;
  if (end > cap * 32) C.of_out = OF_OUT;
  C.nbits = end;
}

X3_HD void put_bit(Coder& C, uint32_t* words, int cap, uint32_t bit) {
  const int widx = C.nbits >> 5;
  if (widx >= cap) {
    C.of_out = OF_OUT;
    return;
  }
  C.cur |= bit << (C.nbits & 31);
  C.nbits += 1;
  if ((C.nbits & 31) == 0) {
    words[widx] = C.cur;
    C.cur = 0u;
  }
}

// Code [low_f, high_f) / total and renormalize in closed form (ac.c:77-85,
// E1/E2/E3 as derived in x3tpu/ops/ac.py).
X3_HD void ac_encode(Coder& C, uint32_t* words, int cap, uint32_t low_f,
                     uint32_t high_f, uint32_t total) {
  const uint32_t tot = total < 1u ? 1u : total;
  const uint32_t step = (C.high - C.low + 1u) / tot;
  const uint32_t high = C.low + step * high_f - 1u;
  const uint32_t low = C.low + step * low_f;

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

  int scale = C.scale;
  if (n > 0) {
    // b0, then `scale` copies of !b0, then the n-1 remaining bits
    const uint32_t b0 = (v >> (n - 1)) & 1u;
    put_bits(C, words, cap, b0, 1);
    for (int left = scale; left > 0; left -= 31) {
      const int chunk = imin(left, 31);
      put_bits(C, words, cap, b0 ? 0u : (1u << chunk) - 1u, chunk);
    }
    const int tail_n = n - 1;
    if (tail_n > 0) {
      const uint32_t tail = v & ((1u << tail_n) - 1u);
      put_bits(C, words, cap, bitrev32(tail) >> ((32 - tail_n) & 31), tail_n);
    }
    scale = 0;
  }
  C.low = low2;
  C.high = high2;
  C.scale = scale + m;
}

// Terminate the stream: 1 bit, or (scale+2) bits (ac.c:115-126); then
// store the last, partly filled word.
X3_HD void ac_flush(Coder& C, uint32_t* words, int cap) {
  const bool low_branch = C.low < FIRST_QUARTER;
  put_bit(C, words, cap, low_branch ? 0u : 1u);
  if (low_branch)
    for (int left = C.scale + 1; left > 0; left -= 31) {
      const int chunk = imin(left, 31);
      put_bits(C, words, cap, (1u << chunk) - 1u, chunk);
    }
  const int widx = C.nbits >> 5;
  if ((C.nbits & 31) && widx < cap) words[widx] = C.cur;
}

#ifdef __CUDACC__
// The leader's end of the queue: wait while it is full, then publish one
// symbol.  seen_head caches the coder's progress.
__device__ __forceinline__ void queue_push(CodeQueue& q, int& seen_head,
                                           uint32_t low_f, uint32_t high_f,
                                           uint32_t total) {
  volatile CodeQueue& vq = q;
  const int t = q.tail;  // the leader is its only writer
  while (t - seen_head >= QCAP) seen_head = vq.head;
  uint32_t* e = q.e[t % QCAP];
  e[0] = low_f;
  e[1] = high_f;
  e[2] = total;
  __threadfence_block();  // the entry before the tail that shows it
  vq.tail = t + 1;
}

// The coder warp's lane 0: code the queue's symbols in order until the
// leader is done, flush, and write the stream's length and the flags.
__device__ void code_lane(CodeQueue& q, uint32_t* words, int cap,
                          int32_t* byte_len, int32_t* flags) {
  volatile CodeQueue& vq = q;
  Coder C = {0u, TOP, 0, 0, 0u, 0};
  int head = 0;
  for (;;) {
    const int tail = vq.tail;
    if (head == tail) {
      if (vq.done) {
        __threadfence_block();
        if (vq.tail == head) break;
        continue;
      }
      __nanosleep(64);
      continue;
    }
    __threadfence_block();  // the entries up to tail
    for (; head < tail; ++head) {
      const uint32_t* e = q.e[head % QCAP];
      ac_encode(C, words, cap, e[0], e[1], e[2]);
    }
    vq.head = head;
  }
  ac_flush(C, words, cap);
  *byte_len = ((C.nbits + 31) >> 5) << 2;
  *flags = vq.flags | C.of_out;
}
#endif

// ---------------------------------------------------------------------------
// Dictionary probe and window scan (all threads; word-wide compares).
// ---------------------------------------------------------------------------

struct Probe {
  uint32_t okmask;  // bit k-1: an entry of length k prefixes the target
  int len;          // longest such entry (0 = none)
  int slot;         // its tag (0 when none, as x3tpu's argmax)
};

X3_HD Probe make_probe(uint64_t mask, uint64_t best) {
  Probe r;
  r.okmask = (uint32_t)mask;
  r.len = (int)(best >> 32);
  r.slot = r.len ? (int)(best & 0xFFFFFFFFu) : 0;
  return r;
}

// First byte where the len-byte entry s and the target words T differ
// (>= len: s prefixes the target).
X3_HD int match_len(const uint8_t* s, const uint32_t* T, int len) {
#pragma unroll
  for (int k = 0; k < MML / 4; ++k) {
    if (4 * k >= len) break;
    const uint32_t x = load_word(s + 4 * k) ^ T[k];
    if (x) return 4 * k + (ctz32(x) >> 3);
  }
  return MML;
}

// The same against the text at pos.
X3_HD int match_len_at(const uint8_t* s, const uint8_t* txt, int pos, int len) {
  for (int k = 0; 4 * k < len; ++k) {
    const uint32_t x = load_word(s + 4 * k) ^ text_word(txt, pos + 4 * k);
    if (x) return 4 * k + (ctz32(x) >> 3);
  }
  return MML;
}

// The 32 bytes of t at pos as words.
X3_HD void target_words(const uint8_t* t, int pos, uint32_t* T) {
#pragma unroll
  for (int k = 0; k < MML / 4; ++k) T[k] = text_word(t, pos + 4 * k);
}

// This thread's share of a probe (thread tid of nthr; none when tid < 0):
// the entries that prefix the target T.
template <class P>
X3_HD void probe_part(const P&, int tid, int nthr, const uint8_t* strs,
                      const int32_t* lens, int n, const uint32_t* T,
                      uint64_t& mask, uint64_t& best) {
  for (int e = tid; tid >= 0 && e < n; e += nthr) {
    const int len = lens[e];
    if (len <= 0) continue;
    if (match_len(strs + (int64_t)e * MML, T, len) >= len) {
      mask |= 1u << (len - 1);
      const uint64_t key = ((uint64_t)len << 32) | (uint32_t)e;
      if (key > best) best = key;
    }
  }
}

// Longest dictionary entry that prefixes tgt (dict.c:105-130).  Entries
// are distinct strings, so the longest match is unique and needs no
// tie-break; okmask also answers the exact-duplicate query
// (dict_has_exact) for any fragment length.
template <class P>
X3_HD Probe probe(const P& par, const uint8_t* strs, const int32_t* lens, int n,
                  const uint8_t* tgt) {
  uint32_t T[MML / 4];
  target_words(tgt, 0, T);
  uint64_t mask = 0, best = 0;
  probe_part(par, par.tid(), par.nthr(), strs, lens, n, T, mask, best);
  par.reduce2(mask, OpOr(), best, OpMax());
  return make_probe(mask, best);
}

// ---------------------------------------------------------------------------
// K1's hash index of the live dictionary entries: a probe is 32 lookups,
// one a candidate length, in place of probe_part's scan over every live
// entry (K2's probe), and gives its answer exactly.  The key of an entry is (its length L, its
// first L bytes).  The index is a plane of hash_slots(D) u32 slots after
// the lane's Layout::words (K1 only; K2's scratch has none), zeroed with
// the rest; a slot is 0 (empty) or the key hash's high bits over tag + 1
// in the low tag bits (HashIx::tmask), so that most misses read no string.
// Linear probing from the hash's low bits; a lookup walks its chain to the
// first empty slot and keeps the largest tag whose length and bytes match,
// so a seeded dictionary that holds a string twice answers as the scan.
// ---------------------------------------------------------------------------

// The largest dictionary the index takes: a slot keeps at least 7 bits of
// the hash above the tag.
constexpr int HASH_DICT_MAX = 1 << 24;

struct HashIx {
  uint32_t* slot;
  uint32_t hmask;  // slots - 1
  uint32_t tmask;  // a slot's tag + 1 bits (those of D)
};

// The index of `slots` slots (a power of two above the entries) at plane.
X3_HD HashIx hash_index(int32_t* plane, int64_t slots, int D) {
  HashIx x;
  x.slot = (uint32_t*)plane;
  x.hmask = (uint32_t)(slots - 1);
  x.tmask = (1u << (32 - clz32((uint32_t)D))) - 1u;
  return x;
}

// A key's words w(0..7), and whether the len-byte entry s is the key
// (match_len(s, T, len) >= len): the target T in registers, against whose
// words an entry's are loaded at once; or the text at pos (a veto's
// target), read and compared word by word, so that a veto keeps no
// registers for them (K1 spills with eight more live).
struct WordsOf {
  const uint32_t* T;
  X3_HD uint32_t operator()(int k) const { return T[k]; }
  X3_HD bool is_prefix(const uint8_t* s, int len) const {
    uint32_t d = 0;
#pragma unroll
    for (int k = 0; k < MML / 4; ++k)
      if (4 * k < len)
        d |= (load_word(s + 4 * k) ^ T[k]) & byte_span(0, imin(len - 4 * k, 4));
    return d == 0;
  }
};
struct WordsAt {
  const uint8_t* txt;
  int pos;
  X3_HD uint32_t operator()(int k) const { return text_word(txt, pos + 4 * k); }
  X3_HD bool is_prefix(const uint8_t* s, int len) const {
    return match_len_at(s, txt, pos, len) >= len;
  }
};
// The words of a 32-byte row (an entry's, or a new entry's key in Shared).
struct WordsRow {
  const uint8_t* row;
  X3_HD uint32_t operator()(int k) const { return load_word(row + 4 * k); }
};

// Hash of the key (len, the first len bytes of the words w(0..7)).
template <class W>
X3_HD uint32_t key_hash(const W& w, int len) {
  uint32_t h = 0x9E3779B9u * (uint32_t)len;
#pragma unroll
  for (int k = 0; k < MML / 4; ++k) {
    h = (h ^ (w(k) & byte_span(0, iclamp(len - 4 * k, 0, 4)))) * 0x85EBCA6Bu;
    h ^= h >> 15;
  }
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Tag + 1 of the largest tag whose entry is the key (len, w), 0 if none;
// visits counts the slots read.
template <class W>
X3_HD int hash_find(const HashIx& x, const uint8_t* strs, const int32_t* lens,
                    const W& w, int len, int& visits) {
  const uint32_t h = key_hash(w, len);
  int found = 0;
  for (uint32_t i = h & x.hmask;; i = (i + 1) & x.hmask) {
    const uint32_t s = x.slot[i];
    ++visits;
    if (!s) return found;
    const int t1 = (int)(s & x.tmask);
    if (((s ^ h) & ~x.tmask) == 0 && t1 > found && lens[t1 - 1] == len &&
        w.is_prefix(strs + (int64_t)(t1 - 1) * MML, len))
      found = t1;
  }
}

// Index tag, whose key hashes to h, at the first empty slot of its chain
// (one thread).
X3_HD void hash_insert(const HashIx& x, uint32_t h, int tag) {
  uint32_t i = h & x.hmask;
  while (x.slot[i]) i = (i + 1) & x.hmask;
  x.slot[i] = (h & ~x.tmask) | (uint32_t)(tag + 1);
}

// Put v into the empty slot p (false: p is taken).
X3_HD bool hash_claim(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  return atomicCAS(p, 0u, v) == 0u;
#else
  if (*p) return false;
  *p = v;
  return true;
#endif
}

// Index the first n entries (a seeded start's), all threads at once (one
// thread's loop of inserts made K1 spill); an entry no target can match
// (length outside 1..32) stays out.  A chain's order is then the
// threads', which no lookup's answer depends on.
template <class P>
X3_HD void hash_seed(const P& par, const HashIx& x, const uint8_t* strs,
                     const int32_t* lens, int n) {
  for (int e = par.tid(); e < n; e += par.nthr()) {
    const int len = lens[e];
    if (len <= 0 || len > MML) continue;
    const uint32_t h = key_hash(WordsRow{strs + (int64_t)e * MML}, len);
    const uint32_t v = (h & ~x.tmask) | (uint32_t)(e + 1);
    for (uint32_t i = h & x.hmask; !hash_claim(x.slot + i, v);
         i = (i + 1) & x.hmask) {
    }
  }
}

// Warp-collective: probe_part's mask and best over the whole dictionary,
// from the index (lane L-1 looks up the key of length L).
template <class P>
X3_HD void hash_probe(const P& par, const HashIx& x, const uint8_t* strs,
                      const int32_t* lens, const uint32_t* T, uint64_t& mask,
                      uint64_t& best, int& visits) {
  for (int len = par.lane() + 1; len <= MML; len += P::WS) {
    const int t1 = hash_find(x, strs, lens, WordsOf{T}, len, visits);
    if (t1) {
      mask |= 1u << (len - 1);
      const uint64_t key = ((uint64_t)len << 32) | (uint32_t)(t1 - 1);
      if (key > best) best = key;
    }
  }
}

// Warp-collective: the length of the longest entry that prefixes the
// text at pos, from the index, on this warp alone (every lane gets it).
template <class P>
X3_HD int hash_probe_len(const P& par, const HashIx& x, const uint8_t* strs,
                         const int32_t* lens, const uint8_t* txt, int pos,
                         int& visits) {
  int best = 0;
  for (int len = par.lane() + 1; len <= MML; len += P::WS)
    if (hash_find(x, strs, lens, WordsAt{txt, pos}, len, visits)) best = len;
  return par.wmax(best);
}

// ---------------------------------------------------------------------------
// K1's index model as a Fenwick (binary indexed) tree over its rank
// positions, beside the plain freqs of ix: a hit's low, the freqs below
// its rank, is the sum of at most log2(D) + 1 nodes, read in one round
// (one a lane), in place of a sum over every live entry.  The model only
// ever gains 1 at one position an event (an E_IDX1 hit's rank, or a new
// entry at dn), so the tree is exact.  It is a plane of ix_tree_words(D)
// u32 words after the hash index's slots (K1 only), zeroed with the rest,
// and one of the shared-memory plan's (PL_IX_TREE); node j (1..D; word 0
// unused) holds the freqs of positions [j - lowbit(j), j).
// ---------------------------------------------------------------------------

// Set the nodes over the model's first n freqs (a seeded start's; the
// tree is zero past them), all threads at once, a node each.
template <class P>
X3_HD void ix_tree_seed(const P& par, uint32_t* tree, int D,
                        const int32_t* ix, int n) {
  for (int j = par.tid() + 1; j <= D; j += par.nthr()) {
    const int lo = j - (j & -j);
    uint32_t s = 0;
    for (int k = lo; k < imin(j, n); ++k) s += (uint32_t)ix[k];
    if (lo < n) tree[j] = s;
  }
}

// Warp-collective: the freq at position pos (< D) gains 1.  Lane b adds to
// the node of lowbit 2^b that covers pos, where there is one.  nodes
// counts the nodes written.
template <class P>
X3_HD void ix_tree_add(const P& par, uint32_t* tree, int D, int pos,
                       int& nodes) {
  for (int b = par.lane(); b < 32; b += P::WS) {
    const uint32_t j = (((uint32_t)pos >> b) + 1u) << b;
    if (((j >> b) & 1u) && j <= (uint32_t)D) {
      tree[j] += 1u;
      ++nodes;
    }
  }
}

// Warp-collective: the sum of the freqs at positions [0, r) (r <= D), every
// lane gets it.  Lane b reads the node of r's bit b (r with its lower bits
// cleared), where that bit is set.  nodes counts the nodes read.
template <class P>
X3_HD uint32_t ix_tree_prefix(const P& par, const uint32_t* tree, int r,
                              int& nodes) {
  uint32_t s = 0;
  for (int b = par.lane(); b < 32; b += P::WS)
    if ((r >> b) & 1) {
      s += tree[(r >> b) << b];
      ++nodes;
    }
  return (uint32_t)par.wsum((int)s);
}

// This thread's share of the window scan (thread tid of nthr; none when
// tid < 0): the run length r of each position s in [p+1, p+W-32), the
// bytes from s that repeat those at p (backend.c:66-74).  A thread takes
// one aligned text word, four positions, at a time and looks further only
// at the positions whose first byte is the target's (a byte compare of
// the word).  Runs of 1 to 3 bytes count in c (c[k]: positions with
// r > k); a longer one adds one to h[r-1], the warp's histogram.
template <class P>
X3_HD void scan_part(const P& par, int tid, int nthr, const uint8_t* txt,
                     int p, int W, const uint32_t* T, int* h, int* c) {
  if (tid < 0) return;
  const int off = (int)((uintptr_t)txt & 3);
  const uint8_t* wb = txt - off;  // 4-byte aligned; position s is wb[s+off]
  const int lo = p + 1 + off, hi = p + W - MML + off;
  const uint32_t b4 = 0x01010101u * (T[0] & 0xFFu);  // the first byte
  for (int q = (lo >> 2) + tid; 4 * q < hi; q += nthr) {
    uint32_t m = eq_bytes(load_word(wb + 4 * q), b4) &
                 byte_span(iclamp(lo - 4 * q, 0, 4), iclamp(hi - 4 * q, 0, 4));
    while (m) {
      const int i = 4 * q + (ctz32(m) >> 3);
      m &= ~(0xFFu << (8 * (i - 4 * q)));
      const uint32_t x = text_word(wb, i) ^ T[0];
      int r = x ? ctz32(x) >> 3 : MML;  // >= 1: the first byte matches
#pragma unroll
      for (int j = 1; !x && j < MML / 4; ++j) {
        const uint32_t y = text_word(wb, i + 4 * j) ^ T[j];
        if (y) {
          r = 4 * j + (ctz32(y) >> 3);
          break;
        }
      }
      c[0] += 1;
      c[1] += r > 1;
      c[2] += r > 2;
      if (r > 3) par.hist_add(h, r - 1);
    }
  }
}

// Warp-collective: row[i] += row[i+1] + ... + row[31] (a suffix sum).
template <class P>
X3_HD void warp_suffix32(const P& par, int* row) {
  constexpr int K = MML / P::WS;  // entries a lane
  int v[K];
  for (int k = 0; k < K; ++k) v[k] = row[par.lane() * K + k];
  for (int k = K - 2; k >= 0; --k) v[k] += v[k + 1];
  const int above = par.wsuffix_excl(v[0]);
  for (int k = 0; k < K; ++k) row[par.lane() * K + k] = v[k] + above;
}

// Warp-collective: the window scan of this warp's positions (scan_part's
// tid, nthr); h[i] (a row of 32) = those whose next i+1 bytes repeat the
// target T at p.  The CTA's counts are the sums over the warps' rows.
template <class P>
X3_HD void window_counts(const P& par, int tid, int nthr, const uint8_t* txt,
                         int p, int W, const uint32_t* T, int* h) {
  for (int i = par.lane(); i < MML; i += P::WS) h[i] = 0;
  par.syncwarp();
  int c[3] = {0, 0, 0};
  scan_part(par, tid, nthr, txt, p, W, T, h, c);
  par.syncwarp();
  warp_suffix32(par, h);  // right from 3 on, where only long runs count
  for (int k = 0; k < 3; ++k) c[k] = par.wsum(c[k]);
  for (int k = par.lane(); k < 3; k += P::WS) h[k] = c[k];
}

// Warp-collective: pre[i] = in[0] + ... + in[i-1] over 32 entries; returns
// the sum of all 32.
template <class P>
X3_HD int group_scan32(const P& par, const int* in, int* pre) {
  constexpr int K = MML / P::WS;
  int v[K], s = 0;
  for (int k = 0; k < K; ++k) {
    v[k] = s;
    s += in[par.lane() * K + k];
  }
  const int base = par.wscan_excl(s);
  for (int k = 0; k < K; ++k) pre[par.lane() * K + k] = v[k] + base;
  return par.wsum(s);
}

// The chosen new-fragment length >= 1 (find_best_match, backend.c:56-100;
// x3tpu/ops/match.py best_match_sweep, all three branches), from the
// warps' scan counts in sh.wcnt.  Every warp computes it (lane i holds
// candidate length i+1), and a veto's probe (hash_probe_len) is each
// warp's own, so the sweep takes no barrier.  `probes` counts the offsets
// probed for vetoes, `visits` the index's slots their lookups read.
template <class P>
X3_HD int sweep(const P& par, const Params& prm, const Shared& sh,
                const HashIx& hx, const uint8_t* strs, const int32_t* lens,
                const uint8_t* txt, int p, int& probes, int& visits) {
  if (prm.T < 1) return 1;
  constexpr int K = MML / P::WS;
  int key[K];  // level * 32 + i of candidate i = lane * K + k
  uint32_t cand = 0;
  for (int k = 0; k < K; ++k) {
    const int i = par.lane() * K + k;
    int c = 0;
#pragma unroll 8
    for (int w = 0; w < par.nwarps(); ++w) c += sh.wcnt[w][i];
    key[k] = imin(c - 1, prm.T) * MML + i;
    if (c >= 2) cand |= 1u << i;
  }
  cand = par.wor(cand);
  // the best key among the candidates in m, -1 if none
  auto best_key = [&](uint32_t m) {
    int b = -1;
    for (int k = 0; k < K; ++k)
      if ((m >> (par.lane() * K + k)) & 1u) b = imax(b, key[k]);
    return par.wmax(b);
  };
  auto length = [](int bk) { return bk < 0 ? 1 : (bk & (MML - 1)) + 1; };
  if (prm.f1 == 0 && prm.f2 == 0) return length(best_key(cand));
  if (prm.f2 > 0) {
    // vl[o] does not depend on the candidate, and a vetoed candidate is
    // vetoed at every threshold: argmax over the survivors
    uint32_t veto = 0;
    int pm = -(1 << 20);
    for (int i = 1; i < MML; ++i) {
      const int vl = hash_probe_len(par, hx, strs, lens, txt, p + i, visits);
      ++probes;
      pm = imax(pm, vl - i);
      const bool v1 = prm.f1 > 0 && i >= 2 && vl > 0 && vl * prm.f1 > i + 1;
      const bool v2 = pm * prm.f2 > i + 1;
      if (v1 || v2) veto |= 1u << i;
    }
    return length(best_key(cand & ~veto));
  }
  // f1 only: the best remaining candidate, probed at its offset and
  // dropped while vetoed; one below 2 is never probed (vetoes are rare, so
  // one round a probed candidate beats probing all of them at once)
  uint32_t rem = cand;
  for (;;) {
    const int bk = best_key(rem);
    if (bk < 0) return 1;  // out of candidates (backend.c:99)
    const int bi = bk & (MML - 1);
    if (bi < 2) return bi + 1;
    const int dl = hash_probe_len(par, hx, strs, lens, txt, p + bi, visits);
    ++probes;
    if (!(dl > 0 && dl * prm.f1 > bi + 1)) return bi + 1;
    rem &= ~(1u << bi);
  }
}

// ---------------------------------------------------------------------------
// Context rows.
// ---------------------------------------------------------------------------

X3_HD View view(const FamP& F, int hub_n, int cid) {
  View v;
  v.hub = cid == 0;
  v.row = iclamp(cid - 1, 0, F.S - 1);
  const int pr = F.promo[v.row];
  v.big = !v.hub && pr > 0;
  v.brow = iclamp(pr - 1, 0, F.M - 1);
  v.n = v.hub ? hub_n : (v.big ? F.big_n[v.brow] : F.n[v.row]);
  return v;
}

// Row of the selected tier: offset of item 0, capacity, items in use.
struct Row { int64_t at; int cap, n; };

X3_HD Row row_of(const FamP& F, const View& v, int hub_n) {
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

X3_HD int32_t* tags_of(const FamP& F, const View& v) {
  return v.hub ? F.hub_tags : (v.big ? F.big_tags : F.tags);
}
X3_HD int32_t* freqs_of(const FamP& F, const View& v) {
  return v.hub ? F.hub_freqs : (v.big ? F.big_freqs : F.freqs);
}
X3_HD int32_t* pairs_of(const FamP& F, const View& v) {
  return v.hub ? F.hub_pair : (v.big ? F.big_pair : F.pair);
}

// The tag's first position in the row (0xFFFFFFFF: absent), as Found.
X3_HD Found make_found(const FamP& F, const View& v, const Row& r,
                       uint32_t first) {
  Found f;
  f.found = first != 0xFFFFFFFFu;
  f.pos = f.found ? (int)first : 0;
  f.pair_id = F.with_pair ? pairs_of(F, v)[r.at + f.pos] : 0;
  return f;
}

// Locate tag in the context (ctx_query_tag_index, context.c:31-40) on one
// warp; every lane gets the result.
template <class P>
X3_HD Found find_warp(const P& par, const FamP& F, const View& v, int hub_n,
                      int tag) {
  const Row r = row_of(F, v, hub_n);
  const int32_t* tags = tags_of(F, v) + r.at;
  uint32_t first = 0xFFFFFFFFu;
  for (int i = par.lane(); i < r.n; i += P::WS)
    if (tags[i] == tag) {
      first = i;
      break;
    }
  return make_found(F, v, r, par.wminu(first));
}

// find_warp and the found item's stats (low_f, span, total) in the
// context's throwaway model (context.c:95-133) on one warp: the tags and
// the freqs are read in one pass, the low sum in a second (from the cache).
template <class P>
X3_HD void find_stats_warp(const P& par, const FamP& F, const View& v,
                           int hub_n, int tag, Found& f, Stats& s) {
  const Row r = row_of(F, v, hub_n);
  const int32_t* tags = tags_of(F, v) + r.at;
  const int32_t* fr = freqs_of(F, v) + r.at;
  uint32_t first = 0xFFFFFFFFu, total = 0;
  for (int i = par.lane(); i < r.n; i += P::WS) {
    total += (uint32_t)fr[i];
    if (tags[i] == tag && first == 0xFFFFFFFFu) first = i;
  }
  f = make_found(F, v, r, par.wminu(first));
  uint32_t low = 0;
  for (int i = par.lane(); i < f.pos; i += P::WS) low += (uint32_t)fr[i];
  s.low = par.wsum((int)low);
  s.total = par.wsum((int)total);
  s.span = fr[imin(f.pos, r.cap - 1)];
}

// Warp-collective, for a hit: the tag in a context row (find_stats_warp)
// and its mode's probability P(mode) * P(item | mode), 0 when absent
// (x3.c:150-172, in f32 as the reference); lane 0 stores them.
template <class P>
X3_HD void ctx_mode(const P& par, const FamP& F, const View& v, int hub_n,
                    int tag, float p_mode, Found& fo, Stats& so, float& po) {
  Found f;
  Stats st;
  find_stats_warp(par, F, v, hub_n, tag, f, st);
  if (par.lane() == 0) {
    fo = f;
    so = st;
    po = f.found ? fmul(p_mode, prob(st.span, imax(st.total, 1))) : 0.0f;
  }
}

// Warp-collective: ask for a context row's tags and freqs in the L1 cache
// ahead of the pass that searches it (rows in shared memory need not).
template <class P>
X3_HD void prefetch_row(const P& par, const FamP& F, const View& v,
                        int hub_n) {
#ifdef __CUDA_ARCH__
  const Row r = row_of(F, v, hub_n);
  const int32_t* t = tags_of(F, v) + r.at;
  const int32_t* f = freqs_of(F, v) + r.at;
  if (r.n <= 0 || !__isGlobal(t)) return;
  // one address in each 128-byte line the row's items span
  for (int l = par.lane(); 32 * l < r.n + 31; l += P::WS) {
    const int i = imin(32 * l, r.n - 1);
    asm volatile("prefetch.global.L1 [%0];" ::"l"(t + i));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(f + i));
  }
#else
  (void)par, (void)F, (void)v, (void)hub_n;
#endif
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

// span: the found item's freq when the caller read it (its stats' span),
// else -1.  Counts in use come from the view, so nothing here is read
// back from a table but that freq when span is -1.  hub_n, promo_n and
// flags are the family's counts and the lane's flags, wherever their
// owner keeps them.  Returns whether the row holds the tag afterwards
// (found, or appended: a write that fits).
X3_HD bool ctx_update(const FamP& F, int& hub_n, int& promo_n, int& flags,
                      int ofbit, const View& v, int tag, const Found& f,
                      int new_pair_id, int span) {
  const bool app = !f.found, inc = f.found;
  auto bump = [span](int32_t* freq) { *freq = (span >= 0 ? span : *freq) + 1; };

  const bool hub_room = hub_n < F.H;
  if (v.hub && inc) bump(F.hub_freqs + imin(f.pos, F.H - 1));
  if (v.hub && app && hub_room) {
    F.hub_tags[hub_n] = tag;
    F.hub_freqs[hub_n] = 1;
    if (F.with_pair) F.hub_pair[hub_n] = new_pair_id;
    hub_n += 1;
  }

  const bool need_promo = !v.hub && !v.big && app && v.n >= F.CS;
  const bool do_promo = need_promo && promo_n < F.M;
  const int new_brow = promo_n;
  if (do_promo) {
    // copy the CS small items into the first CS slots of the (zero) big row
    const int64_t src = (int64_t)v.row * F.CS, dst = (int64_t)new_brow * F.CB;
    for (int i = 0; i < F.CS; ++i) {
      F.big_tags[dst + i] = F.tags[src + i];
      F.big_freqs[dst + i] = F.freqs[src + i];
      if (F.with_pair) F.big_pair[dst + i] = F.pair[src + i];
    }
    F.big_n[new_brow] = v.n;
    F.promo[v.row] = new_brow + 1;
    promo_n += 1;
  }
  const bool big_now = v.big || do_promo;
  const int brow_now = do_promo ? new_brow : v.brow;

  const bool sdo = !v.hub && !big_now;
  const int64_t srow = (int64_t)v.row * F.CS;
  if (sdo && inc) bump(F.freqs + srow + imin(f.pos, F.CS - 1));
  if (sdo && app) {
    // v.n < CS unless a promotion failed (then the last slot is reused,
    // exactly as x3tpu's clamped scatter does)
    const int64_t i = srow + imin(v.n, F.CS - 1);
    F.tags[i] = tag;
    F.freqs[i] = 1;
    if (F.with_pair) F.pair[i] = new_pair_id;
    F.n[v.row] = v.n + 1;
  }

  const bool bdo = !v.hub && big_now;
  const bool big_room = v.n < F.CB;
  const int64_t brow = (int64_t)brow_now * F.CB;
  if (bdo && inc) bump(F.big_freqs + brow + imin(f.pos, F.CB - 1));
  if (bdo && app && big_room) {
    const int64_t i = brow + imin(v.n, F.CB - 1);
    F.big_tags[i] = tag;
    F.big_freqs[i] = 1;
    if (F.with_pair) F.big_pair[i] = new_pair_id;
    F.big_n[brow_now] = v.n + 1;  // v.n: the row's count, promoted or not
  }

  if ((v.hub && app && !hub_room) || (need_promo && !do_promo) ||
      (bdo && app && !big_room))
    flags |= ofbit;
  return inc || (v.hub ? hub_room : (!big_now || big_room));
}

// Recency ranks after this event's dictionary op (dict.c:132-146): MTF
// bumps the entries more recent than the hit one and moves it to rank 0; an
// insert bumps all older entries (the new one, at op_n, has rank 0).  Only
// changed entries are stored: after an MTF that is the few more recent
// than the hit one.
template <class P>
X3_HD void update_ranks(const P& par, const Shared& sh, int32_t* rank_of) {
  if (sh.op == OP_NONE) return;
  const bool mtf = sh.op == OP_MTF;
  for (int e = par.tid(); e < sh.op_n; e += par.nthr()) {
    const int old = rank_of[e];
    int rk = old;
    if (!mtf) rk += 1;
    else if (e == sh.op_tag) rk = 0;
    else if (rk < sh.op_r) rk += 1;
    if (rk != old) rank_of[e] = rk;
  }
}

// ---------------------------------------------------------------------------
// One lane, start to finish.
// ---------------------------------------------------------------------------

struct LaneIO {
  const uint8_t* text;  // the lane's padded text row [tb]
  int64_t tb;
  int tlen;
  int seeds;            // K: the dictionary seeds the scratch holds
  WarmN warm;           // the warm start's counts (all 0: none; read by
                        // encode_lane<true> only)
  int32_t* scr;         // the lane's scratch (Layout::words), zeroed but
                        // for the seeds and the warm tables
  uint8_t* smem;        // the planes the layout puts in shared memory
  uint32_t* words;      // the lane's zeroed output row (out_words)
  int32_t* byte_len;
  int32_t* counts;      // [5]
  float* sizes;         // [5]
  int32_t* flags;
  long long* phases;    // [PH_SLOTS] with X3_PHASES, else unused
};

// Per-phase cycle counters of K1, compiled in only with -DX3_PHASES
// (tools/k1_phases.py builds such a library; the main path's never has
// them).  The leader thread reads clock64() at each phase boundary.  Pass
// 1 is one barrier: the leader's warp works on the ctx rows while the
// other warps probe and scan, so PH_PROBE is the index's warp's share
// (thread 32's: the insert and the lookups), PH_SCAN the first scanning
// thread's (thread 64's), PH_RANKS the leader's share of the rank update,
// and PH_PASS1 the rest of pass 1 on the leader: its ctx rows
// (PH_SUB_CTXROWS), then the wait for the others.  In pass 2, PH_IX is the
// index model's warp's own share (its first thread's).  Slots: the phases,
// then the lane's cycles and event counts.
enum {
  PH_PASS1, PH_PROBE, PH_SCAN, PH_SWEEP, PH_HIT, PH_LEADER, PH_RANKS,
  PH_TOTAL = 7, PH_EVENTS, PH_HITS, PH_VETO_PROBES, PH_LIT_BYTES,
  // parts of the phases above: the leader's own ctx-row job in pass 1, and
  // the leader chain's mode choice, coding and table updates
  PH_SUB_CTXROWS, PH_SUB_MODE, PH_SUB_CODE, PH_SUB_UPDATE,
  // the hash index's warp: its lookups (one a key: 32 a probe, the event's
  // and each veto's) and the slots they read (their ratio: the mean chain)
  PH_HASH_LOOKUPS, PH_HASH_VISITS,
  // the index model's tree: its warp's pass-2 cycles, the hits that
  // queried it, and its nodes read (pass 2) and written (the adds, on the
  // hash index's warp in pass 1)
  PH_IX, PH_IX_QUERIES, PH_IX_NODES, PH_SLOTS
};
#if defined(X3_PHASES) && defined(__CUDA_ARCH__)
#define X3_PHASE_BY(k, owner)                         \
  do {                                                \
    if (par.tid() == (owner)) {                       \
      const long long t_ = clock64();                 \
      ph[k] += t_ - ph_t;                             \
      ph_t = ph_s = t_;                               \
    }                                                 \
  } while (0)
#define X3_PHASE(k) X3_PHASE_BY(k, 0)
#define X3_CLOCK(owner) \
  do { if (par.tid() == (owner)) ph_t = clock64(); } while (0)
#define X3_COUNT(k, n) \
  do { if (par.leader()) ph[k] += (n); } while (0)
// warp-collective: the sum of n over the warp, counted by its lane 0
#define X3_COUNT_WARP(k, n)                           \
  do {                                                \
    const int n_ = par.wsum(n);                       \
    if (par.lane() == 0) ph[k] += n_;                 \
  } while (0)
// a part of the current phase: the cycles since the last X3_PHASE or
// X3_SUB, counted in slot k as well
#define X3_SUB(k)                                     \
  do {                                                \
    if (par.leader()) {                               \
      const long long t_ = clock64();                 \
      ph[k] += t_ - ph_s;                             \
      ph_s = t_;                                      \
    }                                                 \
  } while (0)
#else
#define X3_SUB(k) do {} while (0)
#define X3_PHASE_BY(k, owner) do {} while (0)
#define X3_CLOCK(owner) do {} while (0)
#define X3_PHASE(k) do {} while (0)
#define X3_COUNT(k, n) do {} while (0)
#define X3_COUNT_WARP(k, n) do {} while (0)
#endif

// Copy the text row into shared memory and zero the other planes there;
// with seeds, the dictionary planes there are copied from the scratch,
// and with a warm start (kWarm: it needs seeds) every plane, the warm
// tables included.
template <bool kWarm, class P>
X3_HD void init_smem(const P& par, const Layout& L, const LaneIO& io) {
  (void)par;  // the host copies with memcpy
  if (!L.smem_bytes) return;
  int64_t zero_from = 0;
  if (L.sm[PL_TEXT] >= 0) {
    uint8_t* dst = io.smem + L.sm[PL_TEXT];
#ifdef __CUDA_ARCH__
    int64_t done = 0;
    if (((uintptr_t)io.text & 15) == 0) {
      done = io.tb / 16 * 16;
      for (int64_t i = par.tid(); i < io.tb / 16; i += par.nthr())
        ((uint4*)dst)[i] = ((const uint4*)io.text)[i];
    }
    for (int64_t i = done + par.tid(); i < io.tb; i += par.nthr())
      dst[i] = io.text[i];
#else
    memcpy(dst, io.text, io.tb);
#endif
    zero_from = L.sm[PL_TEXT] + ((io.tb + 15) & ~(int64_t)15);
  }
  if (io.seeds > 0) {
    // a seeded start, once a launch: plane by plane, four bytes a thread
    // (a lane's scratch is only 4-byte aligned)
    for (int k = PL_TEXT + 1; k < PL_COUNT; ++k) {
      if (L.sm[k] < 0) continue;
      const int64_t off = kWarm ? plane_offset(L, k)
                          : k == PL_STRS ? L.strs : k == PL_LENS ? L.lens
                          : k == PL_RANK_OF ? L.rank_of
                          : k == PL_IX ? L.ix : -1;
      int32_t* dst = (int32_t*)(io.smem + L.sm[k]);
      const int64_t n = plane_bytes(L, io.tb, k) / 4;
      for (int64_t i = par.tid(); i < n; i += par.nthr())
        dst[i] = off >= 0 ? io.scr[off + i] : 0;
    }
    return;
  }
#ifdef __CUDA_ARCH__
  for (int64_t i = zero_from / 16 + par.tid(); i < L.smem_bytes / 16;
       i += par.nthr())
    ((uint4*)io.smem)[i] = make_uint4(0u, 0u, 0u, 0u);
#else
  memset(io.smem + zero_from, 0, L.smem_bytes - zero_from);
#endif
}

// One lane, start to finish.  kWarm: the lane starts from a warm start's
// tables and io.warm's counts; an unwarmed launch runs the instantiation
// without them, the code K1 ran before warm start (as decode_lane's, read
// from arguments they measured slower there, x3_dec_core.cuh).  The
// dictionary's hash index is the plane after the scratch's Layout::words,
// and the index model's tree the plane after the hash index, where the
// plan does not put it in shared memory.
template <bool kWarm = false, class P>
X3_HD void encode_lane(const P& par, const Params& prm, const Caps& cp,
                       const Layout& L, const LaneIO& io, Lane& R, Shared& sh) {
  const Planes pl = resolve(L, io.scr, io.smem, io.text);
  const uint8_t* txt = pl.text;
  const int cap = cp.out_words;
  // warps with jobs of their own (all warp 0 on the host): pass 1 the ctx
  // rows, the index's insert and lookups with the index model tree's add,
  // and the models' prefixes, pass 2 the ctx0 row, the ctx1 row and the
  // index model
  const int nw = par.nwarps();
  const int w_ctx0 = 0, w_ctx1 = 1 % nw, w_lit = 2 % nw, w_ix = 2 % nw;
  const int w_hash = 1 % nw;
  // the window scan: every warp but the ctx0 row's and the index's
  const int s0 = P::WS * imin(nw - 1, 2);
  const int stid = par.tid() - s0, snthr = par.nthr() - s0;
  const HashIx hx = hash_index(io.scr + L.words, hash_slots(L.D), L.D);
  uint32_t* const ixt = (uint32_t*)plane_at(
      L, PL_IX_TREE, io.scr, io.smem, plane_offset(L, PL_IX_TREE));
  int visits = 0;  // slots read by this thread's lookups (X3_PHASES)
  int nodes = 0;   // the index model's tree nodes it read or wrote (idem)
#if defined(X3_PHASES) && defined(__CUDA_ARCH__)
  long long ph[PH_SLOTS] = {0};
  const long long ph_start = clock64();
  long long ph_t = ph_start, ph_s = ph_start;
  const int p0 = P::WS * w_hash;  // PH_PROBE's thread
  const int x0 = P::WS * w_ix;    // PH_IX's thread
#endif

  // the AC coder: on the device the coder warp, fed through the queue
#ifdef __CUDA_ARCH__
  int seen_head = 0;
  auto code = [&](uint32_t low_f, uint32_t high_f, uint32_t total) {
    queue_push(sh.q, seen_head, low_f, high_f, total);
  };
#else
  Coder C = {0u, TOP, 0, 0, 0u, 0};
  auto code = [&](uint32_t low_f, uint32_t high_f, uint32_t total) {
    ac_encode(C, io.words, cap, low_f, high_f, total);
  };
#endif
  int pend = -1;  // the leader's: the last hit's tag, its contexts pending
  int idx1_seen = 0;  // the hash index's warp's: E_IDX1 events it has seen
  init_smem<kWarm>(par, L, io);
  if (par.leader()) {
    R.flags = 0;
    R.p = R.prev_c1 = R.c1 = R.pair_n = 0;
    R.dn = io.seeds;  // a seeded dictionary starts with its K entries
    R.tlen = io.tlen;
    R.hub_n[0] = R.hub_n[1] = R.promo_n[0] = R.promo_n[1] = 0;
    if (kWarm) {
      // the warm pairs and hub items are in the scratch already
      R.pair_n = io.warm.pair_n;
      R.hub_n[0] = io.warm.hub_n[0];
      R.hub_n[1] = io.warm.hub_n[1];
    }
    for (int e = 0; e < E_LAST; ++e) {
      R.ev[e] = event_init_freq(e);
      R.counts[e] = 0;
      R.sizes[e] = 0.0f;
    }
    for (int i = 0; i < MML; ++i) R.ms[i] = 1;
    sh.op = OP_NONE;
  }
  for (int i = par.tid(); i < 256; i += par.nthr()) R.ch[i] = 1;
  par.sync();
  if (io.seeds > 0) {
    // a seeded start's entries, indexed before the first event, and
    // their freqs in the index model's tree
    hash_seed(par, hx, pl.strs, pl.lens, io.seeds);
    ix_tree_seed(par, ixt, L.D, pl.ix, io.seeds);
    par.sync();
  }

  // every event consumes at least one byte, so tlen events always suffice
  for (int steps = 0; R.p < R.tlen; ++steps) {
    if (steps >= io.tlen) {
      if (par.leader()) R.flags |= OF_STEPS;
      break;
    }
    const int p = R.p;

    // (1) pass 1: the previous event's recency ranks (dict.c:132-146), the
    // dictionary probe at p (x3.c:381), the forward-window scan (x3.c:383)
    // and the single warps' jobs; one barrier
    update_ranks(par, sh, pl.rank_of);
    X3_PHASE(PH_RANKS);
    X3_CLOCK(s0);
    X3_CLOCK(p0);
    if (par.warp() == w_ctx0) {
      if (par.leader()) {
        int id = -1;  // this event's ctx0 id, where the update tells it
        if (pend >= 0) {
          // the previous hit's contexts and pair registration
          // (x3.c:195-222), put off from its chain to here, beside the
          // CTA's probe and scan
          ctx_update(pl.f0, R.hub_n[0], R.promo_n[0], R.flags, OF_CTX0,
                     sh.v0, pend, sh.f0, 0, sh.s0.span);
          const bool held =
              ctx_update(pl.f1, R.hub_n[1], R.promo_n[1], R.flags, OF_CTX1,
                         sh.v1, pend, sh.f1, R.pair_n, sh.s1.span);
          // the pair (old c1, pend) is what the search below would find
          // in ctx1's row of the old c1: the item it found, or the one it
          // added with the next pair id, if the row kept it
          id = held ? (sh.f1.found ? sh.f1.pair_id : R.pair_n) : 0;
          if (!sh.f1.found) {
            // flag one id early, as x3tpu: a clamped row index can never
            // alias a live context before the sticky flag is set
            if (R.pair_n >= L.f0.S) R.flags |= OF_PAIRS;
            R.pair_n += 1;
          }
          R.prev_c1 = R.c1;
          R.c1 = pend;
          pend = -1;
        }
        sh.ctx0_id = id;
      }
      par.syncwarp();
      // a hit's ctx0 row is the pair id of (prev_c1, c1) in ctx1's row of
      // prev_c1 (x3.c:139-147); its ctx1 row is c1's
      int id = sh.ctx0_id;
      if (id < 0) {
        const View vp = view(pl.f1, R.hub_n[1], R.prev_c1);
        const Found fp = find_warp(par, pl.f1, vp, R.hub_n[1], R.c1);
        id = fp.found ? fp.pair_id : 0;
      }
      const View v0 = view(pl.f0, R.hub_n[0], id);
      const View v1 = view(pl.f1, R.hub_n[1], R.c1);
      prefetch_row(par, pl.f0, v0, R.hub_n[0]);
      prefetch_row(par, pl.f1, v1, R.hub_n[1]);
      if (par.lane() == 0) {
        sh.v0 = v0;
        sh.v1 = v1;
      }
      X3_SUB(PH_SUB_CTXROWS);
    }
    uint32_t T[MML / 4];
    target_words(txt, p, T);
    uint64_t mask = 0, best = 0;
    visits = 0;
    if (par.warp() == w_hash) {
      // the last event's new entry (its key in sh.t32, sh.flen) before
      // this event's lookups, which must see it
      if (sh.op == OP_INSERT && par.lane() == 0)
        hash_insert(hx, key_hash(WordsRow{sh.t32}, sh.flen), sh.op_n);
      par.syncwarp();
      hash_probe(par, hx, pl.strs, pl.lens, T, mask, best, visits);
      // the last event's gain in the index model, in its tree before this
      // event's pass 2 reads it: a new entry's freq at op_n, or an E_IDX1
      // hit's at its rank (the leader counted one more E_IDX1 event)
      const int idx1 = R.counts[E_IDX1];
      const int gain = sh.op == OP_INSERT ? sh.op_n
                       : idx1 != idx1_seen ? imin(sh.op_r, L.D - 1) : -1;
      idx1_seen = idx1;
      if (gain >= 0) ix_tree_add(par, ixt, L.D, gain, nodes);
    }
    X3_PHASE_BY(PH_PROBE, p0);
    window_counts(par, stid, snthr, txt, p, prm.W, T, sh.wcnt[par.warp()]);
    X3_PHASE_BY(PH_SCAN, s0);
    if (par.warp() == w_lit) {
      // the length model's prefix; for literal byte k, the earlier bytes
      // of the fragment below and equal to it (x3.c:263-267)
      const int tot = group_scan32(par, R.ms, sh.mspre);
      if (par.lane() == 0) sh.mstot = tot;
      for (int k = par.lane(); k < MML; k += P::WS) {
        const uint32_t b4 = 0x01010101u * txt[p + k];
        int lo = 0, eq = 0;
#pragma unroll
        for (int w = 0; w < MML / 4; ++w) {
          const int nb = iclamp(k - 4 * w, 0, 4);  // bytes of T[w] before k
          const uint32_t m = nb == 4 ? 0xFFFFFFFFu : (1u << (8 * nb)) - 1u;
          lo += bytes_below(T[w], b4, m);
          eq += bytes_equal(T[w], b4, m);
        }
        sh.litlow[k] = (uint8_t)lo;
        sh.litspan[k] = (uint8_t)eq;
      }
    }
    for (int g = par.warp(); g < 8; g += nw) {  // the char model's prefix
      const int tot = group_scan32(par, R.ch + 32 * g, sh.chpre + 32 * g);
      if (par.lane() == 0) sh.chw[g] = tot;
    }
    par.reduce2(mask, OpOr(), best, OpMax());
    const Probe pr = make_probe(mask, best);
    X3_PHASE(PH_PASS1);

    // (2) threshold sweep (x3.c:383) and selection (x3.c:381-383)
    int probes = 0;
    const int fbm =
        sweep(par, prm, sh, hx, pl.strs, pl.lens, txt, p, probes, visits);
    int nl = pr.len;
    if (prm.nl) {
      const int lut[4] = {1, 4, 6, 8};
      nl = pr.len <= 4 ? lut[iclamp(pr.len - 1, 0, 3)] : 9999;
    }
    const bool hit = pr.len > 0 && nl >= fbm && p + pr.len <= R.tlen;
    const int mlen = iclamp(imin(fbm, R.tlen - p), 1, MML);
    const int tag = pr.slot;
    X3_PHASE(PH_SWEEP);
    X3_COUNT(PH_VETO_PROBES, probes);
    if (par.warp() == w_hash) {
      X3_COUNT_WARP(PH_HASH_VISITS, visits);
      X3_COUNT_WARP(PH_HASH_LOOKUPS, 1 + probes);
    }

    // (3) pass 2, a hit's contexts and index model (x3.c:139-160), each on
    // a warp of its own, with its mode's probability (x3.c:150-172); one
    // barrier
    if (hit) {
      X3_CLOCK(x0);
      const int ev_tot = small_stats(R.ev, E_LAST, 0).total;
      if (par.warp() == w_ctx0)
        ctx_mode(par, pl.f0, sh.v0, R.hub_n[0], tag,
                 prob(R.ev[E_CTX0], ev_tot), sh.f0, sh.s0, sh.p0);
      if (par.warp() == w_ctx1)
        ctx_mode(par, pl.f1, sh.v1, R.hub_n[1], tag,
                 prob(R.ev[E_CTX1], ev_tot), sh.f1, sh.s1, sh.p1);
      if (par.warp() == w_ix) {
        // the freqs below the rank from the tree; the total is a freq of 1
        // a live entry (seed_dict, or inserted) and 1 an E_IDX1 event
        const int rank = pl.rank_of[tag];
        Stats st;
        st.low = (int)ix_tree_prefix(par, ixt, rank, nodes);
        st.total = R.dn + R.counts[E_IDX1];
        st.span = pl.ix[imin(rank, L.D - 1)];
        if (par.lane() == 0) {
          sh.sx = st;
          sh.rank = rank;
          sh.px = fmul(prob(R.ev[E_IDX1], ev_tot),
                       prob(st.span, imax(st.total, 1)));
        }
        X3_PHASE_BY(PH_IX, x0);
        X3_COUNT_WARP(PH_IX_QUERIES, par.lane() == 0 ? 1 : 0);
      }
      par.sync();
    }
    X3_PHASE(PH_HIT);
    X3_COUNT(PH_EVENTS, 1);
    X3_COUNT(PH_HITS, hit ? 1 : 0);
    X3_COUNT(PH_LIT_BYTES, hit ? 0 : mlen);

    // (4) the serial chain
    if (par.leader()) {
      // strict-greater chain IDX1 -> CTX0 -> CTX1 over the f32 products
      int esym = E_NEW;
      float best_p = 0.0f;
      if (hit) {
        esym = E_IDX1;
        best_p = sh.px;
        if (sh.p0 > best_p) { esym = E_CTX0; best_p = sh.p0; }
        if (sh.p1 > best_p) { esym = E_CTX1; best_p = sh.p1; }
      }
      X3_SUB(PH_SUB_MODE);

      // event symbol
      const Stats es = small_stats(R.ev, E_LAST, esym);
      code(es.low, es.low + es.span, es.total);
      R.ev[esym] += 1;
      R.counts[esym] += 1;

      // payload: ctx0 item | ctx1 item | recency rank | length-1
      const Stats ms = {sh.mspre[mlen - 1], R.ms[mlen - 1], sh.mstot};
      const Stats pay = esym == E_CTX0 ? sh.s0 : esym == E_CTX1 ? sh.s1
                        : esym == E_IDX1 ? sh.sx : ms;
      code(pay.low, pay.low + pay.span, pay.total);

      if (hit) {
        if (esym == E_IDX1) pl.ix[imin(sh.rank, L.D - 1)] += 1;
        R.sizes[esym] = fadd(R.sizes[esym], bits(best_p));
      } else {
        R.ms[mlen - 1] += 1;
        // literal bytes (x3.c:263-267): byte k's interval is the base
        // interval plus the earlier equal/smaller bytes of the fragment
        int acc = 0;
        for (int g = 0; g < 8; ++g) {  // group sums -> group bases
          const int t = sh.chw[g];
          sh.chw[g] = acc;
          acc += t;
        }
        float lit = 0.0f;
        for (int k = 0; k < mlen; ++k) {
          const int sym = txt[p + k];
          const int low = sh.chw[sym >> 5] + sh.chpre[sym] + sh.litlow[k];
          const int span = R.ch[sym] + sh.litspan[k];
          const int tot = acc + k;
          code(low, low + span, tot);
          lit = fadd(lit, bits(prob(span, tot)));
        }
        for (int k = 0; k < mlen; ++k) R.ch[txt[p + k]] += 1;
        const float evb = bits(prob(es.span, es.total));
        const float msb = bits(prob(ms.span, ms.total));
        R.sizes[E_NEW] = fadd(R.sizes[E_NEW], fadd(fadd(evb, msb), lit));
      }
      X3_SUB(PH_SUB_CODE);

      // dictionary: MTF on hit; insert on miss unless an exact duplicate
      sh.op = OP_NONE;
      sh.op_n = R.dn;
      if (hit) {
        sh.op = OP_MTF;
        sh.op_r = sh.rank;
        sh.op_tag = tag;
      } else if (!((pr.okmask >> (mlen - 1)) & 1u)) {
        if (R.dn < L.D) {
          pl.ix[R.dn] = 1;
          uint32_t* s = (uint32_t*)(pl.strs + (int64_t)R.dn * MML);
          for (int k = 0; k < MML / 4; ++k) s[k] = T[k];
          pl.lens[R.dn] = mlen;
          // the key, for the index's warp in the next pass 1
          for (int k = 0; k < MML / 4; ++k) store_word(sh.t32 + 4 * k, T[k]);
          sh.flen = mlen;
          sh.op = OP_INSERT;
          R.dn += 1;
        } else {
          R.flags |= OF_DICT;
        }
      }

      // a hit's contexts wait for the next pass 1 (pend); a literal ends
      // the context chain
      if (hit) {
        pend = tag;
        R.p = p + pr.len;
      } else {
        R.prev_c1 = 0;
        R.c1 = 0;
        R.p = p + mlen;
      }
      X3_SUB(PH_SUB_UPDATE);
    }
    par.sync();
    X3_PHASE(PH_LEADER);
  }

  if (par.warp() == w_hash || par.warp() == w_ix)
    X3_COUNT_WARP(PH_IX_NODES, nodes);

  // EOF and flush (x3.c:432-433)
  if (par.leader()) {
    if (pend >= 0) {  // the last hit's context updates, for their flags
      ctx_update(pl.f0, R.hub_n[0], R.promo_n[0], R.flags, OF_CTX0, sh.v0,
                 pend, sh.f0, 0, sh.s0.span);
      ctx_update(pl.f1, R.hub_n[1], R.promo_n[1], R.flags, OF_CTX1, sh.v1,
                 pend, sh.f1, R.pair_n, sh.s1.span);
      if (!sh.f1.found && R.pair_n >= L.f0.S) R.flags |= OF_PAIRS;
    }
    const Stats es = small_stats(R.ev, E_LAST, E_EOF);
    code(es.low, es.low + es.span, es.total);
    for (int e = 0; e < E_LAST; ++e) {
      io.counts[e] = R.counts[e];
      io.sizes[e] = R.sizes[e];
    }
#ifdef __CUDA_ARCH__
    // the coder flushes and writes the length and flags
    volatile CodeQueue& vq = sh.q;
    vq.flags = R.flags;
    __threadfence_block();
    vq.done = 1;
#else
    ac_flush(C, io.words, cap);
    *io.byte_len = ((C.nbits + 31) >> 5) << 2;
    *io.flags = R.flags | C.of_out;
#endif
#if defined(X3_PHASES) && defined(__CUDA_ARCH__)
    ph[PH_TOTAL] = clock64() - ph_start;
    for (int k = 0; k < PH_SLOTS; ++k)
      if (s0 == 0 || (k != PH_PROBE && k != PH_SCAN && k != PH_HASH_LOOKUPS &&
                      k != PH_HASH_VISITS && k != PH_IX &&
                      k != PH_IX_QUERIES && k != PH_IX_NODES))
        io.phases[k] = ph[k];
#endif
  }
#if defined(X3_PHASES) && defined(__CUDA_ARCH__)
  if (s0 && par.tid() == p0) {
    io.phases[PH_PROBE] = ph[PH_PROBE];
    io.phases[PH_HASH_LOOKUPS] = ph[PH_HASH_LOOKUPS];
    io.phases[PH_HASH_VISITS] = ph[PH_HASH_VISITS];
  }
  if (s0 && par.tid() == s0) io.phases[PH_SCAN] = ph[PH_SCAN];
  if (s0 && par.tid() == x0) {
    io.phases[PH_IX] = ph[PH_IX];
    io.phases[PH_IX_QUERIES] = ph[PH_IX_QUERIES];
  }
  // the nodes the adds wrote and those the queries read, from two warps
  // (the host zeroes the slot)
  if (s0 && (par.tid() == p0 || par.tid() == x0))
    atomicAdd((unsigned long long*)(io.phases + PH_IX_NODES),
              (unsigned long long)ph[PH_IX_NODES]);
#endif
}

}  // namespace x3
