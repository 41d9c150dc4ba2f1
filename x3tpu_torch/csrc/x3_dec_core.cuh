// The x3 decoder event loop for one lane (one stream), written once for
// the CUDA kernel K2 (x3_decoder.cu, one CTA per lane) and for a host build
// of the same source (x3_core_host.cpp, tests only).  The dictionary
// probe, the context rows and their update are the encoder's
// (x3_core.cuh).
//
// Semantics are those of x3tpu's XLA engine (x3tpu/codec.py _dec_body and
// the ops/ and models/ modules it calls), with its capacity model; the
// plain PyTorch twin is x3tpu_torch/codec.py (decode_blocks_chunked).
//
// Work split: one warp per job (x3_decoder.cu says why).
// - Warp 0, the leader's warp, runs the serial chain with its state in
//   registers, the same on every lane: the bit source, the AC decoder, the
//   event, length and char models (the length model one entry a lane, the
//   char model eight), the payload search over the mode's row or the index
//   model, the literals' size estimates and the output position.  It
//   posts each event as a job into a ring in shared memory and goes on to
//   the next event symbol.
// - Warp 1 owns context family 1 (ctx1 rows, pair ids, the pair count):
//   for each hit it finds the tag in the row (the decoded position where
//   the event came from that row), tells the next event's ctx0 id,
//   prepares the next event's ctx1 row (its view, total and chunk bases
//   for the search) and updates the row (the update first where the next
//   row is the one updated).  After a literal it searches the ctx0 id in
//   the hub.
// - Warp 2 owns context family 0 (ctx0 rows): the same find, the next
//   event's ctx0 row from warp 1's id, and the update.
// - Warp 3 owns the dictionary's recency planes and the index model: the
//   rank update (rank_of and tag_of, O(rank) a hit) and the index model's
//   inclusive cumulative sum, then the hit's output bytes and size
//   estimate.
// - A literal (E_NEW) is the whole CTA's, the spare warps' too: the
//   duplicate probe, the insert and its rank shift, the output bytes,
//   between two barriers.
// Hand-offs are counters in shared memory, each written by one warp (a
// release store; the reader spins on acquire loads): a job waits for its
// ring slot, a ctx-row search for its family's preparation of that event,
// an index-model search for the dictionary warp's previous job, and warp
// 2's row for warp 1's id.  The host build (one thread) runs the jobs of
// each event in an order those hand-offs allow: the leader, family 1,
// family 0, the dictionary.
//
// Every index taken from the stream is clamped or bounded before it
// addresses memory; a lane whose symbol value lies at or past its model's
// total stops after that event with OF_CORRUPT (x3host.cpp Model::find
// throws there; the event completes as x3tpu's clamped search has it),
// and one still decoding after block_bytes + 1 events with OF_STEPS: a
// corrupt stream ends in a flag, never in a fault or a hang.
// Every lane's end (EOF, OF_OUT, the event bound) is a job of its own that
// every warp takes and leaves on.
#pragma once

#include "x3_core.cuh"

namespace x3 {

constexpr uint32_t SENTINEL = 0x80000000u;  // read-past-end word (bio.c:38)

struct DecIO {
  const uint32_t* words;  // the lane's stream words [iw]
  int nbytes, iw;
  int seeds;              // K: the dictionary seeds the scratch holds
  WarmN warm;             // the warm start's counts (all 0: none; read
                          // by decode_lane<true> only)
  int32_t* scr;           // the lane's scratch (Layout::words), zeroed but
                          // for the seeds (ix as their cumulative sum) and
                          // the warm tables (freqs raw, as the rows keep
                          // them)
  uint8_t* out;           // the lane's zeroed output row [block_bytes]
  int block_bytes;
  int32_t* out_len;
  int32_t* counts;        // [5]
  float* sizes;           // [5]
  int32_t* flags;
  long long* phases;      // [PHD_SLOTS] with X3_DEC_PHASES, else unused
};

// Per-phase cycle counters of K2, compiled in only with -DX3_DEC_PHASES
// (tools/k2_phases.py builds such a library; the main path's never has
// them).  Each warp's first thread reads clock64() at its own phase
// boundaries and adds its slots to phases at the end: the leader's chain
// (its waits for the other warps included), the lane's cycles and events,
// then the other warps' jobs, which run beside the chain.  A wait for a
// job is not counted.
enum {
  PHD_EVSYM, PHD_CTX0ID, PHD_ROWS, PHD_SEARCH, PHD_FINDS, PHD_UPDATES,
  PHD_EMIT, PHD_RANKS, PHD_LITERAL, PHD_PROBE, PHD_TOTAL, PHD_EVENTS,
  PHD_N_CTX0, PHD_N_CTX1, PHD_N_IDX1, PHD_N_NEW,
  // the chain's waits for the other warps
  PHD_WAIT_ROWS, PHD_WAIT_DICT,
  // the other warps' jobs, beside the chain
  PHD_F0_JOB, PHD_F0_WAIT_ID, PHD_F0_PREP, PHD_F1_JOB, PHD_F1_PREP,
  PHD_D_RANKS, PHD_D_IX, PHD_D_EMIT, PHD_F1_HUB_ID, PHD_SLOTS
};

struct PhClock {
#if defined(X3_DEC_PHASES) && defined(__CUDA_ARCH__)
  long long ph[PHD_SLOTS];
  long long t;
  __device__ PhClock() : t(clock64()) {
    for (int k = 0; k < PHD_SLOTS; ++k) ph[k] = 0;
  }
  __device__ void reset() { t = clock64(); }
  __device__ void mark(int k) {
    const long long n = clock64();
    ph[k] += n - t;
    t = n;
  }
  __device__ void count(int k, long long n) { ph[k] += n; }
  __device__ void flush(long long* out) const {
    if ((threadIdx.x & 31) != 0) return;
    for (int k = 0; k < PHD_SLOTS; ++k)
      if (ph[k])
        atomicAdd((unsigned long long*)out + k, (unsigned long long)ph[k]);
  }
#else
  X3_HD void reset() {}
  X3_HD void mark(int) {}
  X3_HD void count(int, long long) {}
  X3_HD void flush(long long*) const {}
#endif
};

// ---------------------------------------------------------------------------
// A warp's 32 lanes: one a thread on the device, all of them in the one
// thread of the host build (VL lanes a thread), so the warp-wide searches
// take the same steps in the build the CPU tests run.  Warp-collective on
// the device: every lane of the warp calls them together.
// ---------------------------------------------------------------------------

#ifdef __CUDA_ARCH__
constexpr int VL = 1;
__device__ __forceinline__ int vlane(int) { return threadIdx.x & 31; }
__device__ __forceinline__ uint32_t vballot(const bool* p) {
  return __ballot_sync(0xffffffffu, p[0]);
}
// ex = the sum of v over the lanes below; returns the sum over all 32
__device__ __forceinline__ uint32_t vscan_excl(const uint32_t* v,
                                               uint32_t* ex) {
  const int l = threadIdx.x & 31;
  uint32_t x = v[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (l >= o) x += y;
  }
  ex[0] = x - v[0];
  return __shfl_sync(0xffffffffu, x, 31);
}
__device__ __forceinline__ uint32_t vsum(const uint32_t* v) {
  return __reduce_add_sync(0xffffffffu, v[0]);
}
__device__ __forceinline__ uint32_t vat(const uint32_t* v, int l) {
  return __shfl_sync(0xffffffffu, v[0], l);
}
__device__ __forceinline__ int bcast0(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}
__device__ __forceinline__ void wsync() { __syncwarp(); }
#else
constexpr int VL = 32;
inline int vlane(int i) { return i; }
inline uint32_t vballot(const bool* p) {
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l) m |= (uint32_t)p[l] << l;
  return m;
}
inline uint32_t vscan_excl(const uint32_t* v, uint32_t* ex) {
  uint32_t s = 0;
  for (int l = 0; l < 32; ++l) {
    ex[l] = s;
    s += v[l];
  }
  return s;
}
inline uint32_t vsum(const uint32_t* v) {
  uint32_t s = 0;
  for (int l = 0; l < 32; ++l) s += v[l];
  return s;
}
inline uint32_t vat(const uint32_t* v, int l) { return v[l]; }
inline int bcast0(int x) { return x; }
inline void wsync() {}
#endif

// The hand-off counters in shared memory: one warp stores with release
// semantics, others load with acquire semantics until the count reaches
// theirs (what the storing warp wrote before is then visible to them).
// The host build runs the jobs in order and never waits.
X3_HD void publish(int* flag, int v) {
#ifdef __CUDA_ARCH__
  __syncwarp();  // the warp's writes, ordered before lane 0's release
  if ((threadIdx.x & 31) == 0)
    asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(flag)), "r"(v)
                 : "memory");
#else
  *flag = v;
#endif
}

X3_HD void wait_ge(const int* flag, int v, bool nap = false) {
#ifdef __CUDA_ARCH__
  const unsigned a = (unsigned)__cvta_generic_to_shared(flag);
  for (;;) {
    int got;
    asm volatile("ld.acquire.cta.shared.s32 %0, [%1];" : "=r"(got) : "r"(a)
                 : "memory");
    if (got >= v) break;
    if (nap) __nanosleep(100);
  }
  __syncwarp();
#else
  (void)flag, (void)v, (void)nap;
#endif
}

// ---------------------------------------------------------------------------
// Bit source and arithmetic decoder (the leader's warp; x3tpu/ops/bitio.py,
// x3tpu/ops/ac.py).  The state lives in registers.
// ---------------------------------------------------------------------------

struct DecState {
  uint32_t low, high;      // AC interval
  uint32_t buf;            // AC decode buffer
  uint32_t acc;            // bit source: current word
  uint32_t nxt;            // bit source: word widx, loaded ahead of its use
  int used, widx, nwords;  // bits used of acc, next word, readable words
  const uint32_t* words;   // the stream [iw]
  int iw;
};

// Stream word widx.  A readable word past the buffer (byte count over 4 *
// iw) reads the last one, as x3tpu's clamped gather does.
X3_HD uint32_t fetch_word(const uint32_t* words, int iw, int widx,
                          int nwords) {
  return widx < nwords ? words[imin(widx, iw - 1)] : SENTINEL;
}

// Up to 31 bits, first stream bit in the LSB; at most one word reload,
// whose successor is loaded at once: the chain waits for a stream word
// only when a reload follows the last one closely.
X3_HD uint32_t get_bits(DecState& R, int count) {
  if (count <= 0) return 0u;
  const int take1 = imin(count, 32 - R.used);
  uint32_t r = R.acc & ((1u << take1) - 1u);
  const int rem = count - take1;
  if (rem > 0) {
    const uint32_t w = R.nxt;
    r |= (w & ((1u << rem) - 1u)) << take1;
    R.acc = w >> rem;
    R.used = rem;
    R.widx += 1;
    R.nxt = fetch_word(R.words, R.iw, R.widx, R.nwords);
  } else {
    R.acc >>= take1;
    R.used += take1;
  }
  return r;
}

// (step, value) of the pending symbol (ac.c:128-131, 183-185): exact u32
// divisions, each divisor at least 1 (a corrupt stream can reach step 0).
X3_HD void dec_value(const DecState& R, uint32_t total, uint32_t& step,
                     uint32_t& value) {
  step = (R.high - R.low + 1u) / (total < 1u ? 1u : total);
  value = (R.buf - R.low) / (step < 1u ? 1u : step);
}

// Narrow to [low_f, high_f) and renormalize in closed form, consuming n+m
// stream bits in one read (ac.c:142-165, 192-195).  A corrupt stream can
// leave a wrapped interval whose bounds differ in bit 31: there n is 0.
X3_HD void dec_update(DecState& R, uint32_t step,
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
  const uint32_t raw = get_bits(R, k);
  // stream bits arrive LSB-first; the decoder shifts them in MSB-first
  const uint32_t grp = k > 0 ? bitrev32(raw) >> (32 - k) : 0u;
  const uint32_t buf1 = (R.buf << n) - (v << 31) + (grp >> m);
  R.buf = (buf1 << m) - sub + (grp & ((1u << m) - 1u));
  R.low = (low1 << m) - sub;
  R.high = (high1 << m) - sub + (1u << m) - 1u;
}

// ---------------------------------------------------------------------------
// Symbol searches.  A model's or a row's symbol of value: with the
// exclusive prefix c of the freqs, sym = (counted items with c <= value) -
// 1, at least 0; low its prefix, span its freq (0 past the items).  In a
// context row every live item counts; in a model the nonzero ones, which
// here are always a prefix (the length and char models start at 1, the
// index model's live entries are its first ixn), so sym is the last item
// with c <= value.
// ---------------------------------------------------------------------------

struct Sym { int sym, low, span; };

// The event model's symbol (model_decode_sym), serially; every index a
// constant once m is, so the model stays in registers.
X3_HD Sym small_decode(const int* f, int m, uint32_t value) {
  int cnt = 0;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < m; ++i) {
    if (f[i] > 0 && c <= value) ++cnt;
    c += (uint32_t)f[i];
  }
  Sym s = {imax(cnt - 1, 0), 0, 0};
#pragma unroll
  for (int i = 0; i < m; ++i) {
    if (i < s.sym) s.low += f[i];
    if (i == s.sym) s.span = f[i];
  }
  return s;
}

// A row's total and its chunks' exclusive bases for wsearch: K items a
// chunk, chunk l from item l*K (exc[l] set where l*K < n).  Rows of up to
// 32 items take one item a chunk, so the search needs no second scan;
// longer rows take chunks of whole 32-item rounds, each read by the warp
// at once (K = 32 up to 1024 items).  Warp-collective.
X3_HD uint32_t chunk_bases(const int32_t* f, int n, int& K, uint32_t* exc) {
  uint32_t s[VL], ex[VL];
  if (n <= 32) {
    K = 1;
    for (int i = 0; i < VL; ++i)
      s[i] = vlane(i) < n ? (uint32_t)f[vlane(i)] : 0u;
  } else {
    K = 32 * ((n + 1023) / 1024);
    for (int i = 0; i < VL; ++i) s[i] = 0;
#pragma unroll 4
    for (int r = 0; 32 * r < n; ++r) {
      uint32_t v[VL];
      for (int i = 0; i < VL; ++i) {
        const int j = 32 * r + vlane(i);
        v[i] = j < n ? (uint32_t)f[j] : 0u;
      }
      const uint32_t rs = vsum(v);
      for (int i = 0; i < VL; ++i)
        if (vlane(i) == 32 * r / K) s[i] += rs;
    }
  }
  const uint32_t tot = vscan_excl(s, ex);
  for (int i = 0; i < VL; ++i)
    if (vlane(i) * K < n) exc[vlane(i)] = ex[i];
  return tot;
}

// The symbol of value among the n items of f (ctx_decode_pos) and its
// tag, from the chunk bases of chunk_bases: a ballot picks the last chunk
// whose base is <= value; with one item a chunk that is the item (each
// lane has loaded its own item's freq and tag beside its base), else a
// scan of the chunk's items, 32 at a time, finds it.  An empty row gives
// item 0, span 0, and the tag in its first slot.  Warp-collective.
X3_HD Sym wsearch(const int32_t* f, const int32_t* tags, int n, int K,
                  const uint32_t* exc, uint32_t value, int& tag) {
  Sym s = {0, 0, 0};
  bool p[VL];
  uint32_t fv[VL], tv[VL];
  for (int i = 0; i < VL; ++i) {
    const int l = vlane(i);
    p[i] = l * K < n && exc[l] <= value;
    const int j = K == 1 ? imin(l, imax(n - 1, 0)) : 0;
    fv[i] = K == 1 && l < n ? (uint32_t)f[j] : 0u;
    tv[i] = (uint32_t)tags[j];
  }
  const uint32_t m = vballot(p);
  if (!m) {  // no items
    tag = (int)vat(tv, 0);
    return s;
  }
  const int c = 31 - clz32(m);
  if (K == 1) {
    s.sym = c;
    s.low = (int)exc[c];
    s.span = (int)vat(fv, c);
    tag = (int)vat(tv, c);
    return s;
  }
  uint32_t base = exc[c];
  const int end = imin(c * K + K, n);
  for (int j0 = c * K; j0 < end; j0 += 32) {
    uint32_t v[VL], ex[VL];
    for (int i = 0; i < VL; ++i) {
      const int j = j0 + vlane(i);
      v[i] = j < end ? (uint32_t)f[j] : 0u;
      tv[i] = j < end ? (uint32_t)tags[j] : 0u;
    }
    const uint32_t tot = vscan_excl(v, ex);
    for (int i = 0; i < VL; ++i)
      p[i] = j0 + vlane(i) < end && base + ex[i] <= value;
    const int k = popc32(vballot(p));
    if (k > 0) {
      s.sym = j0 + k - 1;
      s.low = (int)(base + vat(ex, k - 1));
      s.span = (int)vat(v, k - 1);
      tag = (int)vat(tv, k - 1);
    }
    if (k < imin(32, end - j0)) break;
    base += tot;
  }
  return s;
}

// The index model's symbol of value and its tag (tag_of[sym], sym below
// D), from the model's inclusive cumulative sum cum over its ixn live
// entries (the TPU kernel's form: the total is cum[ixn-1], a hit adds one
// from its entry on).  sym = the entries j < ixn-1 with cum[j] <= value,
// counted by a 32-ary descent: each round a ballot over 32 strides narrows
// the count to one stride; in the last each lane has also loaded its
// candidate's sums and tag.  Warp-collective.
X3_HD Sym ix_search(const int32_t* cum, const int32_t* tag_of, int D,
                    int ixn, uint32_t value, int& tag) {
  const int n1 = ixn - 1;
  int stride = 1;  // 32 strides cover the count's range [0, n1]
  while (stride * 32 <= n1) stride *= 32;
  int base = 0;
  bool p[VL];
  for (; stride > 1; stride /= 32) {
    for (int i = 0; i < VL; ++i) {
      const int j = base + stride * (vlane(i) + 1) - 1;
      p[i] = j < n1 && (uint32_t)cum[j] <= value;
    }
    base += stride * popc32(vballot(p));
  }
  uint32_t c[VL], cl[VL], t[VL];
  for (int i = 0; i < VL; ++i) {
    const int j = base + vlane(i);
    c[i] = j < ixn ? (uint32_t)cum[j] : 0u;
    cl[i] = j > 0 && j <= ixn ? (uint32_t)cum[j - 1] : 0u;
    t[i] = (uint32_t)tag_of[imin(j, D - 1)];
    p[i] = j < n1 && c[i] <= value;
  }
  const int k = popc32(vballot(p));  // < 32: the count is below base + 32
  Sym s;
  s.sym = base + k;
  s.low = (int)vat(cl, k);
  s.span = ixn > 0 ? (int)(vat(c, k) - (uint32_t)s.low) : 0;
  tag = (int)vat(t, k);
  return s;
}

// The symbol of value among the 32 entries of a model held one a lane.
X3_HD Sym lane_search(const int* f, uint32_t value) {
  uint32_t v[VL], ex[VL];
  bool p[VL];
  for (int i = 0; i < VL; ++i) v[i] = (uint32_t)f[i];
  vscan_excl(v, ex);
  for (int i = 0; i < VL; ++i) p[i] = ex[i] <= value;
  const int k = imax(popc32(vballot(p)), 1);
  return {k - 1, (int)vat(ex, k - 1), (int)vat(v, k - 1)};
}

// The symbol of value among the 256 entries of the char model, held 8 a
// lane (ch[i][q]: entry 8 * vlane(i) + q): each lane finds its own
// entry, a ballot over the lanes' bases picks the lane.
X3_HD Sym char_search(const int (*ch)[8], uint32_t value) {
  uint32_t s[VL], ex[VL], sym[VL], low[VL], span[VL];
  bool p[VL];
  for (int i = 0; i < VL; ++i) {
    uint32_t t = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += (uint32_t)ch[i][q];
    s[i] = t;
  }
  vscan_excl(s, ex);
  for (int i = 0; i < VL; ++i) {
    p[i] = ex[i] <= value;
    uint32_t c = ex[i];
    int last = 0;
    low[i] = c;
    span[i] = (uint32_t)ch[i][0];
#pragma unroll
    for (int q = 1; q < 8; ++q) {
      c += (uint32_t)ch[i][q - 1];
      if (c <= value) {
        last = q;
        low[i] = c;
        span[i] = (uint32_t)ch[i][q];
      }
    }
    sym[i] = 8 * vlane(i) + last;
  }
  const int c = imax(31 - clz32(vballot(p)), 0);
  return {(int)vat(sym, c), (int)vat(low, c), (int)vat(span, c)};
}

// ---------------------------------------------------------------------------
// The jobs and the CTA's shared state.
// ---------------------------------------------------------------------------

enum { JOB_HIT = 0, JOB_NEW = 1, JOB_END = 2 };
// the warps' roles (the host build's one thread takes them all)
enum { W_LEAD = 0, W_F1 = 1, W_F0 = 2, W_DICT = 3, W_JOBS = 4 };
constexpr int JQ = 16;  // ring slots: jobs the leader may run ahead

// One event for the other warps.  HIT: the tag, the mode (its event
// symbol), the decoded position in that mode's row or model and its
// freq, and the event symbol's and the payload's (span, total) for the
// size estimate; NEW: pos is the fragment's length (its bytes are in
// DecShared::t32).  dn and ixn as the event found them; elen the bytes to
// emit at opos, -1 when they do not fit (OF_OUT).
struct DecJob {
  int kind, tag, mode, pos, span, dn, ixn, opos, elen;
  int ev_span, ev_tot, pay_tot;
};

// A context row prepared for the next event's search: its item tags and
// freqs, live items, total and chunk bases (chunk_bases).
struct RowPrep {
  const int32_t *tags, *freqs;
  int n, K;
  uint32_t total;
  uint32_t exc[32];
};

struct DecShared {
  alignas(16) uint8_t t32[MML];  // a literal's bytes, zero-padded
  DecJob job[JQ];
  int posted;                    // jobs posted (the leader's)
  int prog[NW_MAX];              // per warp: ready for event prog - 1
  int idk;                       // warp 1: ids told for events < idk
  int idv[JQ];                   // warp 1: event k's ctx0 id at k % JQ
  int wflags[NW_MAX];            // each warp's flags at the end
  float wsizes[E_IDX1 + 1];      // the hits' size estimates (warp 3)
  RowPrep prep[2];               // family f's row for its next event
  unsigned long long red[2][2 * NW_MAX];  // block reductions (ParDev)
};

// A context family's warp: its counts, flags and the row it prepared
// (its context cid and view).
struct FamState {
  View v;
  int cid, hub_n, promo_n, flags, pair_n;
};

// The leader warp's state: the same on every lane but the length model
// (one entry a lane) and the char model (eight a lane).
struct Leader {
  DecState S;
  int ev[E_LAST], counts[E_LAST];
  float sizes[E_LAST];  // E_NEW's and E_EOF's (the hits' are warp 3's)
  int ms[VL];
  int ch[VL][8];
  uint32_t mtot, ctot;  // the length and char models' totals
  int opos, dn, ixn, ixtot, flags, done;
  int room;  // every warp has taken the jobs below room - 1
};

// Whether contexts a and b of family F share a row.
X3_HD bool same_row(const FamP& F, int a, int b) {
  return (a == 0) == (b == 0) &&
         iclamp(a - 1, 0, F.S - 1) == iclamp(b - 1, 0, F.S - 1);
}

// Prepare family F's row of context cid for the next event.
X3_HD void prep_row(const FamP& F, FamState& fs, int cid, RowPrep& rp) {
  fs.cid = cid;
  fs.v = view(F, fs.hub_n, cid);
  const Row r = row_of(F, fs.v, fs.hub_n);
  int K;
  const uint32_t tot = chunk_bases(freqs_of(F, fs.v) + r.at, r.n, K, rp.exc);
  rp.tags = tags_of(F, fs.v) + r.at;
  rp.freqs = freqs_of(F, fs.v) + r.at;
  rp.n = r.n;
  rp.K = K;
  rp.total = tot;
}

// The tag's first position in the row (find), 32 items a ballot, four
// ballots a round.  Warp-collective.
X3_HD Found find_rounds(const FamP& F, const View& v, int hub_n, int tag) {
  const Row r = row_of(F, v, hub_n);
  const int32_t* tags = tags_of(F, v) + r.at;
  uint32_t first = 0xFFFFFFFFu;
  for (int j0 = 0; j0 < r.n && first == 0xFFFFFFFFu; j0 += 128) {
    uint32_t m[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bool p[VL];
      for (int i = 0; i < VL; ++i) {
        const int j = j0 + 32 * u + vlane(i);
        p[i] = j < r.n && tags[j] == tag;
      }
      m[u] = vballot(p);
    }
#pragma unroll
    for (int u = 3; u >= 0; --u)
      if (m[u]) first = j0 + 32 * u + ctz32(m[u]);
  }
  return make_found(F, v, r, first);
}

// The tag's item in family F's row, and its freq where known (else -1):
// the decoded position where the event came from this row (a row holds
// each tag once), else a find.
X3_HD Found find_tag(const FamP& F, const FamState& fs, const DecJob& jb,
                     bool own, int& span) {
  const Row r = row_of(F, fs.v, fs.hub_n);
  span = -1;
  if (own && jb.pos < r.n) {
    span = jb.span;
    return make_found(F, fs.v, r, (uint32_t)jb.pos);
  }
  return find_rounds(F, fs.v, fs.hub_n, jb.tag);
}

// Whether ctx_update would leave the tag in the row (its return value),
// without the update: found, or appended where the write fits.
X3_HD bool ctx_holds(const FamP& F, int hub_n, int promo_n, const View& v,
                     const Found& f) {
  if (f.found) return true;
  if (v.hub) return hub_n < F.H;
  const bool do_promo = !v.big && v.n >= F.CS && promo_n < F.M;
  return !(v.big || do_promo) || v.n < F.CB;
}

// Family 1's warp: a job's update, the next ctx0 id and ctx1 row.  k: the
// next event.  The id goes first (warp 2 waits for it), then the next
// row, then the update, unless the next row is the one updated.  After a
// literal (and at the start) the context chain is empty: the next ctx0
// id is tag 0's pair in the hub (x3.c:139-147).
template <class P>
X3_HD void f1_job(const P& par, const Layout& L, const Planes& pl,
                  DecShared& sh, FamState& fs, const DecJob* jb, int k,
                  PhClock& pc) {
  const bool hit = jb && jb->kind == JOB_HIT;
  const int cid = hit ? jb->tag : 0;
  const View cur = fs.v;
  int id, span = -1;
  Found f;
  if (hit) {
    f = find_tag(pl.f1, fs, *jb, jb->mode == E_CTX1, span);
    // the pair (old c1, tag) is what a search would find in ctx1's row of
    // the old c1: the item found, or the one appended with the next pair
    // id, if the row keeps it
    id = ctx_holds(pl.f1, fs.hub_n, fs.promo_n, cur, f)
             ? (f.found ? f.pair_id : fs.pair_n) : 0;
  } else {
    const View hub = view(pl.f1, fs.hub_n, 0);
    const Found h = find_rounds(pl.f1, hub, fs.hub_n, 0);
    id = h.found ? h.pair_id : 0;
  }
  if (par.lane() == 0) sh.idv[k % JQ] = id;
  publish(&sh.idk, k + 1);
  pc.mark(hit ? PHD_F1_JOB : PHD_F1_HUB_ID);
  const bool later = hit && same_row(pl.f1, fs.cid, cid);
  if (!later) {
    prep_row(pl.f1, fs, cid, sh.prep[1]);
    publish(&sh.prog[W_F1], k + 1);
    pc.mark(PHD_F1_PREP);
  }
  if (hit) {
    if (par.lane() == 0) {
      ctx_update(pl.f1, fs.hub_n, fs.promo_n, fs.flags, OF_CTX1, cur,
                 jb->tag, f, fs.pair_n, span);
      if (!f.found) {
        // flag one id early, as x3tpu: a clamped row index can never
        // alias a live context before the sticky flag is set
        if (fs.pair_n >= L.f0.S) fs.flags |= OF_PAIRS;
        fs.pair_n += 1;
      }
    }
    fs.hub_n = bcast0(fs.hub_n);
    fs.promo_n = bcast0(fs.promo_n);
    fs.flags = bcast0(fs.flags);
    fs.pair_n = bcast0(fs.pair_n);
    wsync();
    pc.mark(PHD_F1_JOB);
  }
  if (later) {
    prep_row(pl.f1, fs, cid, sh.prep[1]);
    publish(&sh.prog[W_F1], k + 1);
    pc.mark(PHD_F1_PREP);
  }
}

// Family 0's warp: a job's update and the next event's ctx0 row, from
// warp 1's id; the row first unless it is the one updated.
template <class P>
X3_HD void f0_job(const P& par, const Planes& pl, DecShared& sh,
                  FamState& fs, const DecJob* jb, int k, PhClock& pc) {
  const bool hit = jb && jb->kind == JOB_HIT;
  const View cur = fs.v;
  int span = -1;
  Found f;
  if (hit) {
    f = find_tag(pl.f0, fs, *jb, jb->mode == E_CTX0, span);
    pc.mark(PHD_F0_JOB);
  }
  wait_ge(&sh.idk, k + 1);
  const int id = sh.idv[k % JQ];
  pc.mark(PHD_F0_WAIT_ID);
  const bool later = hit && same_row(pl.f0, fs.cid, id);
  if (!later) {
    prep_row(pl.f0, fs, id, sh.prep[0]);
    publish(&sh.prog[W_F0], k + 1);
    pc.mark(PHD_F0_PREP);
  }
  if (hit) {
    if (par.lane() == 0)
      ctx_update(pl.f0, fs.hub_n, fs.promo_n, fs.flags, OF_CTX0, cur,
                 jb->tag, f, 0, span);
    fs.hub_n = bcast0(fs.hub_n);
    fs.promo_n = bcast0(fs.promo_n);
    fs.flags = bcast0(fs.flags);
    wsync();
    pc.mark(PHD_F0_JOB);
  }
  if (later) {
    prep_row(pl.f0, fs, id, sh.prep[0]);
    publish(&sh.prog[W_F0], k + 1);
    pc.mark(PHD_F0_PREP);
  }
}

// The dictionary warp's share of a hit: the index model, the recency
// ranks (dict.c:132-146; an MTF to rank r moves ranks 0..r-1 up one, read
// before written, 32 at a time from the top) and the hit's bytes.
template <class P>
X3_HD void dict_job(const P& par, const Layout& L, const Planes& pl,
                    const DecJob& jb, PhClock& pc) {
  if (jb.mode == E_IDX1) {
    const int s = imin(jb.pos, L.D - 1);
    const int hi = imax(jb.ixn, s + 1);
#pragma unroll 8
    for (int j = s + par.lane(); j < hi; j += P::WS) pl.ix[j] += 1;
    pc.mark(PHD_D_IX);
  }
  const int tag = jb.tag;
  if (tag < jb.dn) {  // else the tag is not live: nothing moves
    const int r = pl.rank_of[tag];
    for (int hi = r; hi > 0; hi -= 32) {
      const int lo = imax(hi - 32, 0);
      int e[VL];
      for (int i = 0; i < VL; ++i) {
        const int q = lo + vlane(i);
        e[i] = q < hi ? pl.tag_of[q] : 0;
      }
      wsync();
      for (int i = 0; i < VL; ++i) {
        const int q = lo + vlane(i);
        if (q < hi) {
          pl.tag_of[q + 1] = e[i];
          pl.rank_of[e[i]] = q + 1;
        }
      }
      wsync();
    }
    if (par.lane() == 0) {
      pl.tag_of[0] = tag;
      pl.rank_of[tag] = 0;
    }
  }
  pc.mark(PHD_D_RANKS);
}

// The dictionary warp, after it has told its job done: the hit's bytes,
// and its size estimate (x3.c:150-172) in the order of the hits.
template <class P>
X3_HD void dict_emit(const P& par, const Layout& L, const Planes& pl,
                     const DecIO& io, const DecJob& jb, float* sizes,
                     PhClock& pc) {
  if (jb.elen > 0) {
    const uint8_t* src = pl.strs + (int64_t)iclamp(jb.tag, 0, L.D - 1) * MML;
    for (int b = par.lane(); b < jb.elen; b += P::WS)
      io.out[jb.opos + b] = src[b];
  }
  const float b = fadd(bits(prob(jb.ev_span, jb.ev_tot)),
                       bits(prob(jb.span, jb.pay_tot)));
#pragma unroll
  for (int q = 0; q <= E_IDX1; ++q)
    if (q == jb.mode) sizes[q] = fadd(sizes[q], b);
  pc.mark(PHD_D_EMIT);
}

// A literal, the whole CTA's (x3.c:309-317): the duplicate probe, the
// insert unless an exact duplicate (with its rank shift and the index
// model's new entry), and the fragment's bytes.  Returns whether the
// fragment is a duplicate.
template <class P>
X3_HD bool new_event(const P& par, const Layout& L, const Planes& pl,
                     const DecIO& io, DecShared& sh, const DecJob& jb) {
  par.sync();  // the job and t32 are written; earlier jobs are done
  const Probe pr = probe(par, pl.strs, pl.lens, jb.dn, sh.t32);
  const int len = jb.pos, dn = jb.dn;
  const bool dup = (pr.okmask >> (len - 1)) & 1u;
  if (!dup && dn < L.D) {
    for (int e = par.tid(); e < dn; e += par.nthr()) {
      const int rk = pl.rank_of[e] + 1;
      pl.rank_of[e] = rk;
      pl.tag_of[rk] = e;
    }
    if (par.leader()) {
      pl.tag_of[0] = dn;
      for (int i = 0; i < MML; ++i) pl.strs[(int64_t)dn * MML + i] = sh.t32[i];
      pl.lens[dn] = len;
      pl.ix[dn] = (dn > 0 ? pl.ix[dn - 1] : 0) + 1;
    }
  }
  for (int b = par.tid(); b < jb.elen; b += par.nthr())
    io.out[jb.opos + b] = sh.t32[b];
  par.sync();
  return dup;
}

// The leader's warp: post job k, once the ring has room for it (the
// warps' progress is read again only when what was seen does not show
// room).
template <class P>
X3_HD void post(const P& par, DecShared& sh, int k, const DecJob& jb,
                int& room) {
  if (k - JQ + 2 > room) {
    room = k;
    for (int w = 1; w < imin(par.nwarps(), NW_MAX); ++w) {
      wait_ge(&sh.prog[w], k - JQ + 2);
      room = imin(room, ((volatile int*)sh.prog)[w]);
    }
  }
  if (par.lane() == 0) sh.job[k % JQ] = jb;
  publish(&sh.posted, k + 1);
}

// The leader's warp: decode event k and post it.  Returns the job's kind.
template <class P>
X3_HD int leader_event(const P& par, const Layout& L, const Planes& pl,
                       const DecIO& io, DecShared& sh, Leader& Ld, int k,
                       PhClock& pc) {
  DecJob jb = {JOB_END, 0, 0, 0, 0, Ld.dn, Ld.ixn, Ld.opos, -1, 0, 0, 0};
  if (Ld.done) {
    post(par, sh, k, jb, Ld.room);
    return JOB_END;
  }
  // every event of a valid stream but EOF emits at least one byte
  if (k > io.block_bytes) {
    Ld.flags |= OF_STEPS;
    post(par, sh, k, jb, Ld.room);
    return JOB_END;
  }
  DecState& S = Ld.S;
  // the event symbol (x3.c:293)
  int etot = 0;
#pragma unroll
  for (int e = 0; e < E_LAST; ++e) etot += Ld.ev[e];
  uint32_t step, value;
  dec_value(S, etot, step, value);
  // a value past the total decodes as the last symbol, EOF, and ends the
  // lane; it marks the stream corrupt
  if (value >= (uint32_t)etot) Ld.flags |= OF_CORRUPT;
  const Sym e = small_decode(Ld.ev, E_LAST, value);
  dec_update(S, step, e.low, e.low + e.span);
#pragma unroll
  for (int q = 0; q < E_LAST; ++q)
    if (q == e.sym) {
      Ld.ev[q] += 1;
      if (q != E_EOF) Ld.counts[q] += 1;  // x3.c never counts EOF
    }
  pc.mark(PHD_EVSYM);
  pc.count(PHD_EVENTS, 1);
  pc.count(PHD_N_CTX0 + imin(e.sym, E_NEW), e.sym != E_EOF);
  if (e.sym == E_EOF) {
    Ld.sizes[E_EOF] = fadd(Ld.sizes[E_EOF], bits(prob(e.span, etot)));
    Ld.done = 1;
    post(par, sh, k, jb, Ld.room);
    return JOB_END;
  }

  if (e.sym == E_NEW) {
    // its length and bytes (x3.c:274, 300)
    dec_value(S, Ld.mtot, step, value);
    bool bad = value >= Ld.mtot;
    const Sym l = lane_search(Ld.ms, value);
    dec_update(S, step, l.low, l.low + l.span);
    for (int i = 0; i < VL; ++i)
      if (vlane(i) == l.sym) Ld.ms[i] += 1;
    const float msb = bits(prob(l.span, Ld.mtot));
    Ld.mtot += 1;
    const int len = l.sym + 1;
    // byte k follows k bytes of the fragment, each of which added one to
    // the char model's total
    float lit = 0.0f;
    for (int b = 0; b < MML; ++b) {
      if (b >= len) {
        if (par.lane() == 0) sh.t32[b] = 0;
        continue;
      }
      dec_value(S, Ld.ctot + b, step, value);
      bad |= value >= Ld.ctot + b;
      const Sym c = char_search(Ld.ch, value);
      dec_update(S, step, c.low, c.low + c.span);
      for (int i = 0; i < VL; ++i)
        if (vlane(i) == c.sym >> 3) {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (q == (c.sym & 7)) Ld.ch[i][q] += 1;
        }
      lit = fadd(lit, bits(prob(c.span, Ld.ctot + b)));
      if (par.lane() == 0) sh.t32[b] = (uint8_t)c.sym;
    }
    Ld.ctot += len;
    const float evbits = bits(prob(e.span, etot));
    Ld.sizes[E_NEW] = fadd(Ld.sizes[E_NEW], fadd(fadd(evbits, msb), lit));
    pc.mark(PHD_LITERAL);
    const bool fits = Ld.opos + len <= io.block_bytes;
    jb.kind = JOB_NEW;
    jb.mode = E_NEW;
    jb.pos = len;
    jb.elen = fits ? len : -1;
    post(par, sh, k, jb, Ld.room);
    const bool dup = new_event(par, L, pl, io, sh, jb);
    if (!dup) {
      if (Ld.dn < L.D) {
        Ld.ixtot = (Ld.dn > 0 ? Ld.ixtot : 0) + 1;
        Ld.ixn = Ld.dn + 1;
        Ld.dn += 1;
      } else {
        Ld.flags |= OF_DICT;
      }
    }
    // a write that does not fit ends the lane (x3tpu codec.py _dec_body
    // step 6)
    if (fits) Ld.opos += len;
    else Ld.flags |= OF_OUT, Ld.done = 1;
    if (bad) Ld.flags |= OF_CORRUPT, Ld.done = 1;
    pc.mark(PHD_PROBE);
    return JOB_NEW;
  }

  // a hit: the payload by mode (x3.c:57-129), from the row its family's
  // warp prepared or from the index model
  const int mode = e.sym;
  const bool ix = mode == E_IDX1;
  const RowPrep& rp = sh.prep[mode == E_CTX0 ? 0 : 1];
  if (ix) {
    wait_ge(&sh.prog[W_DICT], k + 1);
    pc.mark(PHD_WAIT_DICT);
  } else {
    wait_ge(&sh.prog[mode == E_CTX0 ? W_F0 : W_F1], k + 1);
    pc.mark(PHD_WAIT_ROWS);
  }
  const uint32_t total = ix ? (uint32_t)Ld.ixtot : rp.total;
  const int ptot = imax((int)total, 1);
  dec_value(S, ptot, step, value);
  const bool bad = value >= total;
  int tag;
  const Sym ps = ix ? ix_search(pl.ix, pl.tag_of, L.D, Ld.ixn, value, tag)
                    : wsearch(rp.freqs, rp.tags, rp.n, rp.K, rp.exc, value,
                              tag);
  pc.mark(PHD_SEARCH);
  dec_update(S, step, ps.low, ps.low + ps.span);
  const int len = pl.lens[iclamp(tag, 0, L.D - 1)];
  const bool fits = Ld.opos + len <= io.block_bytes;
  jb.kind = JOB_HIT;
  jb.tag = tag;
  jb.mode = mode;
  jb.pos = ps.sym;
  jb.span = ps.span;
  jb.elen = fits ? len : -1;
  jb.ev_span = e.span;
  jb.ev_tot = etot;
  jb.pay_tot = ptot;
  post(par, sh, k, jb, Ld.room);
  if (ix) {
    Ld.ixtot += 1;
    Ld.ixn = imax(Ld.ixn, imin(ps.sym, L.D - 1) + 1);
  }
  if (fits) Ld.opos += len;
  else Ld.flags |= OF_OUT, Ld.done = 1;
  if (bad) Ld.flags |= OF_CORRUPT, Ld.done = 1;
  pc.mark(PHD_UPDATES);
  return JOB_HIT;
}

// ---------------------------------------------------------------------------
// One lane, start to finish (decompress loop, x3.c:285-353).  kWarm: the
// lane starts from io.warm's counts; without it they are 0, which the
// compiler folds into the lane's first row preparations (read from
// arguments, they cost K2 280 more instructions and 2.7 % more time on an
// unwarmed wave, PERF.md §6, so a warm start has an instantiation of its
// own).
// ---------------------------------------------------------------------------

template <bool kWarm = false, class P>
X3_HD void decode_lane(const P& par, const Layout& L, const DecIO& io,
                       DecShared& sh) {
  const Planes pl = resolve(L, io.scr, nullptr, nullptr);
  for (int w = par.tid(); w < NW_MAX; w += par.nthr()) {
    sh.prog[w] = 0;
    sh.wflags[w] = 0;
  }
  if (par.leader()) sh.posted = sh.idk = 0;
  par.sync();
  PhClock pc;
#ifdef __CUDA_ARCH__
  const long long t_start = clock64();
  (void)t_start;
#endif
  Leader Ld;
  FamState f0 = {}, f1 = {};
  if (kWarm) {
    // the warm hub items and pairs are in the scratch already; each
    // family's warp keeps its own counts
    f0.hub_n = io.warm.hub_n[0];
    f1.hub_n = io.warm.hub_n[1];
    f1.pair_n = io.warm.pair_n;
  }
  float hsz[E_IDX1 + 1] = {0.0f, 0.0f, 0.0f};  // warp 3's
  const int w = par.nwarps() == 1 ? W_LEAD : par.warp();

  if (w == W_LEAD) {
    DecState& S = Ld.S;
    S.low = 0;
    S.high = TOP;
    Ld.flags = Ld.opos = Ld.room = 0;
    // a seeded dictionary starts with its K entries, the index model with
    // K symbols of freq 1
    Ld.dn = Ld.ixn = Ld.ixtot = io.seeds;
    Ld.done = io.nbytes <= 0;  // x3tpu/vm/driver.py _init_state_dec
#pragma unroll
    for (int e = 0; e < E_LAST; ++e) {
      Ld.ev[e] = event_init_freq(e);
      Ld.counts[e] = 0;
      Ld.sizes[e] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < VL; ++i) {
      Ld.ms[i] = 1;
#pragma unroll
      for (int q = 0; q < 8; ++q) Ld.ch[i][q] = 1;
    }
    Ld.mtot = MML;
    Ld.ctot = 256;
    // a word at byte offset o is readable iff o < nbytes - 3 (bio.c:11)
    S.nwords = io.nbytes >= 4 ? (io.nbytes - 4) / 4 + 1 : 0;
    S.widx = 0;
    S.words = io.words;
    S.iw = io.iw;
    S.nxt = fetch_word(S.words, S.iw, 0, S.nwords);
    S.acc = 0;
    S.used = 32;
    // prime with exactly 31 bits, MSB-first (ac.c:133-140)
    S.buf = bitrev32(get_bits(S, 31)) >> 1;
  }

#ifdef __CUDA_ARCH__
  // each warp its own loop over the jobs, in order
  if (w == W_LEAD) {
    for (int k = 0; leader_event(par, L, pl, io, sh, Ld, k, pc) != JOB_END;
         ++k) {
    }
  } else {
    if (w == W_F1) f1_job(par, L, pl, sh, f1, nullptr, 0, pc);
    if (w == W_F0) f0_job(par, pl, sh, f0, nullptr, 0, pc);
    if (w >= W_DICT) publish(&sh.prog[w], 1);
    for (int k = 0;; ++k) {
      // the spare warps only join the literals; they nap while waiting
      wait_ge(&sh.posted, k + 1, w >= W_JOBS);
      pc.reset();
      const DecJob& jb = sh.job[k % JQ];
      if (jb.kind == JOB_END) break;
      if (jb.kind == JOB_NEW) new_event(par, L, pl, io, sh, jb);
      if (w == W_F1) {
        f1_job(par, L, pl, sh, f1, &jb, k + 1, pc);
      } else if (w == W_F0) {
        f0_job(par, pl, sh, f0, &jb, k + 1, pc);
      } else if (w == W_DICT && jb.kind == JOB_HIT) {
        dict_job(par, L, pl, jb, pc);
        const DecJob j = jb;  // the slot is the leader's once told
        publish(&sh.prog[w], k + 2);
        dict_emit(par, L, pl, io, j, hsz, pc);
      } else {
        publish(&sh.prog[w], k + 2);
      }
    }
    if (par.lane() == 0) {
      sh.wflags[w] = w == W_F1 ? f1.flags : f0.flags;
      if (w == W_DICT)
#pragma unroll
        for (int q = 0; q <= E_IDX1; ++q) sh.wsizes[q] = hsz[q];
    }
  }
  par.sync();
  if (io.phases) {
    if (par.leader()) pc.count(PHD_TOTAL, clock64() - t_start);
    pc.flush(io.phases);
  }
#else
  // the host: one thread takes each event's jobs in turn
  f1_job(par, L, pl, sh, f1, nullptr, 0, pc);
  f0_job(par, pl, sh, f0, nullptr, 0, pc);
  for (int k = 0;; ++k) {
    if (leader_event(par, L, pl, io, sh, Ld, k, pc) == JOB_END) break;
    const DecJob& jb = sh.job[k % JQ];
    f1_job(par, L, pl, sh, f1, &jb, k + 1, pc);
    f0_job(par, pl, sh, f0, &jb, k + 1, pc);
    if (jb.kind == JOB_HIT) {
      dict_job(par, L, pl, jb, pc);
      dict_emit(par, L, pl, io, jb, hsz, pc);
    }
  }
  sh.wflags[W_F1] = f1.flags;
  sh.wflags[W_F0] = f0.flags;
  for (int q = 0; q <= E_IDX1; ++q) sh.wsizes[q] = hsz[q];
#endif

  if (par.leader()) {
    *io.out_len = Ld.opos;
#pragma unroll
    for (int e = 0; e < E_LAST; ++e) {
      io.counts[e] = Ld.counts[e];
      io.sizes[e] = e <= E_IDX1 ? sh.wsizes[e] : Ld.sizes[e];
    }
    *io.flags = Ld.flags | sh.wflags[W_F0] | sh.wflags[W_F1];
  }
}

}  // namespace x3
