// Host build of the encoder and decoder cores (x3_core.cuh,
// x3_dec_core.cuh) with one thread per lane: the scan, the probe, the
// searches and the reductions run as plain serial loops (x3::ParHost).  It
// exists for the CPU tests, which hold the kernels' per-lane logic against
// the plain PyTorch codec without a GPU.  Build: g++ -O2 -ffp-contract=off
// -std=c++17 -shared -fPIC.
#include <vector>

#include "x3_dec_core.cuh"

namespace {

// The symbol search of x3tpu's decoder over w freqs, serially: a model,
// whose symbols count when their freq is nonzero (by_freq), or a context
// row's w live items, which all count (ctx_decode_pos).  The reference
// for the kernel's warp-wide searches.
x3::Sym decode_search(const int32_t* f, int w, bool by_freq, uint32_t value) {
  uint64_t c = 0, cnt = 0;
  for (int i = 0; i < w; ++i) {
    const uint32_t fi = (uint32_t)f[i];
    if ((!by_freq || fi > 0) && c <= value) ++cnt;
    c += fi;
  }
  x3::Sym r;
  r.sym = x3::imax((int)cnt - 1, 0);
  uint64_t low = 0;
  for (int i = 0; i < r.sym; ++i) low += (uint32_t)f[i];
  r.low = (int)low;
  r.span = r.sym < w ? f[r.sym] : 0;
  return r;
}

void put(const x3::Sym& s, int tag, int32_t* out) {
  out[0] = s.sym;
  out[1] = s.low;
  out[2] = s.span;
  out[3] = tag;
}

}  // namespace

extern "C" {

// The index model's search (ix_search, over the inclusive cumulative sum
// of ix's first ixn entries, tags tag_of) at value: out[0..3] sym, low,
// span, tag; out[4..7] the same from decode_search(ix, D, by_freq) and
// tag_of[sym].
void x3h_ix_search(const int32_t* ix, const int32_t* tag_of, int D, int ixn,
                   uint32_t value, int32_t* out) {
  std::vector<int32_t> cum(D, 0);
  for (int i = 0, s = 0; i < ixn; ++i) cum[i] = s += ix[i];
  int tag;
  const x3::Sym k = x3::ix_search(cum.data(), tag_of, D, ixn, value, tag);
  put(k, tag, out);
  const x3::Sym r = decode_search(ix, D, true, value);
  put(r, tag_of[x3::imin(r.sym, D - 1)], out + 4);
}

// A context row's search (chunk_bases, then wsearch) over its n items at
// value: out[0..3] sym, low, span, tag, out[4] the row's total; out[5..8]
// the same from decode_search(f, n) and tags[sym], out[9] the plain sum.
void x3h_row_search(const int32_t* f, const int32_t* tags, int n,
                    uint32_t value, int32_t* out) {
  uint32_t exc[32];
  int K, tag;
  const uint32_t tot = x3::chunk_bases(f, n, K, exc);
  const x3::Sym k = x3::wsearch(f, tags, n, K, exc, value, tag);
  put(k, tag, out);
  out[4] = (int32_t)tot;
  const x3::Sym r = decode_search(f, n, false, value);
  put(r, tags[r.sym], out + 5);
  int32_t sum = 0;
  for (int i = 0; i < n; ++i) sum += f[i];
  out[9] = sum;
}

// The literal path's searches at value: the char model (256 freqs, 8 a
// lane: char_search) in out[0..2] and small_decode's in out[3..5]; the
// length model (the first 32 freqs, one a lane: lane_search) in out[6..8]
// and small_decode's in out[9..11].
void x3h_small_search(const int32_t* f, uint32_t value, int32_t* out) {
  int ch[32][8], ms[32];
  for (int i = 0; i < 256; ++i) ch[i / 8][i % 8] = f[i];
  for (int i = 0; i < 32; ++i) ms[i] = f[i];
  const x3::Sym a = x3::char_search(ch, value);
  const x3::Sym b = x3::small_decode(f, 256, value);
  const x3::Sym c = x3::lane_search(ms, value);
  const x3::Sym d = x3::small_decode(f, 32, value);
  const x3::Sym all[4] = {a, b, c, d};
  for (int k = 0; k < 4; ++k) {
    out[3 * k] = all[k].sym;
    out[3 * k + 1] = all[k].low;
    out[3 * k + 2] = all[k].span;
  }
}

// Byte offsets of the planes in shared memory (x3_core.cuh PL_* order, -1
// for a plane in the scratch), then their total: out [PL_COUNT + 1].
void x3h_smem_layout(int D, int pair_cap, int items1, int items0,
                     int small_cap, int promo_rows, long long tb,
                     unsigned smem_mask, long long* out) {
  const x3::Caps caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0};
  x3::Layout lay = x3::make_layout(caps);
  x3::place_smem(lay, tb, smem_mask);
  for (int k = 0; k < x3::PL_COUNT; ++k) out[k] = lay.sm[k];
  out[x3::PL_COUNT] = lay.smem_bytes;
}

// The window scan at p of a text row (zero-padded past p + W + 36):
// out[i] = positions s in [p+1, p+W-32) whose next i+1 bytes repeat those
// at p (backend.c:66-74).
void x3h_window_counts(const uint8_t* text, int p, int W, int32_t* out) {
  uint32_t T[x3::MML / 4];
  x3::target_words(text, p, T);
  x3::window_counts(x3::ParHost(), 0, 1, text, p, W, T, out);
}

// K1's dictionary probe at each of the npos positions pos of a text row
// (zero-padded to 64 bytes past the last), over the n entries strs (n x 32
// bytes) and lens of a dictionary of size D, by the scan (probe, K2's) and
// by the hash index of `slots` slots (0: hash_slots(D)), built as K1
// builds it: the first K entries by a seeded start's hash_seed, the rest
// one an event by hash_insert.  out [npos, 8]: the scan's okmask, len,
// slot and len again, then the index's (hash_probe; hash_probe_len, the
// veto's probe).  Returns the slots the index's lookups read.
long long x3h_probe_pair(const uint8_t* strs, const int32_t* lens, int n,
                         int D, int K, long long slots, const uint8_t* text,
                         const int32_t* pos, int npos, int32_t* out) {
  const x3::ParHost par;
  std::vector<int32_t> plane(slots ? slots : x3::hash_slots(D), 0);
  const x3::HashIx hx = x3::hash_index(plane.data(), plane.size(), D);
  x3::hash_seed(par, hx, strs, lens, K);
  for (int e = K; e < n; ++e) {
    uint32_t w[x3::MML / 4];
    for (int k = 0; k < x3::MML / 4; ++k)
      w[k] = x3::load_word(strs + (int64_t)e * x3::MML + 4 * k);
    x3::hash_insert(hx, x3::key_hash(x3::WordsOf{w}, lens[e]), e);
  }
  int visits = 0;
  for (int i = 0; i < npos; ++i) {
    int32_t* o = out + 8 * i;
    const x3::Probe a = x3::probe(par, strs, lens, n, text + pos[i]);
    uint32_t T[x3::MML / 4];
    x3::target_words(text, pos[i], T);
    uint64_t mask = 0, best = 0;
    x3::hash_probe(par, hx, strs, lens, T, mask, best, visits);
    const x3::Probe b = x3::make_probe(mask, best);
    const int32_t got[8] = {
        (int32_t)a.okmask, a.len, a.slot, a.len,
        (int32_t)b.okmask, b.len, b.slot,
        x3::hash_probe_len(par, hx, strs, lens, text, pos[i], visits)};
    memcpy(o, got, sizeof(got));
  }
  return visits;
}

// K1's index model through its tree (ix_tree_seed, ix_tree_add,
// ix_tree_prefix), driven as encode_lane drives it: K seeds of freq 1
// (seed_dict) in a model of D positions, then n events.  Event s is a hit
// at rank min(rank[s], live entries - 1), or a new entry where rank[s] < 0
// or none is live (dropped once D are).  A hit takes its low from the
// tree, its span from the freqs and its total as K1 counts it (the live
// entries and the E_IDX1 events), and gains 1 at its rank where idx1[s]
// (an E_IDX1 event); a new entry gets freq 1 at the live count.  A gain
// reaches the tree in the next event, as in pass 1.  out [n, 3]: each
// hit's low, span and total (zeros for a new entry); ix [D]: the freqs at
// the end.  Returns the tree nodes read and written.
long long x3h_ix_tree(int D, int K, int n, const int32_t* rank,
                      const int32_t* idx1, int32_t* out, int32_t* ix) {
  const x3::ParHost par;
  std::vector<uint32_t> tree(x3::ix_tree_words(D), 0);
  memset(ix, 0, sizeof(int32_t) * D);
  for (int j = 0; j < K; ++j) ix[j] = 1;
  x3::ix_tree_seed(par, tree.data(), D, ix, K);
  int dn = K, idx1_n = 0, add = -1, nodes = 0;
  for (int s = 0; s < n; ++s) {
    if (add >= 0) x3::ix_tree_add(par, tree.data(), D, add, nodes);
    add = -1;
    int32_t* o = out + 3 * s;
    o[0] = o[1] = o[2] = 0;
    if (rank[s] >= 0 && dn > 0) {
      const int r = x3::imin(rank[s], dn - 1);
      o[0] = (int32_t)x3::ix_tree_prefix(par, tree.data(), r, nodes);
      o[1] = ix[r];
      o[2] = dn + idx1_n;
      if (idx1[s]) {
        ix[r] += 1;
        add = r;
        idx1_n += 1;
      }
    } else if (dn < D) {
      ix[dn] = 1;
      add = dn++;
    }
  }
  return nodes;
}

// Offsets of the dictionary planes a seeded start writes, as
// x3_dict_layout in x3_encoder.cu: out [5] = strs, lens, rank_of, tag_of,
// ix (int32 words).
void x3h_dict_layout(int D, int pair_cap, int items1, int items0,
                     int small_cap, int promo_rows, long long* out) {
  const x3::Layout lay = x3::make_layout(
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0});
  out[0] = lay.strs;
  out[1] = lay.lens;
  out[2] = lay.rank_of;
  out[3] = lay.tag_of;
  out[4] = lay.ix;
}

// One lane's zeroed scratch scr (x3_scratch_words) seeded by seed_dict
// with the K seeds (strs K x 32 bytes, lens K): the host build's seeding,
// which the wrapper's (driver.seed_scratch) must equal.
void x3h_seed_scratch(int D, int pair_cap, int items1, int items0,
                      int small_cap, int promo_rows, const uint8_t* strs,
                      const int32_t* lens, int K, int cumulative,
                      int32_t* scr) {
  const x3::Layout lay = x3::make_layout(
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0});
  x3::seed_dict(lay, scr, strs, lens, K, cumulative != 0);
}

// int32 words of scratch one lane needs, as x3_scratch_words in
// x3_encoder.cu.
long long x3h_scratch_words(int D, int pair_cap, int items1, int items0,
                            int small_cap, int promo_rows) {
  return x3::make_layout(
             x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0})
      .words;
}

// Offsets of context family fam's planes, as x3_fam_layout in
// x3_encoder.cu: out [12] (x3_core.cuh fam_offsets' order).
void x3h_fam_layout(int D, int pair_cap, int items1, int items0,
                    int small_cap, int promo_rows, int fam, long long* out) {
  const x3::Layout lay = x3::make_layout(
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0});
  x3::fam_offsets(fam ? lay.f1 : lay.f0, out);
}

}  // extern "C"

namespace {

// Each lane's starting scratch: a copy of init (one lane's scratch image,
// seeds and warm tables written in) where it is not null, else zeros with
// the K seeds written in by seed_dict; then `extra` zero words (K1's hash
// index and index model tree).
void start_scratch(const x3::Layout& lay, std::vector<int32_t>& scratch,
                   const int32_t* init, const uint8_t* seed_strs,
                   const int32_t* seed_lens, int K, bool cumulative,
                   int64_t extra = 0) {
  if (init) {
    scratch.assign(init, init + lay.words);
  } else {
    scratch.assign(lay.words, 0);
    x3::seed_dict(lay, scratch.data(), seed_strs, seed_lens, K, cumulative);
  }
  scratch.resize(lay.words + extra, 0);
}

int encode_lanes(const uint8_t* text, const int32_t* tlen, int lanes,
                 long long tb, const x3::Params& prm, const x3::Caps& caps,
                 unsigned smem_mask, const uint8_t* seed_strs,
                 const int32_t* seed_lens, int K, const int32_t* init,
                 x3::WarmN warm, uint32_t* words, int32_t* byte_lens,
                 int32_t* counts, float* sizes, int32_t* flags,
                 int32_t* scratch_out) {
  const int out_words = caps.out_words;
  x3::Layout lay = x3::make_layout(caps);
  x3::place_smem(lay, tb, smem_mask);
  std::vector<int32_t> scratch;
  // int32 elements keep the buffer aligned as the planes need
  std::vector<int32_t> smem(lay.smem_bytes / 4 + 1);
  for (int lane = 0; lane < lanes; ++lane) {
    start_scratch(lay, scratch, init, seed_strs, seed_lens, K, false,
                  x3::hash_slots(caps.D) + x3::ix_tree_words(caps.D));
    x3::LaneIO io;
    io.text = text + (long long)lane * tb;
    io.tb = tb;
    io.tlen = tlen[lane];
    io.seeds = K;
    io.warm = warm;
    io.scr = scratch.data();
    io.smem = (uint8_t*)smem.data();
    io.words = words + (long long)lane * out_words;
    io.byte_len = byte_lens + lane;
    io.counts = counts + lane * x3::E_LAST;
    io.sizes = sizes + lane * x3::E_LAST;
    io.flags = flags + lane;
    io.phases = nullptr;
    x3::Lane R;
    x3::Shared sh;
    if (warm.any())
      x3::encode_lane<true>(x3::ParHost(), prm, caps, lay, io, R, sh);
    else
      x3::encode_lane<false>(x3::ParHost(), prm, caps, lay, io, R, sh);
  }
  if (scratch_out && lanes > 0)
    memcpy(scratch_out, scratch.data(), sizeof(int32_t) * lay.words);
  return 0;
}

int decode_lanes(const uint32_t* words, const int32_t* byte_lens, int lanes,
                 int iw, int block_bytes, const x3::Caps& caps,
                 const uint8_t* seed_strs, const int32_t* seed_lens, int K,
                 const int32_t* init, x3::WarmN warm, uint8_t* out,
                 int32_t* out_lens, int32_t* counts, float* sizes,
                 int32_t* flags) {
  const x3::Layout lay = x3::make_layout(caps);
  std::vector<int32_t> scratch;
  for (int lane = 0; lane < lanes; ++lane) {
    start_scratch(lay, scratch, init, seed_strs, seed_lens, K, true);
    x3::DecIO io;
    io.words = words + (long long)lane * iw;
    io.nbytes = byte_lens[lane];
    io.iw = iw;
    io.seeds = K;
    io.warm = warm;
    io.scr = scratch.data();
    io.out = out + (long long)lane * block_bytes;
    io.block_bytes = block_bytes;
    io.out_len = out_lens + lane;
    io.counts = counts + lane * x3::E_LAST;
    io.sizes = sizes + lane * x3::E_LAST;
    io.flags = flags + lane;
    io.phases = nullptr;
    x3::DecShared sh;
    if (warm.any())
      x3::decode_lane<true>(x3::ParHost(), lay, io, sh);
    else
      x3::decode_lane<false>(x3::ParHost(), lay, io, sh);
  }
  return 0;
}

}  // namespace

extern "C" {

// Same arguments and outputs as x3_encode in x3_encoder.cu, in host memory,
// but for the seeds: the K seeds themselves (seed_strs K x 32 bytes,
// seed_lens K), which seed_dict writes into each lane's scratch; words
// [lanes, out_words] must be zeroed.  The planes of smem_mask live in a
// buffer of their own, as the kernel's shared memory holds them.  Where
// scratch_out [x3h_scratch_words] is not null, the last lane's scratch as
// the encoder left it is copied there (the planes of smem_mask as they
// were at the lane's start).
int x3h_encode(const uint8_t* text, const int32_t* tlen, int lanes,
               long long tb, int T, int W, int f1, int f2, int nl, int D,
               int pair_cap, int items1, int items0, int small_cap,
               int promo_rows, int out_words, unsigned smem_mask,
               const uint8_t* seed_strs, const int32_t* seed_lens, int K,
               uint32_t* words, int32_t* byte_lens, int32_t* counts,
               float* sizes, int32_t* flags, int32_t* scratch_out) {
  return encode_lanes(
      text, tlen, lanes, tb, x3::Params{T, W, f1, f2, nl},
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, out_words},
      smem_mask, seed_strs, seed_lens, K, nullptr, x3::WarmN{0, {0, 0}},
      words, byte_lens, counts, sizes, flags, scratch_out);
}

// As x3h_encode, every lane from a warm start: init is one lane's scratch
// (x3h_scratch_words) with the K seeds and the warm tables written in (as
// the wrapper writes them, x3tpu_torch/vm/driver.py), and pair_n, hub0_n,
// hub1_n the warm counts, as x3_encode takes them.
int x3h_encode_warm(const uint8_t* text, const int32_t* tlen, int lanes,
                    long long tb, int T, int W, int f1, int f2, int nl, int D,
                    int pair_cap, int items1, int items0, int small_cap,
                    int promo_rows, int out_words, unsigned smem_mask, int K,
                    const int32_t* init, int pair_n, int hub0_n, int hub1_n,
                    uint32_t* words, int32_t* byte_lens, int32_t* counts,
                    float* sizes, int32_t* flags) {
  return encode_lanes(
      text, tlen, lanes, tb, x3::Params{T, W, f1, f2, nl},
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, out_words},
      smem_mask, nullptr, nullptr, K, init,
      x3::WarmN{pair_n, {hub0_n, hub1_n}}, words, byte_lens, counts, sizes,
      flags, nullptr);
}

// Same arguments and outputs as x3_decode in x3_decoder.cu, in host
// memory, the seeds as x3h_encode takes them; out [lanes, block_bytes]
// must be zeroed.
int x3h_decode(const uint32_t* words, const int32_t* byte_lens, int lanes,
               int iw, int block_bytes, int D, int pair_cap, int items1,
               int items0, int small_cap, int promo_rows,
               const uint8_t* seed_strs, const int32_t* seed_lens, int K,
               uint8_t* out,
               int32_t* out_lens, int32_t* counts, float* sizes,
               int32_t* flags) {
  return decode_lanes(
      words, byte_lens, lanes, iw, block_bytes,
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0},
      seed_strs, seed_lens, K, nullptr, x3::WarmN{0, {0, 0}}, out, out_lens,
      counts, sizes, flags);
}

// As x3h_decode, every lane from a warm start: init and the counts as
// x3h_encode_warm takes them (the index model in init as its cumulative
// sum).
int x3h_decode_warm(const uint32_t* words, const int32_t* byte_lens,
                    int lanes, int iw, int block_bytes, int D, int pair_cap,
                    int items1, int items0, int small_cap, int promo_rows,
                    int K, const int32_t* init, int pair_n, int hub0_n,
                    int hub1_n, uint8_t* out, int32_t* out_lens,
                    int32_t* counts, float* sizes, int32_t* flags) {
  return decode_lanes(
      words, byte_lens, lanes, iw, block_bytes,
      x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0},
      nullptr, nullptr, K, init, x3::WarmN{pair_n, {hub0_n, hub1_n}}, out,
      out_lens, counts, sizes, flags);
}

}  // extern "C"
