// Host build of the encoder and decoder cores (x3_core.cuh,
// x3_dec_core.cuh) with one thread per lane: the scan, the probe, the
// searches and the reductions run as plain serial loops (x3::ParHost).  It
// exists for the CPU tests, which hold the kernels' per-lane logic against
// the plain PyTorch codec without a GPU.  Build: g++ -O2 -ffp-contract=off
// -std=c++17 -shared -fPIC.
#include <vector>

#include "x3_dec_core.cuh"

extern "C" {

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

// Same arguments and outputs as x3_encode in x3_encoder.cu, in host memory;
// words [lanes, out_words] must be zeroed.  The planes of smem_mask live in
// a buffer of their own, as the kernel's shared memory holds them.
int x3h_encode(const uint8_t* text, const int32_t* tlen, int lanes,
               long long tb, int T, int W, int f1, int f2, int nl, int D,
               int pair_cap, int items1, int items0, int small_cap,
               int promo_rows, int out_words, unsigned smem_mask,
               uint32_t* words, int32_t* byte_lens, int32_t* counts,
               float* sizes, int32_t* flags) {
  const x3::Caps caps{D, pair_cap, items1, items0, small_cap, promo_rows,
                      out_words};
  const x3::Params prm{T, W, f1, f2, nl};
  x3::Layout lay = x3::make_layout(caps);
  x3::place_smem(lay, tb, smem_mask);
  std::vector<int32_t> scratch;
  // int32 elements keep the buffer aligned as the planes need
  std::vector<int32_t> smem(lay.smem_bytes / 4 + 1);
  for (int lane = 0; lane < lanes; ++lane) {
    scratch.assign(lay.words, 0);
    x3::LaneIO io;
    io.text = text + (long long)lane * tb;
    io.tb = tb;
    io.tlen = tlen[lane];
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
    x3::encode_lane(x3::ParHost(), prm, caps, lay, io, R, sh);
  }
  return 0;
}

// Same arguments and outputs as x3_decode in x3_decoder.cu, in host
// memory; out [lanes, block_bytes] must be zeroed.
int x3h_decode(const uint32_t* words, const int32_t* byte_lens, int lanes,
               int iw, int block_bytes, int D, int pair_cap, int items1,
               int items0, int small_cap, int promo_rows, uint8_t* out,
               int32_t* out_lens, int32_t* counts, float* sizes,
               int32_t* flags) {
  const x3::Caps caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0};
  const x3::Layout lay = x3::make_layout(caps);
  std::vector<int32_t> scratch;
  for (int lane = 0; lane < lanes; ++lane) {
    scratch.assign(lay.words, 0);
    x3::DecIO io;
    io.words = words + (long long)lane * iw;
    io.nbytes = byte_lens[lane];
    io.iw = iw;
    io.scr = scratch.data();
    io.out = out + (long long)lane * block_bytes;
    io.block_bytes = block_bytes;
    io.out_len = out_lens + lane;
    io.counts = counts + lane * x3::E_LAST;
    io.sizes = sizes + lane * x3::E_LAST;
    io.flags = flags + lane;
    x3::Lane R;
    x3::Shared sh;
    x3::decode_lane(x3::ParHost(), lay, io, R, sh);
  }
  return 0;
}

}  // extern "C"
