// K1: the x3 encoder kernel for Hopper (sm_90a).
//
// Replaces x3tpu/vm/kernel.py:encoder_kernel, the Pallas codec-VM encoder.
// One launch encodes a whole wave: one CTA of 256 threads per lane (one
// independent block), running x3_core.cuh's encode_lane from the first
// event to EOF and flush.
//
// What bounds it on this card: each event is a chain of dependent steps
// (probe -> scan -> sweep -> mode choice -> AC coding -> updates), so a
// lane is latency-bound, not bandwidth- or FLOP-bound.  The per-event
// O(W) window scan (W - 33 positions, each a byte compare run) and the
// O(D) dictionary probe are the wide parts; the AC coder, the models and
// the context updates are a serial chain.  The design spreads the wide
// parts (scan, probe, veto probes, context-row find and sums, index-model
// sums, rank updates) over the CTA's 256 threads with block reductions,
// and keeps the serial chain on one thread with its small models (event,
// length, char) in shared memory.  Lanes run concurrently, one per SM.
// Dictionary and context tables live in a zeroed global scratch the
// wrapper allocates; nothing is a compile-time constant except
// MAX_MATCH_LEN, so a capacity retry relaunches with new sizes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: the mode
// choice compares f32 products of quotients and must round as C does).

#include <cuda_runtime.h>

#include "x3_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
encoder_kernel(const uint8_t* __restrict__ text, const int32_t* __restrict__ tlen,
               int64_t tb, x3::Params prm, x3::Caps caps, x3::Layout lay,
               int32_t* scratch, uint32_t* words, int32_t* byte_lens,
               int32_t* counts, float* sizes, int32_t* flags) {
  __shared__ x3::Lane R;
  __shared__ x3::Shared sh;
  const int64_t lane = blockIdx.x;
  x3::LaneIO io;
  io.text = text + lane * tb;
  io.tlen = tlen[lane];
  io.scr = scratch + lane * lay.words;
  io.words = words + lane * caps.out_words;
  io.byte_len = byte_lens + lane;
  io.counts = counts + lane * x3::E_LAST;
  io.sizes = sizes + lane * x3::E_LAST;
  io.flags = flags + lane;
  x3::ParDev par;
  par.scratch = sh.red;
  x3::encode_lane(par, prm, caps, lay, io, R, sh);
}

x3::Caps make_caps(int D, int pair_cap, int items1, int items0, int small_cap,
                   int promo_rows, int out_words) {
  return x3::Caps{D, pair_cap, items1, items0, small_cap, promo_rows, out_words};
}

}  // namespace

extern "C" {

// int32 words of scratch one lane needs at these capacities.
long long x3_scratch_words(int D, int pair_cap, int items1, int items0,
                           int small_cap, int promo_rows) {
  return x3::make_layout(
             make_caps(D, pair_cap, items1, items0, small_cap, promo_rows, 0))
      .words;
}

// Encode `lanes` blocks on `stream`.  All pointers are device memory:
// text u8 [lanes, tb], tlen i32 [lanes], scratch i32 [lanes, scratch_words]
// and words u32 [lanes, out_words] zeroed, byte_lens i32 [lanes], counts
// i32 [lanes, 5], sizes f32 [lanes, 5], flags i32 [lanes].  Returns
// cudaGetLastError() after the launch.
int x3_encode(const void* text, const void* tlen, int lanes, long long tb,
              int T, int W, int f1, int f2, int nl, int D, int pair_cap,
              int items1, int items0, int small_cap, int promo_rows,
              int out_words, void* scratch, void* words, void* byte_lens,
              void* counts, void* sizes, void* flags, void* stream) {
  const x3::Caps caps =
      make_caps(D, pair_cap, items1, items0, small_cap, promo_rows, out_words);
  const x3::Params prm{T, W, f1, f2, nl};
  encoder_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)text, (const int32_t*)tlen, tb, prm, caps,
      x3::make_layout(caps), (int32_t*)scratch, (uint32_t*)words,
      (int32_t*)byte_lens, (int32_t*)counts, (float*)sizes, (int32_t*)flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
