// K2: the x3 decoder kernel for Hopper (sm_90a).
//
// Replaces x3tpu/vm/kernel_dec.py:decoder_kernel, the Pallas codec-VM
// decoder.  One launch decodes a whole wave: one CTA of 256 threads per
// lane (one independent stream), running x3_dec_core.cuh's decode_lane
// from the first event to EOF.
//
// What bounds it on this card: each event is a chain of dependent steps
// (AC decode of the event symbol -> payload or literal bytes -> context and
// dictionary updates -> output), and every AC step needs the previous
// one's interval and bit position, so a lane is latency-bound, not
// bandwidth- or FLOP-bound: it reads its stream once and writes its output
// once.  The design keeps the serial chain on one thread with the small
// models (event, length, char) in shared memory, and spreads the wide parts
// over the CTA's 256 threads with block reductions and scans: the
// duplicate probe of a new fragment (O(D)), the context-row finds and
// totals, the symbol search over a context row or the index model, and
// the rank updates.  Lanes run concurrently, one per SM.  Dictionary and
// context tables live in a zeroed global scratch the wrapper allocates
// (the encoder's layout, plus the rank -> tag map); capacities are run-time
// arguments, so a capacity retry relaunches with new sizes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: the size
// estimates round as C floats do).

#include <cuda_runtime.h>

#include "x3_dec_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
decoder_kernel(const uint32_t* __restrict__ words,
               const int32_t* __restrict__ byte_lens, int iw, int block_bytes,
               x3::Layout lay, int32_t* scratch, uint8_t* out,
               int32_t* out_lens, int32_t* counts, float* sizes,
               int32_t* flags) {
  __shared__ x3::Lane R;
  __shared__ x3::Shared sh;
  const int64_t lane = blockIdx.x;
  x3::DecIO io;
  io.words = words + lane * iw;
  io.nbytes = byte_lens[lane];
  io.iw = iw;
  io.scr = scratch + lane * lay.words;
  io.out = out + lane * block_bytes;
  io.block_bytes = block_bytes;
  io.out_len = out_lens + lane;
  io.counts = counts + lane * x3::E_LAST;
  io.sizes = sizes + lane * x3::E_LAST;
  io.flags = flags + lane;
  x3::ParDev par;
  par.scratch = &sh.red[0][0];
  par.n = kThreads;
  x3::decode_lane(par, lay, io, R, sh);
}

}  // namespace

extern "C" {

// Decode `lanes` streams on `stream`.  All pointers are device memory:
// words u32 [lanes, iw], byte_lens i32 [lanes], scratch i32 [lanes,
// x3_scratch_words(...)] and out u8 [lanes, block_bytes] zeroed, out_lens
// i32 [lanes], counts i32 [lanes, 5], sizes f32 [lanes, 5], flags i32
// [lanes].  Returns cudaGetLastError() after the launch.
int x3_decode(const void* words, const void* byte_lens, int lanes, int iw,
              int block_bytes, int D, int pair_cap, int items1, int items0,
              int small_cap, int promo_rows, void* scratch, void* out,
              void* out_lens, void* counts, void* sizes, void* flags,
              void* stream) {
  const x3::Caps caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0};
  decoder_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)byte_lens, iw, block_bytes,
      x3::make_layout(caps), (int32_t*)scratch, (uint8_t*)out,
      (int32_t*)out_lens, (int32_t*)counts, (float*)sizes, (int32_t*)flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
