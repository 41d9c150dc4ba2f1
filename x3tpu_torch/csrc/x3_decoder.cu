// K2: the x3 decoder kernel for Hopper (sm_90a).
//
// Replaces x3tpu/vm/kernel_dec.py:decoder_kernel (built by
// build_decoder_call, pallas_call at kernel_dec.py:1395), the Pallas
// codec-VM decoder.  One launch decodes a whole wave: one CTA of kThreads
// per lane (one independent stream), running x3_dec_core.cuh's
// decode_lane from the first event to EOF.
//
// What bounds it on this card: one serial chain per lane.  Every AC step
// needs the previous one's interval and bit position, and every event the
// previous one's models, context rows and dictionary ranks, so a lane is
// bound by the latency of that chain, not by bytes or operations: it
// reads its stream once and writes its block once.  A wave takes its
// slowest lane's time.
//
// What the design does about it: it keeps on the chain only what feeds
// the AC state, on one warp, and gives every other job a warp of its own
// that works beside it (the TPU kernel overlapped row DMAs with the chain
// the same way).  Which warp owns which table:
// - warp 0 (the leader's warp): the AC decoder and the bit source (in
//   registers, the next stream word loaded ahead), the event, length and
//   char models (registers: the length model one entry a lane, the char
//   model eight, each searched by a warp scan and a ballot), the output
//   position and the E_NEW and E_EOF size estimates.  It searches the
//   payload in the row its family's warp prepared (a ballot over chunk
//   bases, then one scan) or in the index model, and posts the event as a
//   job into a ring of 16 in shared memory;
// - warp 1: context family 1 (ctx1 rows and hub, pair ids, the pair count
//   and OF_PAIRS, OF_CTX1).  Per hit: the tag's item (the decoded
//   position when the event came from its row, else a find by ballots),
//   the next event's ctx0 id (told before the update: the item's pair,
//   the new pair where the row keeps the append, else 0; a search in the
//   hub only after a literal), the next ctx1 row (view, total, chunk
//   bases), then the update;
// - warp 2: context family 0 (ctx0 rows and hub, OF_CTX0): the same find,
//   the next ctx0 row from warp 1's id, then the update;
// - warp 3: the recency planes and the index model (rank_of, tag_of: an
//   MTF to rank r shifts ranks 0..r-1; the index model as an inclusive
//   cumulative sum, searched by a 32-ary descent), then the hit's output
//   bytes and the hits' size estimates;
// - warps 4-7 and all of the above: a literal (E_NEW, 3 % of events): the
//   duplicate probe over the dictionary, the insert and its rank shift,
//   its bytes, between two CTA barriers.
// Every other hand-off is a counter in shared memory with one writer
// (st.release / ld.acquire): a ring slot, a prepared row, the dictionary
// warp's last job, warp 1's id.  A lane's end (EOF, OF_OUT, OF_CORRUPT,
// the event bound) is a job every warp takes and leaves on.  Every table
// lives in the zeroed global scratch, with the seeds written in where
// there are seeds (every plane in shared memory measured no faster: L1
// holds a lane's hot planes, and the carve-out shrinks it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: the size
// estimates round as C floats do).

#include <cuda_runtime.h>

#include "x3_dec_core.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads % 32 == 0 && kThreads >= 32 * x3::W_JOBS &&
                  kThreads <= 32 * x3::NW_MAX,
              "whole warps, one a role at least");

// kWarm: every lane from the warm counts (x3_dec_core.cuh decode_lane).
template <bool kWarm>
__global__ void __launch_bounds__(kThreads)
decoder_kernel(const uint32_t* __restrict__ words,
               const int32_t* __restrict__ byte_lens, int iw, int block_bytes,
               x3::Layout lay, int seeds, x3::WarmN warm, int32_t* scratch,
               uint8_t* out,
               int32_t* out_lens, int32_t* counts, float* sizes,
               int32_t* flags, long long* phases) {
  __shared__ x3::DecShared sh;
  const int64_t lane = blockIdx.x;
  x3::DecIO io;
  io.words = words + lane * iw;
  io.nbytes = byte_lens[lane];
  io.iw = iw;
  io.seeds = seeds;
  io.warm = warm;
  io.scr = scratch + lane * lay.words;
  io.out = out + lane * block_bytes;
  io.block_bytes = block_bytes;
  io.out_len = out_lens + lane;
  io.counts = counts + lane * x3::E_LAST;
  io.sizes = sizes + lane * x3::E_LAST;
  io.flags = flags + lane;
  io.phases = phases ? phases + lane * x3::PHD_SLOTS : nullptr;
  x3::ParDev par;
  par.scratch = &sh.red[0][0];
  par.n = kThreads;
  x3::decode_lane<kWarm>(par, lay, io, sh);
}

}  // namespace

extern "C" {

// K2's registers a thread, static shared memory and local (spill) bytes a
// thread, as the loaded module has them: out [3].
int x3_decoder_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, decoder_kernel<false>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  return (int)rc;
}

// Decode `lanes` streams on `stream`.  All pointers are device memory:
// words u32 [lanes, iw], byte_lens i32 [lanes], scratch i32 [lanes,
// x3_scratch_words(...)] and out u8 [lanes, block_bytes] zeroed, out_lens
// i32 [lanes], counts i32 [lanes, 5], sizes f32 [lanes, 5], flags i32
// [lanes].  seeds: K, the dictionary seeds the scratch holds (x3_core.cuh
// seed_dict, ix as their cumulative sum), 0 for none; pair_n, hub0_n,
// hub1_n: the counts of the warm tables the scratch holds
// (x3tpu_torch/vm/driver.py warm_scratch), 0 without warm start (any
// other launches the kernel's warm instantiation).  Returns
// cudaGetLastError() after the launch.
int x3_decode(const void* words, const void* byte_lens, int lanes, int iw,
              int block_bytes, int D, int pair_cap, int items1, int items0,
              int small_cap, int promo_rows, int seeds, int pair_n,
              int hub0_n, int hub1_n, void* scratch, void* out,
              void* out_lens, void* counts, void* sizes, void* flags,
              void* stream
#ifdef X3_DEC_PHASES
              , void* phases  // i64 [lanes, PHD_SLOTS] (tools/k2_phases.py)
#endif
              ) {
#ifndef X3_DEC_PHASES
  void* phases = nullptr;
#endif
  const x3::Caps caps{D, pair_cap, items1, items0, small_cap, promo_rows, 0};
  const x3::WarmN warm{pair_n, {hub0_n, hub1_n}};
  const auto kernel = warm.any() ? decoder_kernel<true> : decoder_kernel<false>;
  kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)byte_lens, iw, block_bytes,
      x3::make_layout(caps), seeds, warm, (int32_t*)scratch, (uint8_t*)out,
      (int32_t*)out_lens, (int32_t*)counts, (float*)sizes, (int32_t*)flags,
      (long long*)phases);
  return (int)cudaGetLastError();
}

}  // extern "C"
