// K1: the x3 encoder kernel for Hopper (sm_90a).
//
// Replaces x3tpu/vm/kernel.py:encoder_kernel, the Pallas codec-VM encoder.
// One launch encodes a whole wave: one CTA per lane (one independent
// block), kThreads workers running x3_core.cuh's encode_lane from the first
// event to EOF and one coder warp running code_lane.
//
// What bounds it on this card: one serial chain of events per lane, each
// event a chain of dependent steps (probe and scan -> sweep -> the hit's
// context rows -> mode choice -> AC coding -> updates), so a lane is bound
// by latency, not by bytes or operations: it reads its block once and
// writes its stream once.  A wave takes its slowest lane's time.
//
// What the design does about it: it shortens the per-event chain.
// - Barriers: a hit takes three, a literal two: pass 1 (the previous
//   event's rank update, the probe and the window scan, one reduction
//   round carrying the probe's OR and MAX), pass 2 (a hit's ctx0 row, ctx1
//   row and index model on separate warps at once, each with its mode's
//   probability) and the end of the leader's chain; every warp derives
//   the sweep from per-warp histograms without one.
// - The index model is a Fenwick tree beside its plain freqs: a hit's
//   interval is one round of at most log2(D) + 1 loads, a node a lane,
//   where a sum reads every live entry (up to 11 000 at 1 MiB), and the
//   event's gain is the next pass 1's, on the hash index's warp.
// - Compares are word-wide: dictionary entries as eight u32 words, window
//   positions four at a time with a byte compare of their first byte.
// - The leader's chain is short: it picks the mode and pushes the AC
//   symbols into a shared-memory queue; a coder warp of its own codes
//   them, with its state and the word it fills in registers (each output
//   word stored once, never read back); a hit's context updates wait for
//   the next pass 1, beside the probe and the scan; idle warps compute the
//   char and length models' prefix sums and the literal bytes' duplicate
//   corrections before the leader needs them.
// - The lane's hot planes (text row, dictionary strings, lengths, ranks
//   and index model, both hubs, the ctx1 row maps, the index model's
//   tree) live in the CTA's dynamic shared memory where the launch's plan
//   puts them (x3tpu_torch/vm/driver.py smem_plan); the rest stays in the
//   zeroed global scratch, reached by the same code through a pointer.  A
//   seeded launch (the wrapper writes the dictionary seeds and, for a
//   warm start, the warm context tables into the scratch) copies its
//   planes into shared memory once, at the lane's start, and nothing per
//   event.
// - The dictionary has a hash index in the lane's scratch: one warp
//   answers the probe in 32 lookups, one a candidate length, and each
//   warp a veto's in its own 32 with no barrier, where a scan reads every
//   live entry (up to 11 000 at 1 MiB, 768 KiB of strings a lane, far
//   more than L1 holds; at 16 KiB the scan of about 230 entries in shared
//   memory was no faster).
// - 512 worker threads: the scan's share of a thread halves against 256
//   (992 workers, 1024 threads in all, measured slower).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: the mode
// choice compares f32 products of quotients and must round as C does).

#include <cuda_runtime.h>

#include "x3_core.cuh"

namespace {

constexpr int kThreads = 512;  // the CTA's workers; the coder warp is extra
static_assert(kThreads % 32 == 0 && kThreads >= 256 &&
                  kThreads + 32 <= 32 * x3::NW_MAX,
              "whole warps, at least one thread a char-model entry");
static_assert(sizeof(x3::Lane) + sizeof(x3::Shared) <= x3::SMEM_STATIC,
              "the plan's budget assumes at most SMEM_STATIC static bytes");

// kWarm: every lane from the warm counts (x3_core.cuh encode_lane).
template <bool kWarm>
__global__ void __launch_bounds__(kThreads + 32)
encoder_kernel(const uint8_t* __restrict__ text, const int32_t* __restrict__ tlen,
               int64_t tb, x3::Params prm, x3::Caps caps, x3::Layout lay,
               int seeds, x3::WarmN warm, int32_t* scratch, uint32_t* words,
               int32_t* byte_lens, int32_t* counts, float* sizes,
               int32_t* flags, long long* phases) {
  __shared__ x3::Lane R;
  __shared__ x3::Shared sh;
  extern __shared__ __align__(16) uint8_t planes[];
  const int64_t lane = blockIdx.x;
  x3::LaneIO io;
  io.text = text + lane * tb;
  io.tb = tb;
  io.tlen = tlen[lane];
  io.seeds = seeds;
  io.warm = warm;
  io.scr = scratch + lane * (lay.words + x3::hash_slots(lay.D) +
                             x3::ix_tree_words(lay.D));
  io.smem = planes;
  io.words = words + lane * caps.out_words;
  io.byte_len = byte_lens + lane;
  io.counts = counts + lane * x3::E_LAST;
  io.sizes = sizes + lane * x3::E_LAST;
  io.flags = flags + lane;
  io.phases = phases ? phases + lane * x3::PH_SLOTS : nullptr;
  if (threadIdx.x == 0) sh.q.head = sh.q.tail = sh.q.done = 0;
  __syncthreads();
  if (threadIdx.x >= kThreads) {  // the coder warp: one lane codes
    if (threadIdx.x == kThreads)
      x3::code_lane(sh.q, io.words, caps.out_words, io.byte_len, io.flags);
    return;
  }
  x3::ParDev par;
  par.scratch = &sh.red[0][0];
  par.n = kThreads;
  x3::encode_lane<kWarm>(par, prm, caps, lay, io, R, sh);
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

// Offsets, in int32 words of a lane's scratch, of the dictionary planes
// a seeded start writes: out [5] = strs, lens, rank_of, tag_of, ix.
void x3_dict_layout(int D, int pair_cap, int items1, int items0,
                    int small_cap, int promo_rows, long long* out) {
  const x3::Layout lay = x3::make_layout(
      make_caps(D, pair_cap, items1, items0, small_cap, promo_rows, 0));
  out[0] = lay.strs;
  out[1] = lay.lens;
  out[2] = lay.rank_of;
  out[3] = lay.tag_of;
  out[4] = lay.ix;
}

// Offsets, in int32 words of a lane's scratch, of context family fam's
// planes (0: ctx0, 1: ctx1), the ones a warm start writes among them: out
// [12] in x3_core.cuh fam_offsets' order.
void x3_fam_layout(int D, int pair_cap, int items1, int items0,
                   int small_cap, int promo_rows, int fam, long long* out) {
  const x3::Layout lay = x3::make_layout(
      make_caps(D, pair_cap, items1, items0, small_cap, promo_rows, 0));
  x3::fam_offsets(fam ? lay.f1 : lay.f0, out);
}

// int32 words of K1's hash index a lane's scratch holds after the
// x3_scratch_words of the layout, at dictionary size D.
long long x3_hash_slots(int D) { return x3::hash_slots(D); }

// int32 words of K1's index model tree a lane's scratch holds after the
// hash index, at dictionary size D.
long long x3_ix_tree_words(int D) { return x3::ix_tree_words(D); }

// K1's registers a thread, static shared memory and local (spill) bytes a
// thread, as the loaded module has them, of its unwarmed instantiation
// (warm 0) or its warm one: out [3].
int x3_encoder_info(int warm, int* out) {
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(
      &a, warm ? encoder_kernel<true> : encoder_kernel<false>);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  return (int)rc;
}

// Encode `lanes` blocks on `stream`.  All pointers are device memory:
// text u8 [lanes, tb], tlen i32 [lanes], scratch i32 [lanes,
// scratch_words + x3_hash_slots(D) + x3_ix_tree_words(D)] and words u32
// [lanes, out_words] zeroed, byte_lens i32 [lanes], counts i32 [lanes,
// 5], sizes f32 [lanes, 5], flags i32 [lanes].  smem_mask: the planes
// (x3_core.cuh PL_*) that live in shared memory; seeds: K, the
// dictionary seeds the scratch holds (x3_core.cuh seed_dict, ix as
// freqs), 0 for none; pair_n, hub0_n, hub1_n: the counts of the warm
// tables the scratch holds (x3tpu_torch/vm/driver.py warm_scratch), 0
// without warm start (any other launches the kernel's warm
// instantiation).  Returns
// cudaErrorInvalidValue when they need more than a block may have or D is
// past HASH_DICT_MAX, else cudaGetLastError() after the launch.
int x3_encode(const void* text, const void* tlen, int lanes, long long tb,
              int T, int W, int f1, int f2, int nl, int D, int pair_cap,
              int items1, int items0, int small_cap, int promo_rows,
              int out_words, unsigned smem_mask, int seeds, int pair_n,
              int hub0_n, int hub1_n, void* scratch, void* words,
              void* byte_lens, void* counts, void* sizes, void* flags,
              void* stream
#ifdef X3_PHASES
              , void* phases  // i64 [lanes, PH_SLOTS] (tools/k1_phases.py)
#endif
              ) {
#ifndef X3_PHASES
  void* phases = nullptr;
#endif
  const x3::Caps caps =
      make_caps(D, pair_cap, items1, items0, small_cap, promo_rows, out_words);
  const x3::Params prm{T, W, f1, f2, nl};
  x3::Layout lay = x3::make_layout(caps);
  x3::place_smem(lay, tb, smem_mask);
  if (lay.smem_bytes > x3::SMEM_BLOCK_MAX - x3::SMEM_STATIC)
    return (int)cudaErrorInvalidValue;
  const x3::WarmN warm{pair_n, {hub0_n, hub1_n}};
  if (D > x3::HASH_DICT_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel = warm.any() ? encoder_kernel<true> : encoder_kernel<false>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<lanes, kThreads + 32, lay.smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)text, (const int32_t*)tlen, tb, prm, caps, lay, seeds,
      warm, (int32_t*)scratch, (uint32_t*)words, (int32_t*)byte_lens,
      (int32_t*)counts, (float*)sizes, (int32_t*)flags, (long long*)phases);
  return (int)cudaGetLastError();
}

}  // extern "C"
