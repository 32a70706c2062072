// A top-down bitmap BFS level's live-chunk count for Hopper (sm_90a): one
// launch a top-down level, before the relax.
//
// Replaces: no TPU kernel.  The JAX engine's top-down level
//   (src/repro/core/hybrid_bfs.py `_run_bitmap_impl`, `chunk_frontier_mask`)
//   relaxes the chunks whose source range meets the frontier and records
//   their count in the `scanned_chunks` stat; the port's relax reads rows,
//   not chunks, so the count serves the stat alone, and eager PyTorch read
//   it back to the host (~12 launches and a synchronisation a level).
//
// Chunk c is live when a frontier word in [src_lo[c] / 32, src_hi[c] / 32]
// (floor division, clamped into the bitmap) is nonzero and src_lo[c] <=
// src_hi[c]: the word-granular test of kernels/ref.py `chunk_range_mask`.
// The count goes into stats_ch[lvl] on the device.
//
// What bounds it on this card: device-memory bytes, the frontier words the
//   ranges cover (together about the bitmap once: 0.5 MB at scale 22, 0.16 us
//   at 3.35 TB/s), far below a launch.
//
// What the design does about it: a chunk's word range is split over kParts
//   blocks (degree-sorted rows make the last chunks' ranges the longest), each
//   block ORs its words and writes a flag; the last block of bfs_level.cuh's
//   ticket counts the chunks with a flag set.  One launch, no memset.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
#include <cstdint>
#include <cuda_runtime.h>

#include "bfs_level.cuh"

namespace {

using namespace bfs_level;

constexpr int kParts = 8;   // blocks a chunk's word range is split over

// The bitmap word of vertex x: floor division by 32 (an arithmetic shift),
// clamped into [0, n_words - 1].
__device__ __forceinline__ int64_t word_of(int x, int64_t n_words) {
  const int64_t w = x >> 5;
  return w < 0 ? 0 : (w >= n_words ? n_words - 1 : w);
}

__global__ void __launch_bounds__(kThreads)
live_chunks_kernel(const unsigned* __restrict__ frontier, int64_t n_words,
                   const int* __restrict__ src_lo, const int* __restrict__ src_hi,
                   int* __restrict__ out, unsigned* __restrict__ scratch) {
  const int c = blockIdx.x, part = blockIdx.y;
  const int lo = __ldg(src_lo + c), hi = __ldg(src_hi + c);
  unsigned nz = 0;
  if (hi >= lo) {
    const int64_t a = word_of(lo, n_words), b = word_of(hi, n_words);
    const int64_t len = b - a + 1;
    const int64_t end = a + len * (part + 1) / kParts;
    for (int64_t i = a + len * part / kParts + threadIdx.x; i < end; i += kThreads)
      nz |= __ldg(frontier + i);
  }
  const int live = __syncthreads_or(nz != 0u);
  unsigned* ticket = scratch;
  unsigned* slots = scratch + 1;
  if (threadIdx.x == 0) slots[c * kParts + part] = static_cast<unsigned>(live);
  if (last_block(ticket, gridDim.x * gridDim.y) && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned n = 0;
    for (unsigned ch = lane; ch < gridDim.x; ch += 32) {
      unsigned any = 0;
#pragma unroll
      for (int p = 0; p < kParts; ++p) any |= __ldcg(slots + ch * kParts + p);
      n += any != 0u;
    }
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) {
      *out = static_cast<int>(n);
      *ticket = 0u;
    }
  }
}

}  // namespace

// frontier int32 [n_words], src_lo and src_hi int32 [n_chunks] (n_chunks >=
// 1), out one int32; scratch 1 + kParts * n_chunks words, the first 0.
extern "C" int live_chunks_launch(const void* frontier, int64_t n_words, const void* src_lo,
                                  const void* src_hi, int n_chunks, void* out, void* scratch,
                                  void* stream) {
  live_chunks_kernel<<<dim3(static_cast<unsigned>(n_chunks), kParts), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(frontier), n_words, static_cast<const int*>(src_lo),
      static_cast<const int*>(src_hi), static_cast<int*>(out), static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
