// A bitmap BFS level's sentinels and stats for Hopper (sm_90a): one launch
// a level, right after frontier_update.
//
// Replaces: no TPU kernel.  The JAX engine's level body
//   (src/repro/core/hybrid_bfs.py `_run_bitmap_impl`) writes the sentinels
//   (delta conservation, frontier and old visited disjoint, level within
//   bound), the scanned-edge estimate and the chunk count into its stats and
//   carries the frontier's and the visited set's degree sums, with plain jnp;
//   eager PyTorch ran two SWAR popcounts of ~14 launches each and wrote
//   three stats from host ints, each a synchronising copy.
//
// It reads frontier_update's real output (next, count), the level's old
// visited bitmap and acc (the delta's degree sum and popcount), and writes
// the level's column: the direction and the frontier size, which the host
// passes as arguments (so no copy crosses the bus), the sentinel
// (count == popcount(found)) + 2 (next & old visited == 0) + 4 (lvl + 1 <=
// max_levels), the scanned edges (m_f top-down, nnz - deg_vis bottom-up) and
// a bottom-up level's n_chunks (a top-down level's scanned chunks come from
// bfs_live_chunks.cu); then m_f = m_next, deg_vis += m_next, levels = lvl + 1.
// Given the dense core's row bound core_rows = min(K, V) and an output slot,
// it also counts the core rows left unvisited after the level,
// popcount(~(next | visited)) over the first ceil(core_rows / 32) words with
// the tail word masked at core_rows, into that slot: the host reads it back
// with the frontier's size and skips a bottom-up level's core step when it
// is 0, since the core merge would write nothing.
//
// What bounds it on this card: device-memory bytes, two bitmaps (8 B a
//   word: 1 MB at scale 22, 0.3 us at 3.35 TB/s), far below a launch.
//
// What the design does about it: a grid-stride OR of next & visited and a
//   popcount of the core's unvisited rows in the same pass over the words,
//   each block's flag and count through bfs_level.cuh's ticket; the last
//   block writes the level's stats and the count and rolls acc on.  One
//   launch, no memset; the count lands beside frontier_update's, in the
//   level's one readback.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
#include <cstdint>
#include <cuda_runtime.h>

#include "bfs_level.cuh"

namespace {

using namespace bfs_level;

__global__ void __launch_bounds__(kThreads)
level_stats_kernel(const unsigned* __restrict__ next, const unsigned* __restrict__ visited,
                   int64_t n_words, const int* __restrict__ count, int* __restrict__ acc,
                   int* __restrict__ stats, int64_t max_levels, int64_t lvl, int bottom_up,
                   int in_count, int n_chunks, int64_t core_rows, int* __restrict__ unvisited,
                   unsigned* __restrict__ scratch) {
  __shared__ unsigned warp_free[kWarps];
  const int64_t core_words = (core_rows + 31) / 32;
  const unsigned tail = (core_rows & 31) ? (1u << (core_rows & 31)) - 1u : kFull;
  unsigned both = 0, free_rows = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_words;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const unsigned n = __ldg(next + i), v = __ldg(visited + i);
    both |= n & v;
    if (i < core_words) free_rows += __popc(~(n | v) & (i == core_words - 1 ? tail : kFull));
  }
  free_rows = __reduce_add_sync(kFull, free_rows);
  if ((threadIdx.x & 31) == 0) warp_free[threadIdx.x / 32] = free_rows;
  const int any = __syncthreads_or(both != 0u);
  unsigned* ticket = scratch;
  unsigned* slots = scratch + 1;           // a block's flag
  unsigned* free_slots = slots + kMaxBlocks;  // a block's unvisited core rows
  if (threadIdx.x == 0) {
    unsigned block_free = 0;
    for (int w = 0; w < kWarps; ++w) block_free += warp_free[w];
    slots[blockIdx.x] = static_cast<unsigned>(any);
    free_slots[blockIdx.x] = block_free;
  }
  if (last_block(ticket, gridDim.x) && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned a = 0, rows = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32) {
      a |= __ldcg(slots + b);
      rows += __ldcg(free_slots + b);
    }
    a = __reduce_or_sync(kFull, a);
    rows = __reduce_add_sync(kFull, rows);
    if (lane == 0) {
      if (unvisited != nullptr) *unvisited = static_cast<int>(rows);
      const int s1 = *count == acc[kAccFound];
      const int s2 = a == 0u;
      const int s3 = lvl + 1 <= max_levels;
      const unsigned m_next = static_cast<unsigned>(acc[kAccMNext]);
      const unsigned deg_vis = static_cast<unsigned>(acc[kAccDegVis]);
      stats[kStatsDir * max_levels + lvl] = bottom_up;
      stats[kStatsFs * max_levels + lvl] = in_count;
      stats[kStatsOk * max_levels + lvl] = s1 + 2 * s2 + 4 * s3;
      stats[kStatsSe * max_levels + lvl] =
          bottom_up ? static_cast<int>(static_cast<unsigned>(acc[kAccNnz]) - deg_vis)
                    : acc[kAccMF];
      if (bottom_up) stats[kStatsCh * max_levels + lvl] = n_chunks;
      acc[kAccMF] = static_cast<int>(m_next);
      acc[kAccDegVis] = static_cast<int>(deg_vis + m_next);
      acc[kAccLevels] = static_cast<int>(lvl + 1);
      *ticket = 0u;
    }
  }
}

}  // namespace

// next and visited int32 [n_words], count int32 scalar, acc int32 [6], stats
// int32 [5, max_levels] (rows direction, chunks, sentinel, frontier size,
// scanned edges); bottom_up 1 or 0, the direction written; core_rows in
// [0, 32 n_words], the core rows counted into the int32 unvisited (none
// written when it is null); scratch 1 + 2 kMaxBlocks words, the first (the
// ticket) 0.
extern "C" int level_stats_launch(const void* next, const void* visited, const void* count,
                                  void* acc, void* stats, int64_t max_levels, int64_t lvl,
                                  int bottom_up, int in_count, int n_chunks, int64_t core_rows,
                                  void* unvisited, void* scratch, int64_t n_words,
                                  void* stream) {
  level_stats_kernel<<<grid_for(n_words, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(next), static_cast<const unsigned*>(visited), n_words,
      static_cast<const int*>(count), static_cast<int*>(acc), static_cast<int*>(stats),
      max_levels, lvl, bottom_up, in_count, n_chunks, core_rows, static_cast<int*>(unvisited),
      static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
