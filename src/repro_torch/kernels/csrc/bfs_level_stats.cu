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
//
// What bounds it on this card: device-memory bytes, two bitmaps (8 B a
//   word: 1 MB at scale 22, 0.3 us at 3.35 TB/s), far below a launch.
//
// What the design does about it: a grid-stride OR of next & visited, each
//   block's flag through bfs_level.cuh's ticket; the last block writes the
//   level's stats and rolls acc on.  One launch, no memset, nothing the host
//   reads.
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
                   int in_count, int n_chunks, unsigned* __restrict__ scratch) {
  unsigned both = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_words;
       i += static_cast<int64_t>(gridDim.x) * kThreads)
    both |= __ldg(next + i) & __ldg(visited + i);
  const int any = __syncthreads_or(both != 0u);
  unsigned* ticket = scratch;
  unsigned* slots = scratch + 1;
  if (threadIdx.x == 0) slots[blockIdx.x] = static_cast<unsigned>(any);
  if (last_block(ticket, gridDim.x) && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned a = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32) a |= __ldcg(slots + b);
    a = __reduce_or_sync(kFull, a);
    if (lane == 0) {
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
// scanned edges); bottom_up 1 or 0, the direction written; scratch
// 1 + kMaxBlocks words, the first (the ticket) 0.
extern "C" int level_stats_launch(const void* next, const void* visited, const void* count,
                                  void* acc, void* stats, int64_t max_levels, int64_t lvl,
                                  int bottom_up, int in_count, int n_chunks, void* scratch,
                                  int64_t n_words, void* stream) {
  level_stats_kernel<<<grid_for(n_words, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(next), static_cast<const unsigned*>(visited), n_words,
      static_cast<const int*>(count), static_cast<int*>(acc), static_cast<int*>(stats),
      max_levels, lvl, bottom_up, in_count, n_chunks, static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
