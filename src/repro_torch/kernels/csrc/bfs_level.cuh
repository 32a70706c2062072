// Shared by the bitmap BFS level's bookkeeping kernels for Hopper (sm_90a):
// bfs_level_delta.cu, bfs_level_stats.cu, bfs_live_chunks.cu and
// bfs_core_merge.cu, the launches around a level's relax that keep on the
// device everything a level computes but the next frontier's size, which
// frontier_update counts and the host reads back for the direction switch,
// and the core rows left unvisited, which bfs_level_stats counts into the
// same readback.
//
// The level loop's int32 accumulator acc and its device stats
// [5, max_levels] have the slots and rows below (kernels/ref.py's ACC_* and
// STATS_*).
//
// A sum across blocks uses frontier_update.cu's ticket, so that no counter
// has to be zeroed before a launch (no memset): each block writes its slots
// in a scratch array, makes them visible and takes a ticket (atomicAdd on
// the scratch's first word); the block that draws the last one reads the
// slots in a fixed order, writes the result and sets the ticket back to 0.
// Stream order makes that safe, so the caller keeps one scratch per device
// and stream.  Every sum is modulo 2^32, as the int32 casts of the torch
// chain the kernels replace.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bfs_level {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;   // a grid-stride kernel's grid, at most
constexpr unsigned kFull = 0xffffffffu;

constexpr int kAccMF = 0, kAccDegVis = 1, kAccNnz = 2, kAccMNext = 3, kAccFound = 4,
              kAccLevels = 5;
constexpr int kStatsDir = 0, kStatsCh = 1, kStatsOk = 2, kStatsFs = 3, kStatsSe = 4;

// Thread 0 of a block has written the block's slots; it takes a ticket.
// Returns, in every thread of the block, whether the block drew the last of
// n_blocks (then its reads of the slots see every block's writes).
__device__ __forceinline__ bool last_block(unsigned* ticket, unsigned n_blocks) {
  int last = 0;
  if (threadIdx.x == 0) {
    __threadfence();  // the slots are visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == n_blocks - 1;
  }
  last = __syncthreads_or(last);
  if (last) __threadfence();
  return last;
}

// Blocks of a grid-stride kernel over `items`, `per_block` a block a pass.
inline unsigned grid_for(int64_t items, int64_t per_block) {
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace bfs_level
