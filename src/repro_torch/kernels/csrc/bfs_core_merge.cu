// A bottom-up bitmap BFS level's core merge for Hopper (sm_90a): one launch
// a bottom-up level with a core, right after core_spmv.
//
// Replaces: no TPU kernel.  The JAX engine's core step
//   (src/repro/core/hybrid_bfs.py `_core_bottom_up_resident`) lets each
//   unvisited core row take core_spmv's candidate with a plain jnp
//   elementwise min on the parent prefix; eager PyTorch ran it as ~15 single
//   launches (arange, testbit's gather and shifts, where, minimum, copy).
//
// For i < rows = min(K, V): parent[i] = min(parent[i], cand[i] if cand[i] <
// BIG (a frontier neighbour was found) and i's visited bit is clear, else V)
// -- the torch chain's arithmetic exactly.  Row i's candidate lands on
// vertex i itself, so the rows are independent.
//
// What bounds it on this card: device-memory bytes, 12 B a row (a candidate
//   and a parent read, a parent written; the visited word is shared by 32
//   rows): 2.4 MB at scale 22's K = 200,704, 0.7 us at 3.35 TB/s.
//
// What the design does about it: a thread a row, coalesced, no branch on the
//   data but the predicated select.  One launch.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
#include <cstdint>
#include <cuda_runtime.h>

#include "bfs_level.cuh"

namespace {

using bfs_level::kThreads;

constexpr int kBig = 1 << 30;   // core_spmv's "no frontier neighbour" (ref.BIG)

__global__ void __launch_bounds__(kThreads)
core_merge_kernel(const int* __restrict__ cand, const unsigned* __restrict__ visited,
                  int* __restrict__ parent, int64_t rows, int sentinel) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows) return;
  const int c = __ldg(cand + i);
  const bool won = c < kBig && !((__ldg(visited + (i >> 5)) >> (i & 31)) & 1u);
  const int x = won ? c : sentinel;
  const int p = parent[i];
  parent[i] = p < x ? p : x;
}

}  // namespace

// cand int32 [>= rows], visited int32 [>= ceil(rows / 32)], parent int32
// [>= rows]; rows = min(K, V), sentinel V.
extern "C" int core_merge_launch(const void* cand, const void* visited, void* parent,
                                 int64_t rows, int sentinel, void* stream) {
  if (rows > 0)
    core_merge_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cand), static_cast<const unsigned*>(visited),
        static_cast<int*>(parent), rows, sentinel);
  return static_cast<int>(cudaGetLastError());
}
