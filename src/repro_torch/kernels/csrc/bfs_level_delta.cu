// A bitmap BFS level's delta for Hopper (sm_90a): one launch a level, after
// the relax.
//
// Replaces: no TPU kernel.  The JAX engine's level body
//   (src/repro/core/hybrid_bfs.py `_run_bitmap_impl`) computes the delta
//   `newly = (parent != V) & (old parent == V)` with plain jnp, packs it
//   (`_pack_delta_words`), fills the level and sums the delta's degrees,
//   which XLA fuses; eager PyTorch ran it as ~30 single launches over V, an
//   int64 [W, 32] shift-and-sum among them.
//
// Vertex v is found this level when parent[v] != V and its visited bit is
// clear: at the start of a level visited holds exactly the vertices whose
// parent is not V (the root; then each level adds its found), and neither
// relax nor the core step writes a visited vertex's parent or a V, so the
// bitmap stands in for the snapshot of parent taken before the relax.  One
// pass writes found[w] (every word), level[v] = next_level for the found
// vertices, and into acc the sum of their degrees (m_next) and of found's
// popcounts.
//
// What bounds it on this card: device-memory bytes.  It reads the visited
//   words, the parents of the unvisited vertices and the found vertices'
//   degrees, and writes the found words and levels: at scale 22 at most
//   about 17 MB, 5 us at 3.35 TB/s, near a launch's cost.
//
// What the design does about it: a warp takes a bitmap word, a lane a
//   vertex; the word is the warp's ballot, so no shift-and-sum and no
//   intermediate [V] array.  A lane whose visited bit is set reads no parent,
//   so a level late in the search reads little of parent.  The degree sum
//   and the popcount go to acc through bfs_level.cuh's ticket: one launch,
//   no memset.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
#include <cstdint>
#include <cuda_runtime.h>

#include "bfs_level.cuh"

namespace {

using namespace bfs_level;

__global__ void __launch_bounds__(kThreads)
level_delta_kernel(const int* __restrict__ parent, const unsigned* __restrict__ visited,
                   const int* __restrict__ degree, int* __restrict__ level, int next_level,
                   unsigned* __restrict__ found, int64_t n_vertices, int64_t n_words,
                   int* __restrict__ acc, unsigned* __restrict__ scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sentinel = static_cast<int>(n_vertices);
  unsigned deg = 0, pc = 0;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp; w < n_words;
       w += static_cast<int64_t>(gridDim.x) * kWarps) {
    const unsigned vis = __ldg(visited + w);
    const int64_t v = 32 * w + lane;
    const bool newly = v < n_vertices && !((vis >> lane) & 1u) && __ldg(parent + v) != sentinel;
    const unsigned word = __ballot_sync(kFull, newly);
    if (newly) {
      level[v] = next_level;
      deg += static_cast<unsigned>(__ldg(degree + v));
    }
    if (lane == 0) {
      found[w] = word;
      pc += __popc(word);
    }
  }
  __shared__ unsigned s_deg[kWarps], s_pc[kWarps];
  deg = __reduce_add_sync(kFull, deg);
  if (lane == 0) {
    s_deg[warp] = deg;
    s_pc[warp] = pc;
  }
  __syncthreads();
  unsigned* ticket = scratch;
  unsigned* slots = scratch + 1;
  if (warp == 0) {
    unsigned d = lane < kWarps ? s_deg[lane] : 0u, p = lane < kWarps ? s_pc[lane] : 0u;
    d = __reduce_add_sync(kFull, d);
    p = __reduce_add_sync(kFull, p);
    if (lane == 0) {
      slots[2 * blockIdx.x] = d;
      slots[2 * blockIdx.x + 1] = p;
    }
  }
  if (last_block(ticket, gridDim.x) && warp == 0) {
    unsigned d = 0, p = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32) {
      d += __ldcg(slots + 2 * b);
      p += __ldcg(slots + 2 * b + 1);
    }
    d = __reduce_add_sync(kFull, d);
    p = __reduce_add_sync(kFull, p);
    if (lane == 0) {
      acc[kAccMNext] = static_cast<int>(d);
      acc[kAccFound] = static_cast<int>(p);
      *ticket = 0u;
    }
  }
}

}  // namespace

// parent int32 [n_vertices + 1] (sentinel n_vertices), visited and found
// int32 [n_words] bitmaps (n_words >= ceil(n_vertices / 32)), degree and level
// int32 [n_vertices], acc int32 [6]; scratch 1 + 2 * kMaxBlocks words, the
// first (the ticket) 0.
extern "C" int level_delta_launch(const void* parent, const void* visited, const void* degree,
                                  void* level, int next_level, void* found, void* acc,
                                  void* scratch, int64_t n_vertices, int64_t n_words,
                                  void* stream) {
  level_delta_kernel<<<grid_for(n_words, kWarps), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parent), static_cast<const unsigned*>(visited),
      static_cast<const int*>(degree), static_cast<int*>(level), next_level,
      static_cast<unsigned*>(found), n_vertices, n_words, static_cast<int*>(acc),
      static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
