// Bottom-up BFS step over the dense heavy-vertex core for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `core_spmv` / `_make_kernel` in
//   src/repro/kernels/frontier_spmv.py (pallas_call at line 74).  For each
//   row i of the packed Boolean core A[K, W] (W = K / 32 uint32 words) it
//   returns the least column j with bit j set in both A[i] and the frontier
//   bitmap f[W], or BIG = 2^30 when there is none:  a Boolean-semiring
//   mat-vec with argmin-bit extraction.
//
// What bounds it on this card: device-memory bytes.  A launch reads all of
//   A once, K * W * 4 bytes (about 472 MB at Graph500 scale 20, K = 61,440),
//   and does a handful of integer operations per word: ~0.14 ms at
//   3.35 TB/s.  The frontier (W words, 7.5 KB at scale 20) stays in L1/L2.
//
// What the design does about it: one warp owns one row, and a block holds
//   `rows_per_block` warps.  The lanes stride the row with 16-byte loads
//   (uint4), so a warp reads 512 contiguous bytes per step: the loads are
//   fully coalesced, and A is read with the streaming hint (`__ldcs`) since
//   no word of it is read twice in a launch.  Per word, hits = a & f and the
//   candidate is word * 32 + __ffs(hits) - 1; each lane keeps a running
//   minimum and the warp combines them with `__reduce_min_sync`.  The TPU
//   kernel's sequential word-tile grid axis with its revisited output block
//   becomes the loop inside the warp.  All offsets are 64-bit: row * W
//   passes 2^31 once K exceeds about 2.6e5.  There is no early exit yet.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
// The caller guarantees w % 4 == 0, 16-byte aligned pointers and
// 1 <= rows_per_block <= 32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;

__global__ void core_spmv_kernel(const uint4* __restrict__ a,
                                 const uint4* __restrict__ f,
                                 int* __restrict__ out,
                                 int64_t k, int64_t w_vec) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= k) return;  // uniform per warp: the whole warp leaves together
  const uint4* arow = a + row * w_vec;
  int best = kBig;
  for (int64_t j = lane; j < w_vec; j += 32) {
    const uint4 av = __ldcs(arow + j);
    const uint4 fv = __ldg(f + j);
    const unsigned hits[4] = {av.x & fv.x, av.y & fv.y, av.z & fv.z,
                              av.w & fv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (hits[q] != 0u) {
        const int cand =
            static_cast<int>((j * 4 + q) * 32) + __ffs(static_cast<int>(hits[q])) - 1;
        best = min(best, cand);
      }
    }
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if (lane == 0) out[row] = best;
}

}  // namespace

extern "C" int core_spmv_launch(const void* a_core, const void* frontier,
                                void* out, int64_t k, int64_t w,
                                int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (k + rows_per_block - 1) / rows_per_block;
  if (blocks > 0) {
    core_spmv_kernel<<<static_cast<unsigned>(blocks), 32 * rows_per_block, 0, s>>>(
        static_cast<const uint4*>(a_core), static_cast<const uint4*>(frontier),
        static_cast<int*>(out), k, w / 4);
  }
  return static_cast<int>(cudaGetLastError());
}
