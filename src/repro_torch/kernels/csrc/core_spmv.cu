// Bottom-up BFS step over the dense heavy-vertex core for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `core_spmv` / `_make_kernel` in
//   src/repro/kernels/frontier_spmv.py (pallas_call at line 74).  For each
//   row i of the packed Boolean core A[K, W] (W = K / 32 uint32 words) it
//   returns the least column j with bit j set in both A[i] and the frontier
//   bitmap f[W], or BIG = 2^30 when there is none:  a Boolean-semiring
//   mat-vec with argmin-bit extraction.
//
// What bounds it on this card: device-memory bytes.  A row's answer needs
//   its words up to the first that hits the frontier, or all W of them when
//   none does; the rest of the row cannot change it, since every later word
//   holds only larger columns.  Over a bottom-up level that need runs from
//   almost nothing (a dense frontier: nearly every row hits in its first
//   words) to the whole core, K * W * 4 bytes (5.0 GB at Graph500 scale 22,
//   K = 200,704: 1.50 ms at 3.35 TB/s; 472 MB at scale 20), when no row
//   hits.  A handful of integer operations a word never binds.  The
//   frontier (W words, 25 KB at scale 22) stays in L1/L2.
//
// What the design does about it: one warp owns one row, and a block holds
//   `rows_per_block` warps.  The lanes stride the row with 16-byte loads
//   (uint4), so a warp reads 512 contiguous bytes per step, fully
//   coalesced, with the streaming hint (`__ldcs`: no word of A is read
//   twice in a launch).  The steps go in groups of kGroupSteps: each lane
//   issues the group's loads before it tests any of them, so a warp keeps
//   kGroupSteps * 512 bytes in flight, and after each group the warp votes
//   (`__any_sync`).  At the first group with a hit the warp takes the least
//   candidate (`__reduce_min_sync`: per word, hits = a & f and the
//   candidate is word * 32 + __ffs(hits) - 1), writes it and stops reading
//   the row; the least column lies in that group, so the answer is the one
//   a read of the whole row gives.  A row with no hit reads every word.  So
//   a launch reads what its answer needs, rounded up to a group a row
//   (kGroupSteps * 128 words), and one algorithm covers both ends: with no
//   hit at all (a late bottom-up level) it streams the whole core at the
//   rate of a plain strided loop.  A block retires when its slowest row
//   ends and the next block takes its slot: at scale 22 on an H100, blocks
//   of 1, 8 and 32 warps ran at the same speed, and a persistent grid whose
//   warps stride over the rows ran 2-4% slower.  All offsets are 64-bit:
//   row * W passes 2^31 once K exceeds about 2.6e5.
//
// Counter: when `words_read` is not null, each block adds once the words its
//   warps read (whole groups, clipped to W), for the bottom-up level's read
//   share; the plain version (ref.core_spmv_ref) counts by the same rule.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success),
// or cudaErrorInvalidValue when `group_steps` is not kGroupSteps (the
// wrapper passes the constant its plain version counts with).  The caller
// guarantees w % 4 == 0, 16-byte aligned pointers and
// 1 <= rows_per_block <= 32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kGroupSteps = 2;                 // ref.CORE_GROUP_STEPS
constexpr int kGroupVecs = 32 * kGroupSteps;   // uint4 loads a warp issues a group

// This lane's least candidate in the group of vectors starting at j0, kBig
// when it has none; kTail masks the vectors past the row's end.
template <bool kTail>
__device__ __forceinline__ int group_least(const uint4* __restrict__ arow,
                                           const uint4* __restrict__ f, int64_t j0,
                                           int64_t w_vec, int lane) {
  uint4 av[kGroupSteps], fv[kGroupSteps];
#pragma unroll
  for (int u = 0; u < kGroupSteps; ++u) {
    const int64_t j = j0 + u * 32 + lane;
    if (!kTail || j < w_vec) {
      av[u] = __ldcs(arow + j);
      fv[u] = __ldg(f + j);
    } else {
      av[u] = fv[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the last assignment is the lane's first hit: its least candidate
  int best = kBig;
#pragma unroll
  for (int u = kGroupSteps - 1; u >= 0; --u) {
    const int64_t j = j0 + u * 32 + lane;
    const unsigned hits[4] = {av[u].x & fv[u].x, av[u].y & fv[u].y, av[u].z & fv[u].z,
                              av[u].w & fv[u].w};
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      if (hits[q] != 0u)
        best = static_cast<int>((j * 4 + q) * 32) + __ffs(static_cast<int>(hits[q])) - 1;
    }
  }
  return best;
}

__global__ void core_spmv_kernel(const uint4* __restrict__ a,
                                 const uint4* __restrict__ f,
                                 int* __restrict__ out,
                                 int64_t k, int64_t w_vec,
                                 unsigned long long* __restrict__ words_read) {
  __shared__ long long s_words[32];
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  long long words = 0;
  if (row < k) {  // uniform per warp
    const uint4* arow = a + row * w_vec;
    const int64_t whole = w_vec - w_vec % kGroupVecs;
    int best = kBig;
    int64_t j0 = 0;
    for (; j0 < whole; j0 += kGroupVecs) {
      best = group_least<false>(arow, f, j0, w_vec, lane);
      if (__any_sync(0xffffffffu, best < kBig)) break;
    }
    if (j0 == whole && whole < w_vec) best = group_least<true>(arow, f, j0, w_vec, lane);
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) out[row] = best;
    words = 4 * min(j0 + kGroupVecs, w_vec);
  }
  if (words_read == nullptr) return;  // uniform per launch
  if (lane == 0) s_words[threadIdx.x >> 5] = words;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) sum += s_words[i];
    atomicAdd(words_read, static_cast<unsigned long long>(sum));
  }
}

}  // namespace

extern "C" int core_spmv_launch(const void* a_core, const void* frontier,
                                void* out, int64_t k, int64_t w,
                                int rows_per_block, int group_steps,
                                void* words_read, void* stream) {
  if (group_steps != kGroupSteps) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (k + rows_per_block - 1) / rows_per_block;
  if (blocks > 0) {
    core_spmv_kernel<<<static_cast<unsigned>(blocks), 32 * rows_per_block, 0, s>>>(
        static_cast<const uint4*>(a_core), static_cast<const uint4*>(frontier),
        static_cast<int*>(out), k, w / 4,
        static_cast<unsigned long long*>(words_read));
  }
  return static_cast<int>(cudaGetLastError());
}
