// Fused frontier bitmap update for Hopper (sm_90a): one launch per call.
//
// Replaces: the Pallas TPU kernel `frontier_update` / `_frontier_update_kernel`
//   in src/repro/kernels/bitmap_ops.py (pallas_call at line 62).  It is the
//   per-level epilogue of the bitmap-resident BFS engine:
//
//       next    = next_raw & ~visited
//       visited = visited | next
//       count   = popcount(next)
//
// What bounds it on this card: device-memory bytes.  Each 32-bit word is read
//   twice (next_raw, visited) and written twice (next, visited'): 16 B per
//   word and one popcount, far below the H100's ~20 integer ops per byte.
//   At Graph500 scale 20 the bitmaps hold W = 32,768 words, i.e. 512 KiB of
//   traffic: about 0.16 us at 3.35 TB/s, below the cost of any launch.  So
//   what a call costs is the launches and the host work around them, and the
//   design spends exactly one device operation per call.
//
// What the design does about it: one pass reads each input word once and
//   writes each output word once, 16 bytes per thread per load (uint4), with
//   a grid-stride loop.  The popcount is `__popc` per word, a warp sum with
//   `__reduce_add_sync` and a block sum through shared memory.  No counter
//   has to be zeroed before the launch (no memset): each block writes its
//   sum into its slot of a scratch array, makes it visible
//   (`__threadfence`), and takes a ticket (`atomicAdd` on an unsigned
//   counter in the same scratch).  The block that draws the last ticket sums
//   the slots in a fixed order (lane-strided, then a warp tree), writes
//   `count`, and sets the ticket back to 0 for the next launch; stream order
//   makes that safe, so one scratch serves every launch on one stream (the
//   caller keeps one per device and stream).  The TPU version's per-tile
//   partial counts summed afterwards become these slots.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
// The caller guarantees n_words % 4 == 0, 16-byte aligned pointers, and a
// scratch of kMaxBlocks + 1 32-bit words whose last word (the ticket) is 0
// before the first launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 4;  // 64 registers a thread: no spill
constexpr int kMaxBlocks = 132 * kMinBlocksPerSm;  // one wave on 132 SMs

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
frontier_update_kernel(const uint4* __restrict__ raw,
                       const uint4* __restrict__ vis,
                       uint4* __restrict__ next_out,
                       uint4* __restrict__ vis_out,
                       int* __restrict__ count,
                       unsigned* __restrict__ scratch,
                       int64_t n_vec) {
  unsigned pc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const uint4 r = raw[i];
    const uint4 v = vis[i];
    uint4 n, nv;
    n.x = r.x & ~v.x;
    n.y = r.y & ~v.y;
    n.z = r.z & ~v.z;
    n.w = r.w & ~v.w;
    nv.x = v.x | n.x;
    nv.y = v.y | n.y;
    nv.z = v.z | n.z;
    nv.w = v.w | n.w;
    next_out[i] = n;
    vis_out[i] = nv;
    pc += __popc(n.x) + __popc(n.y) + __popc(n.z) + __popc(n.w);
  }
  pc = __reduce_add_sync(0xffffffffu, pc);
  __shared__ unsigned warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = pc;
  __syncthreads();
  unsigned* ticket = scratch + kMaxBlocks;
  int last = 0;
  if (warp == 0) {
    unsigned s = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) {
      scratch[blockIdx.x] = s;
      __threadfence();  // the slot is visible before the ticket is taken
      last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
  }
  if (__syncthreads_or(last) && warp == 0) {
    __threadfence();
    unsigned s = 0;
    for (unsigned b = lane; b < gridDim.x; b += 32) s += __ldcg(scratch + b);
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) {
      *count = static_cast<int>(s);
      *ticket = 0u;
    }
  }
}

}  // namespace

extern "C" int frontier_update_launch(const void* next_raw, const void* visited,
                                      void* next_out, void* visited_out,
                                      void* count, void* scratch, int64_t n_words,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_vec = n_words / 4;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  frontier_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint4*>(next_raw), static_cast<const uint4*>(visited),
      static_cast<uint4*>(next_out), static_cast<uint4*>(visited_out),
      static_cast<int*>(count), static_cast<unsigned*>(scratch), n_vec);
  return static_cast<int>(cudaGetLastError());
}
