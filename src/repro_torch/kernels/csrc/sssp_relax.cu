// Frontier-driven δ-stepping relax for Hopper (sm_90a): one C-entry call a
// round, four launches (the frontier's scan in three, then the relax).
//
// Replaces: no TPU kernel.  The JAX engine relaxes a round with two plain
//   `jnp` scatter-min passes over every edge entry (src/repro/core/
//   sssp_steps.py): at Graph500 scale 22 a round so reads all ~128M
//   directed entries twice, with one atomic per lane, active or not, while
//   ~14% of them leave the round's frontier.  This kernel walks only the
//   frontier's rows.
//
// The state is one uint64 per vertex, (dist << 32) | parent, and a candidate
//   from frontier vertex u over an edge of weight w is
//   ((dist[u] + w) mod 2^32) << 32 | u, taken in with one unsigned 64-bit
//   atomicMin.  The lexicographic minimum is what the two passes gave: a
//   smaller distance wins with the least source achieving it, and on a tie
//   with the vertex's distance the least source replaces a larger parent.
//   The thread whose atomic lowered the distance half sets changed[v].  The
//   candidates use the distances the compaction read, before the relax,
//   so a frontier vertex improved in the same round relaxes from its
//   round-start distance, as the passes did.
//
// What bounds it on this card: the L2's atomics and random 8-byte reads of
//   the state, not device memory.  A round reads each frontier entry's dst
//   and weight once (8 B, coalesced: a row is contiguous), and the state
//   word of its destination (4,194,304 vertices x 8 B = 32 MB at scale 22,
//   which the 50 MB L2 holds).  The atomic is issued only when the candidate
//   is below the state word just read, so a hub destination that the first
//   candidates settled takes no further atomics.
//
// What the design does about it: the work is balanced by edges, not by
//   vertices, since degree-sorted rows run from 1 to over 10^5 entries.  A
//   three-pass scan over the frontier degrees (per-block sums of vertices
//   with entries and of entries; one block scans those sums; each block
//   scans its vertices again and writes its frontier vertices) compacts the
//   frontier into a list (vertex, round-start distance, first entry in the
//   round's order of entries) in vertex order, reading the degrees twice
//   and writing nothing V-sized but the list.  The relax kernel is
//   persistent: each block takes tiles of kTile consecutive frontier
//   entries, finds the list range that covers the tile with two binary
//   searches, stages that range (at most kTile vertices: each has an entry)
//   in shared memory, and maps each entry to its vertex by a binary search
//   there.  A warp's lanes read consecutive entries.  Both totals (listed
//   vertices, their entries) are read on the device, so the round needs no
//   host synchronisation.
//
// Real weights (the Graph500 specification's Kernel 3: float32 in [0, 1)):
//   a second instantiation of the same kernels, kReal.  The distance half
//   holds float32 bits, whose unsigned order is the order of non-negative
//   floats (the unreached all-ones is a NaN pattern above every one), so the
//   same atomicMin stands; the add is __fadd_rn.  Where fl(d + w) == d (a
//   zero weight, or one under half an ulp of d) the candidate ties its
//   source's distance, and the integer rule, a tie lowers the parent, could
//   make two such vertices each other's parent.  So the low half is
//   hops << pbits | u: 0 hops where the add raised the distance, else u's
//   round-start hops plus one (saturated at the field's maximum; the engine
//   fails a search whose hops reach it).  At one distance fewer hops win,
//   and along a parent link at one distance the hops fall: no cycle.  The
//   compaction also lists each frontier vertex's round-start low half.
//
// The scan's shared passes and the tile's searches: frontier_list.cuh.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
#include <cstdint>
#include <cuda_runtime.h>

#include "frontier_list.cuh"

namespace {

using frontier_list::block_offsets;
using frontier_list::block_scan;
using frontier_list::Count;
using frontier_list::staged_entry;
using frontier_list::tile_range;

constexpr int kThreads = 256;
constexpr int kItems = 4;                  // entries (relax) or vertices (scan) a thread takes
constexpr int kTile = kThreads * kItems;   // entries or vertices a block takes at once
constexpr int kBlocksPerSm = 8;            // 32 registers a thread
constexpr int kMaxBlocks = 132 * kBlocksPerSm;
constexpr int kOffsetThreads = 1024;       // the one block that scans the block sums

// The thread's kItems consecutive vertices: their degrees (0 off the
// frontier and past the end) and their Count.
__device__ __forceinline__ Count load_degrees(const int* __restrict__ front_deg,
                                              int64_t n_vertices, int64_t v0, int* deg) {
  Count x = {0, 0};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    deg[k] = v0 + k < n_vertices ? front_deg[v0 + k] : 0;
    if (deg[k] > 0) {
      x.n += 1;
      x.e += deg[k];
    }
  }
  return x;
}

// Pass 1: each block's Count over its kTile vertices.
__global__ void __launch_bounds__(kThreads)
sssp_relax_count_kernel(const int* __restrict__ front_deg, int64_t n_vertices,
                        int* __restrict__ part_n, long long* __restrict__ part_e) {
  int deg[kItems];
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  Count total;
  block_scan<kThreads>(load_degrees(front_deg, n_vertices, v0, deg), &total);
  if (threadIdx.x == 0) {
    part_n[blockIdx.x] = total.n;
    part_e[blockIdx.x] = total.e;
  }
}

// Pass 2, one block: the block sums become exclusive offsets
// (frontier_list.cuh).
__global__ void __launch_bounds__(kOffsetThreads)
sssp_relax_offsets_kernel(int* __restrict__ part_n, long long* __restrict__ part_e,
                          int64_t n_parts, long long* __restrict__ totals) {
  block_offsets<kOffsetThreads>(part_n, part_e, n_parts, totals);
}

// Pass 3: each block scans its vertices again from its offset and lists its
// frontier vertices with entries (kReal: with their keys' low halves).
template <bool kReal>
__global__ void __launch_bounds__(kThreads)
sssp_relax_compact_kernel(const int* __restrict__ front_deg,
                          const unsigned long long* __restrict__ state,
                          int64_t n_vertices, const int* __restrict__ part_n,
                          const long long* __restrict__ part_e,
                          int* __restrict__ flist, int64_t* __restrict__ fstart,
                          unsigned* __restrict__ fdist, unsigned* __restrict__ flow) {
  int deg[kItems];
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  Count total;
  Count at = block_scan<kThreads>(load_degrees(front_deg, n_vertices, v0, deg), &total);
  at.n += part_n[blockIdx.x];
  at.e += part_e[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (deg[k] > 0) {
      flist[at.n] = static_cast<int>(v0 + k);
      fstart[at.n] = at.e;
      const unsigned long long key = state[v0 + k];
      fdist[at.n] = static_cast<unsigned>(key >> 32);
      if constexpr (kReal) flow[at.n] = static_cast<unsigned>(key);
      at.n += 1;
      at.e += deg[k];
    }
  }
}

// kReal: pbits is the parent's share of the low half (the engine's
// real_key_bits), flow the listed vertices' round-start low halves.
template <bool kReal>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sssp_relax_kernel(const long long* __restrict__ totals,
                  const int* __restrict__ flist,
                  const int64_t* __restrict__ fstart,
                  const unsigned* __restrict__ fdist,
                  const int64_t* __restrict__ row_start,
                  const int* __restrict__ dst,
                  const unsigned* __restrict__ weight,
                  unsigned long long* __restrict__ state,
                  unsigned char* __restrict__ changed,
                  const unsigned* __restrict__ flow, int pbits) {
  __shared__ int s_rel[kTile];        // list entry's first entry - tile start (>= 0)
  __shared__ int64_t s_row[kTile];    // row_start[u] - fstart: entry e sits at row e + s_row
  __shared__ int s_src[kTile];        // u (kReal: the low half u offers over a tie, hops + 1)
  __shared__ unsigned s_dist[kTile];
  __shared__ int s_range[2];

  const int n_list = static_cast<int>(totals[0]);
  const int64_t total = totals[1];
  const int64_t n_tiles = (total + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t t0 = t * kTile;
    const int64_t t_last = (t0 + kTile < total ? t0 + kTile : total) - 1;
    tile_range(fstart, n_list, t0, t_last, s_range);
    __syncthreads();
    const int base = s_range[0];
    const int n = s_range[1] - base + 1;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int64_t fs = fstart[base + j];
      const int u = flist[base + j];
      s_rel[j] = fs > t0 ? static_cast<int>(fs - t0) : 0;
      s_row[j] = row_start[u] - fs;
      if constexpr (kReal) {
        const unsigned hmax = 0xFFFFFFFFu >> pbits;
        const unsigned hops = flow[base + j] >> pbits;
        s_src[j] = static_cast<int>(((hops < hmax ? hops + 1 : hmax) << pbits) |
                                    static_cast<unsigned>(u));
      } else {
        s_src[j] = u;
      }
      s_dist[j] = fdist[base + j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = k * kThreads + threadIdx.x;
      if (t0 + r > t_last) break;
      const int lo = staged_entry(s_rel, n, r);
      const int64_t row = t0 + r + s_row[lo];
      const unsigned v = static_cast<unsigned>(__ldg(dst + row));
      unsigned nd, low;
      if constexpr (kReal) {
        const unsigned du = s_dist[lo];
        nd = __float_as_uint(__fadd_rn(__uint_as_float(du),
                                       __uint_as_float(__ldg(weight + row))));
        low = static_cast<unsigned>(s_src[lo]);
        if (nd != du) low &= (1u << pbits) - 1;      // raised: 0 hops, u
      } else {
        nd = s_dist[lo] + __ldg(weight + row);       // mod 2^32
        low = static_cast<unsigned>(s_src[lo]);
      }
      const unsigned long long cand = (static_cast<unsigned long long>(nd) << 32) | low;
      if (cand < __ldcg(state + v)) {
        const unsigned long long old = atomicMin(state + v, cand);
        if (nd < static_cast<unsigned>(old >> 32)) changed[v] = 1;
      }
    }
    __syncthreads();   // the staged range is read before the next tile's
  }
}

template <bool kReal>
int launch(void* state, void* changed, const int* deg, const void* row_start,
           const void* dst, const void* weight, void* part_n, void* part_e, void* totals,
           void* flist, void* fstart, void* fdist, void* flow, int pbits,
           int64_t n_vertices, cudaStream_t s) {
  const int64_t n_parts = (n_vertices + kTile - 1) / kTile;
  sssp_relax_count_kernel<<<static_cast<unsigned>(n_parts), kThreads, 0, s>>>(
      deg, n_vertices, static_cast<int*>(part_n), static_cast<long long*>(part_e));
  sssp_relax_offsets_kernel<<<1, kOffsetThreads, 0, s>>>(
      static_cast<int*>(part_n), static_cast<long long*>(part_e), n_parts,
      static_cast<long long*>(totals));
  sssp_relax_compact_kernel<kReal><<<static_cast<unsigned>(n_parts), kThreads, 0, s>>>(
      deg, static_cast<const unsigned long long*>(state), n_vertices,
      static_cast<const int*>(part_n), static_cast<const long long*>(part_e),
      static_cast<int*>(flist), static_cast<int64_t*>(fstart),
      static_cast<unsigned*>(fdist), static_cast<unsigned*>(flow));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sssp_relax_kernel<kReal><<<kMaxBlocks, kThreads, 0, s>>>(
      static_cast<const long long*>(totals), static_cast<const int*>(flist),
      static_cast<const int64_t*>(fstart), static_cast<const unsigned*>(fdist),
      static_cast<const int64_t*>(row_start), static_cast<const int*>(dst),
      static_cast<const unsigned*>(weight),
      static_cast<unsigned long long*>(state),
      static_cast<unsigned char*>(changed), static_cast<const unsigned*>(flow), pbits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch, from the caller: part_n int32 and part_e int64 of
// ceil(n_vertices / 1024) entries each, totals int64 [2], and the list
// flist int32, fstart int64, fdist and flow uint32 of n_vertices entries
// each.  pbits > 0 takes real weights with pbits parent bits (flow is read
// only then); 0 takes integer weights.
extern "C" int sssp_relax_launch(void* state, void* changed, const void* front_deg,
                                 const void* row_start, const void* dst,
                                 const void* weight, void* part_n, void* part_e,
                                 void* totals, void* flist, void* fstart, void* fdist,
                                 void* flow, int pbits, int64_t n_vertices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* deg = static_cast<const int*>(front_deg);
  if (pbits > 0)
    return launch<true>(state, changed, deg, row_start, dst, weight, part_n, part_e, totals,
                        flist, fstart, fdist, flow, pbits, n_vertices, s);
  return launch<false>(state, changed, deg, row_start, dst, weight, part_n, part_e, totals,
                       flist, fstart, fdist, flow, pbits, n_vertices, s);
}
