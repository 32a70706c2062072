// Bitmap BFS level relax for Hopper (sm_90a): one C-entry call a level, in
// the level's direction.
//
// Replaces: no TPU kernel.  The JAX engine relaxes a level with a plain
//   `jnp` scatter-min over edge lanes (src/repro/core/hybrid_bfs.py
//   `_relax_edges`, through `_chunked_relax` in a top-down level): every
//   lane tests its source's frontier bit and its destination's visited bit
//   and scatter-mins its source into the destination's parent, active or
//   not.  A top-down level so reads every lane of the chunks whose source
//   range meets the frontier, and a bottom-up level every edge but the
//   core's (~128M lanes at Graph500 scale 22), one atomic each.
//
// parent is int32 [V + 1] with the sentinel V for "no parent yet"; a vertex
//   is visited when its visited bit is set.  Both directions give each
//   vertex found this level its least frontier neighbour, as the scatter-min
//   did (the graph is undirected: vertex v's row holds the edges into v).
//
// Top-down (frontier-driven): only the frontier vertices' rows are read.
//   For an entry u -> v whose v is not visited, parent[v] is read and
//   atomicMin(parent + v, u) issued only when u is below it, so a
//   destination that a smaller frontier vertex already took costs no atomic.
//   The work is balanced by entries, not by vertices, since degree-sorted
//   rows run from 1 to over 10^5 entries: a three-pass scan reads the
//   frontier off its bitmap (a thread a word; per-block sums of frontier
//   vertices with entries and of their entries; one block scans those sums;
//   each block scans its words again and lists its frontier vertices with
//   the first entry of each in the level's order of entries), and the
//   persistent relax kernel takes tiles of kTile consecutive entries, finds
//   the list range that covers a tile with two binary searches, stages it in
//   shared memory and maps each entry to its vertex by a binary search there.
//   The totals are read on the device: no host synchronisation.
//
// Bottom-up (early exit, no atomics): a thread owns one vertex v that is
//   still without a parent (not visited, and not won by the core step that
//   ran before).  Rows ascend (build_csr sorts each row), so the first
//   neighbour whose frontier bit is set is the least, and the walk stops
//   there with a plain store.  A core row (v < k) walks only its entries past
//   the core (core_deg[v] entries in): any core candidate is below every such
//   neighbour, so the core step saw it.  A row of at most kWarp entries is
//   walked by its thread; a longer one by the whole warp, kWarp consecutive
//   entries at a time, the first hit found by a ballot.  The entries read
//   are summed per block and added once into *entries_read (when not null).
//
// What bounds it on this card: the bytes of the rows it reads (int32 dst, 4 B
//   an entry, coalesced in the top-down and in a warp's walk) and the random
//   4-byte reads of the bitmaps (512 KB each at scale 22) and of parent
//   (16 MB), which the 50 MB L2 holds.  Top-down also reads the frontier
//   bitmap and its vertices' degrees once; bottom-up reads parent, row_start
//   and degree once a vertex (16 B), then its rows up to the first hit.
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
constexpr int kItems = 4;                  // entries a thread takes in the top-down relax
constexpr int kTile = kThreads * kItems;   // entries a block of the relax takes at once
constexpr int kBlocksPerSm = 8;
constexpr int kMaxBlocks = 132 * kBlocksPerSm;
constexpr int kOffsetThreads = 1024;       // the one block that scans the block sums
constexpr int kWarp = 32;                  // longer rows are walked by a whole warp

__device__ __forceinline__ bool test_bit(const unsigned* __restrict__ bm, int v) {
  return (__ldg(bm + (v >> 5)) >> (v & 31)) & 1u;
}

// The thread's bitmap word: its frontier vertices (bits below n_vertices)
// with entries, and their entries.
__device__ __forceinline__ Count word_count(unsigned word, int64_t v0, int64_t n_vertices,
                                            const int* __restrict__ degree) {
  Count x = {0, 0};
  while (word) {
    const int64_t v = v0 + __ffs(word) - 1;
    word &= word - 1;
    const int d = v < n_vertices ? __ldg(degree + v) : 0;
    if (d > 0) {
      x.n += 1;
      x.e += d;
    }
  }
  return x;
}

__device__ __forceinline__ unsigned load_word(const unsigned* __restrict__ frontier,
                                              int64_t w, int64_t n_words) {
  return w < n_words ? __ldg(frontier + w) : 0u;
}

// Pass 1: each block's Count over its kThreads words.
__global__ void __launch_bounds__(kThreads)
bfs_relax_count_kernel(const unsigned* __restrict__ frontier, const int* __restrict__ degree,
                       int64_t n_vertices, int64_t n_words, int* __restrict__ part_n,
                       long long* __restrict__ part_e) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Count total;
  block_scan<kThreads>(word_count(load_word(frontier, w, n_words), 32 * w, n_vertices, degree),
                       &total);
  if (threadIdx.x == 0) {
    part_n[blockIdx.x] = total.n;
    part_e[blockIdx.x] = total.e;
  }
}

// Pass 2, one block: the block sums become exclusive offsets
// (frontier_list.cuh).
__global__ void __launch_bounds__(kOffsetThreads)
bfs_relax_offsets_kernel(int* __restrict__ part_n, long long* __restrict__ part_e,
                         int64_t n_parts, long long* __restrict__ totals) {
  block_offsets<kOffsetThreads>(part_n, part_e, n_parts, totals);
}

// Pass 3: each block scans its words again from its offset and lists its
// frontier vertices with entries, in vertex order.
__global__ void __launch_bounds__(kThreads)
bfs_relax_compact_kernel(const unsigned* __restrict__ frontier, const int* __restrict__ degree,
                         int64_t n_vertices, int64_t n_words, const int* __restrict__ part_n,
                         const long long* __restrict__ part_e, int* __restrict__ flist,
                         int64_t* __restrict__ fstart) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned word = load_word(frontier, w, n_words);
  Count total;
  Count at = block_scan<kThreads>(word_count(word, 32 * w, n_vertices, degree), &total);
  at.n += part_n[blockIdx.x];
  at.e += part_e[blockIdx.x];
  while (word) {
    const int64_t v = 32 * w + __ffs(word) - 1;
    word &= word - 1;
    const int d = v < n_vertices ? __ldg(degree + v) : 0;
    if (d > 0) {
      flist[at.n] = static_cast<int>(v);
      fstart[at.n] = at.e;
      at.n += 1;
      at.e += d;
    }
  }
}

// Pass 4: the top-down relax over the listed vertices' entries.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bfs_relax_top_down_kernel(const long long* __restrict__ totals,
                          const int* __restrict__ flist,
                          const int64_t* __restrict__ fstart,
                          const int64_t* __restrict__ row_start,
                          const int* __restrict__ dst,
                          const unsigned* __restrict__ visited,
                          int* __restrict__ parent) {
  __shared__ int s_rel[kTile];        // list entry's first entry - tile start (>= 0)
  __shared__ int64_t s_row[kTile];    // row_start[u] - fstart: entry e sits at row e + s_row
  __shared__ int s_src[kTile];
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
      s_src[j] = u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = k * kThreads + threadIdx.x;
      if (t0 + r > t_last) break;
      const int lo = staged_entry(s_rel, n, r);
      const int v = __ldg(dst + t0 + r + s_row[lo]);
      const int u = s_src[lo];
      if (!test_bit(visited, v) && u < __ldcg(parent + v)) atomicMin(parent + v, u);
    }
    __syncthreads();   // the staged range is read before the next tile's
  }
}

// The bottom-up relax: a thread a vertex, rows longer than kWarp walked by
// the warp together.
__global__ void __launch_bounds__(kThreads)
bfs_relax_bottom_up_kernel(const unsigned* __restrict__ frontier,
                           const int64_t* __restrict__ row_start,
                           const int* __restrict__ degree,
                           const int* __restrict__ dst,
                           const int* __restrict__ core_deg, int64_t k,
                           int64_t n_vertices, int* __restrict__ parent,
                           unsigned long long* __restrict__ entries_read) {
  __shared__ long long s_reads[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  const int64_t v = v0 + lane;
  int64_t start = 0, end = 0;
  if (v < n_vertices && parent[v] == static_cast<int>(n_vertices)) {
    start = __ldg(row_start + v);
    end = start + __ldg(degree + v);
    if (v < k) start += __ldg(core_deg + v);
  }
  long long reads = 0;
  if (end - start <= kWarp) {
    for (int64_t e = start; e < end; ++e) {
      const int u = __ldg(dst + e);
      ++reads;
      if (test_bit(frontier, u)) {
        parent[v] = u;
        break;
      }
    }
  }
  unsigned long_rows = __ballot_sync(0xffffffffu, end - start > kWarp);
  while (long_rows) {
    const int leader = __ffs(long_rows) - 1;
    long_rows &= long_rows - 1;
    const int64_t s = __shfl_sync(0xffffffffu, start, leader);
    const int64_t t = __shfl_sync(0xffffffffu, end, leader);
    for (int64_t e0 = s; e0 < t; e0 += kWarp) {
      const int64_t e = e0 + lane;
      int u = 0;
      bool hit = false;
      if (e < t) {
        u = __ldg(dst + e);
        ++reads;
        hit = test_bit(frontier, u);
      }
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (hits) {
        if (lane == __ffs(hits) - 1) parent[v0 + leader] = u;
        break;
      }
    }
  }
  if (entries_read == nullptr) return;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) reads += __shfl_down_sync(0xffffffffu, reads, d);
  if (lane == 0) s_reads[threadIdx.x >> 5] = reads;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) sum += s_reads[i];
    if (sum) atomicAdd(entries_read, static_cast<unsigned long long>(sum));
  }
}

}  // namespace

// bottom_up selects the direction.  Top-down reads frontier, visited, degree,
// row_start and dst and writes parent, with the caller's scratch: part_n
// int32 and part_e int64 of ceil(ceil(n_vertices / 32) / 256) entries each,
// totals int64 [2], and the list flist int32 and fstart int64 of n_vertices
// entries each.  Bottom-up reads frontier, degree, row_start, dst and
// core_deg (k entries: the core rows' entries inside the core) and writes
// parent and, unless it is null, adds the entries read to entries_read.
extern "C" int bfs_relax_launch(int bottom_up, const void* frontier, const void* visited,
                                const void* degree, const void* row_start, const void* dst,
                                const void* core_deg, int64_t k, void* parent,
                                void* entries_read, void* part_n, void* part_e,
                                void* totals, void* flist, void* fstart,
                                int64_t n_vertices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const unsigned*>(frontier);
  const auto* deg = static_cast<const int*>(degree);
  if (bottom_up) {
    const int64_t n_blocks = (n_vertices + kThreads - 1) / kThreads;
    bfs_relax_bottom_up_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
        f, static_cast<const int64_t*>(row_start), deg, static_cast<const int*>(dst),
        static_cast<const int*>(core_deg), k, n_vertices, static_cast<int*>(parent),
        static_cast<unsigned long long*>(entries_read));
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t n_words = (n_vertices + 31) / 32;
  const int64_t n_parts = (n_words + kThreads - 1) / kThreads;
  bfs_relax_count_kernel<<<static_cast<unsigned>(n_parts), kThreads, 0, s>>>(
      f, deg, n_vertices, n_words, static_cast<int*>(part_n),
      static_cast<long long*>(part_e));
  bfs_relax_offsets_kernel<<<1, kOffsetThreads, 0, s>>>(
      static_cast<int*>(part_n), static_cast<long long*>(part_e), n_parts,
      static_cast<long long*>(totals));
  bfs_relax_compact_kernel<<<static_cast<unsigned>(n_parts), kThreads, 0, s>>>(
      f, deg, n_vertices, n_words, static_cast<const int*>(part_n),
      static_cast<const long long*>(part_e), static_cast<int*>(flist),
      static_cast<int64_t*>(fstart));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bfs_relax_top_down_kernel<<<kMaxBlocks, kThreads, 0, s>>>(
      static_cast<const long long*>(totals), static_cast<const int*>(flist),
      static_cast<const int64_t*>(fstart), static_cast<const int64_t*>(row_start),
      static_cast<const int*>(dst), static_cast<const unsigned*>(visited),
      static_cast<int*>(parent));
  return static_cast<int>(cudaGetLastError());
}
