// The frontier list of the frontier-driven relax kernels (bfs_relax.cu,
// sssp_relax.cu), for Hopper (sm_90a).
//
// Both relax a frontier's rows balanced by entries, not by vertices, since
// degree-sorted rows run from 1 to over 10^5 entries.  A three-pass scan
// lists the frontier: each block counts its frontier vertices with entries
// and their entries (pass 1), one block turns the block sums into exclusive
// offsets and the two totals (pass 2, block_offsets), and each block scans
// again from its offset and writes its vertices with the first entry of
// each in the order of entries, fstart (pass 3).  How a block reads its part
// of the frontier (a bitmap word a thread, or kItems degrees) is each
// kernel's own, so passes 1 and 3 stay in their files; the scan they share
// is block_scan.  The relax then takes tiles of consecutive entries: the
// list range that covers a tile is found with two binary searches over
// fstart (tile_range), staged in shared memory, and each entry mapped to its
// vertex by a binary search there (staged_entry).
//
// Everything here is inlined into the kernels of each file, which keep their
// own names: a kernel's name says which relax it belongs to.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace frontier_list {

// Frontier vertices with entries, and their entries.
struct Count {
  int n;
  long long e;
};

// Exclusive scan of one Count a thread over the block (kBlock threads, a
// multiple of 32 up to 1024); *total gets the block's sum in every thread.
template <int kBlock>
__device__ __forceinline__ Count block_scan(Count x, Count* total) {
  constexpr int kWarps = kBlock / 32;
  __shared__ int s_n[kWarps];
  __shared__ long long s_e[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Count inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc.n, d);
    const long long e = __shfl_up_sync(0xffffffffu, inc.e, d);
    if (lane >= d) {
      inc.n += n;
      inc.e += e;
    }
  }
  if (lane == 31) {
    s_n[warp] = inc.n;
    s_e[warp] = inc.e;
  }
  __syncthreads();
  if (warp == 0) {
    int n = lane < kWarps ? s_n[lane] : 0;
    long long e = lane < kWarps ? s_e[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n2 = __shfl_up_sync(0xffffffffu, n, d);
      const long long e2 = __shfl_up_sync(0xffffffffu, e, d);
      if (lane >= d) {
        n += n2;
        e += e2;
      }
    }
    if (lane < kWarps) {
      s_n[lane] = n;
      s_e[lane] = e;
    }
  }
  __syncthreads();
  Count out = {inc.n - x.n, inc.e - x.e};
  if (warp > 0) {
    out.n += s_n[warp - 1];
    out.e += s_e[warp - 1];
  }
  *total = Count{s_n[kWarps - 1], s_e[kWarps - 1]};
  __syncthreads();  // the next call may overwrite s_n / s_e
  return out;
}

// Pass 2, one block of kBlock threads: the block sums become exclusive
// offsets in place; totals = {frontier vertices with entries, their entries}.
template <int kBlock>
__device__ __forceinline__ void block_offsets(int* __restrict__ part_n,
                                              long long* __restrict__ part_e, int64_t n_parts,
                                              long long* __restrict__ totals) {
  Count carry = {0, 0};
  for (int64_t base = 0; base < n_parts; base += kBlock) {
    const int64_t i = base + threadIdx.x;
    const Count x = i < n_parts ? Count{part_n[i], part_e[i]} : Count{0, 0};
    Count total;
    const Count ex = block_scan<kBlock>(x, &total);
    if (i < n_parts) {
      part_n[i] = carry.n + ex.n;
      part_e[i] = carry.e + ex.e;
    }
    carry.n += total.n;
    carry.e += total.e;
  }
  if (threadIdx.x == 0) {
    totals[0] = carry.n;
    totals[1] = carry.e;
  }
}

// The number of entries of a[0, n) that are <= x (a sorted ascending).
__device__ __forceinline__ int count_le(const int64_t* a, int n, int64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The list range of the tile of entries [t0, t_last]: s_range gets the
// list entries holding t0 and t_last, from two threads (the caller
// synchronises before reading it).
__device__ __forceinline__ void tile_range(const int64_t* fstart, int n_list, int64_t t0,
                                           int64_t t_last, int* s_range) {
  if (threadIdx.x < 2) {
    s_range[threadIdx.x] = count_le(fstart, n_list, threadIdx.x == 0 ? t0 : t_last) - 1;
  }
}

// The staged list entry that holds the tile's entry r: the last j of
// s_rel[0, n) (ascending, s_rel[0] == 0) with s_rel[j] <= r.
__device__ __forceinline__ int staged_entry(const int* s_rel, int n, int r) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_rel[mid] <= r) lo = mid; else hi = mid - 1;
  }
  return lo;
}

}  // namespace frontier_list
