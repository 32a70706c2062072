// Multi-source Boolean SpMV over the dense heavy core, int8 tensor cores,
// for Hopper (sm_90a): TMA ring, warp-specialised `wgmma` s8, stream-K.
//
// Replaces: the Pallas TPU kernel `spmv_mxu` / `_kernel` in
//   src/repro/kernels/spmv_mxu.py (pallas_call at line 57).  It computes
//
//       counts[K, R] = A8[K, K] @ F8[K, R]     (int8 x int8 -> int32)
//
//   for R simultaneous BFS frontiers over the core; callers threshold
//   counts > 0 for the next frontiers.  The product is exact for every int8
//   value: |sum| <= K * 128^2, about 1.0e9 at K = 61,440, fits in int32.
//
// What bounds it on this card: device-memory bytes.  At K = 61,440 and
//   R = 128 the call must read A once, K^2 bytes = 3.77 GB (1.13 ms at
//   3.35 TB/s), while its 2 K^2 R = 0.97 T integer operations take 0.49 ms at
//   the 1,979 TOP/s of the int8 tensor cores.  F (7.9 MB) and the output
//   (31 MB) are small beside A.  So the design keeps enough of A in flight to
//   stream it at the memory's rate, and keeps F's re-reads in L2.
//
// What the design does about it:
//   * F in the layout `wgmma` needs.  8-bit `wgmma` takes both operands
//     K-major only.  A8 [K, K] row-major already is; F8 [K, R] is not, so a
//     first kernel (`spmv_prep_kernel`, same entry point) transposes F once
//     into the scratch Ft [R, K] the caller passes (4 x 4 byte blocks turned
//     with `__byte_perm`, conflict-free shared memory).  The same launch
//     zeroes the output tiles that stream-K splits (below).
//   * A ring fed by TMA.  2-D tensor maps for A and Ft with 128-byte k boxes
//     and the 128-byte swizzle; 4 stages of (A 256 x 128 B, Ft 128 x 128 B) =
//     48 KB in dynamic shared memory, so up to 128 KB of A per SM is in
//     flight.  One producer thread issues the TMA loads (A marked evict-first
//     in L2, Ft evict-last); two consumer warpgroups wait on the stage's
//     `mbarrier`, issue `wgmma.mma_async.m64n128k32.s32.s8.s8` straight from
//     the swizzled shared memory, and release the stage on its "empty"
//     barrier.  No `__syncthreads` in the loop.  The producer's warpgroup
//     gives its registers to the consumers (`setmaxnreg` 40 / 232).
//   * F's re-reads halved.  A tile is 256 rows of A (each consumer warpgroup
//     128 rows, two m64 tiles, 128 int32 accumulators per thread) by 128
//     frontiers, so each Ft k-box read from L2 serves 256 rows.
//   * Stream-K over the card.  240 row tiles x 480 k steps at K = 61,440
//     would leave 1.8 waves on 132 SMs.  Instead one persistent block per SM
//     walks an even share of the (tile, k step) units (planned by
//     `spmv_mxu.spmv_plan` in Python and recomputed here from `units` and
//     `blocks`: block b owns [b U / P, (b + 1) U / P)).  A tile a block owns
//     whole is stored with plain stores; a block holding part of a tile adds
//     its partial sums with integer `red.global.add` into the zeroed tile.
//     Integer addition is exact in any order, so the result is bit-identical
//     to the plain version and between calls.
//   The TPU kernel's sequential k grid axis with its revisited output block
//   becomes each block's walk over k inside a tile.
//
// C interface (loaded with ctypes): returns 0 on success, else the
// cudaError_t of the failing call (cudaErrorNotSupported when libcuda has
// no cuTensorMapEncodeTiled, cudaErrorInvalidValue when a tensor map cannot
// be encoded).  The caller guarantees K % 128 == 0, R % 128 == 0, contiguous
// int8 inputs, a contiguous int8 scratch Ft [R, K], a contiguous int32
// output, 16-byte aligned pointers, and 1 <= blocks <= units.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 256;                // rows of A per tile
constexpr int kBN = 128;                // frontiers per tile
constexpr int kBK = 128;                // k bytes per unit: one swizzle row
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK;      // 32 KB
constexpr int kFBytes = kBN * kBK;      // 16 KB
constexpr int kStageBytes = kABytes + kFBytes;
constexpr int kThreads = 384;           // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

// L2 cache policies for TMA loads (the encodings CUTLASS names
// CacheHintSm90::EVICT_FIRST / EVICT_LAST).
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;
constexpr uint64_t kEvictLast = 0x14F0000000000000ull;

constexpr int kPrepThreads = 256;
constexpr int kPrepStride = 128;        // bytes of one staged F row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` of the barrier has completed.  A
// wait that lasts seconds can only be a fault (a barrier that never
// completes): trap, so the launch fails with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  uint64_t t0 = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && (++spins & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  } while (!done);
}

// 2-D TMA load of one box at (c0 = k byte, c1 = row) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "l"(policy)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type 1.
// Moving k inside the 128-byte row adds bytes / 16 to the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d[64 x 128] += A[64 x 32] . B[128 x 32]^T, int8 operands, int32 sums.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The block that owns unit u when U units are shared evenly by P blocks
// (block b owns [b U / P, (b + 1) U / P)).
__device__ __forceinline__ int64_t owner(int64_t u, int64_t units, int64_t blocks) {
  return ((u + 1) * blocks - 1) / units;
}

// Blocks [0, k_steps * n_tiles): transpose one 128 (k) x 128 (n) byte tile
// of F [K, R] into Ft [R, K].  Blocks after that, one per output tile: zero
// the tile if stream-K splits it over blocks.
__global__ void __launch_bounds__(kPrepThreads)
spmv_prep_kernel(const int8_t* __restrict__ f, int8_t* __restrict__ ft,
                 int* __restrict__ out, int k, int r, int n_tiles,
                 int64_t units, int blocks) {
  const int k_steps = k / kBK;
  const int tid = threadIdx.x;
  const int t_blocks = k_steps * n_tiles;
  if (static_cast<int>(blockIdx.x) >= t_blocks) {
    const int tile = blockIdx.x - t_blocks;
    const int64_t first = static_cast<int64_t>(tile) * k_steps;
    if (owner(first, units, blocks) == owner(first + k_steps - 1, units, blocks)) return;
    const int m0 = (tile / n_tiles) * kBM;
    const int n0 = (tile % n_tiles) * kBN;
    const int rows = min(kBM, k - m0);
    for (int i = tid; i < rows * (kBN / 4); i += kPrepThreads) {
      const int row = i / (kBN / 4);
      const int c = i % (kBN / 4);
      *reinterpret_cast<int4*>(out + static_cast<int64_t>(m0 + row) * r + n0 + c * 4) =
          make_int4(0, 0, 0, 0);
    }
    return;
  }
  __shared__ __align__(16) unsigned s[kBK * kPrepStride / 4];  // [k][n / 4]
  const int k0 = (blockIdx.x / n_tiles) * kBK;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = tid + kPrepThreads * q;   // 1024 16-byte pieces
    const int row = i >> 3;
    const int c = i & 7;
    *reinterpret_cast<uint4*>(&s[row * (kPrepStride / 4) + c * 4]) =
        *reinterpret_cast<const uint4*>(f + static_cast<int64_t>(k0 + row) * r + n0 + c * 16);
  }
  __syncthreads();
  // thread: 16 k (rows kc * 16 ..) x 4 n (word column nw): a warp reads 32
  // consecutive words of one row at a time
  const int nw = tid & 31;
  const int kc = tid >> 5;
  unsigned col[4][4];  // [n][k / 4]
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const unsigned* p = &s[(kc * 16 + kb * 4) * (kPrepStride / 4) + nw];
    const unsigned r0 = p[0], r1 = p[kPrepStride / 4], r2 = p[2 * (kPrepStride / 4)],
                   r3 = p[3 * (kPrepStride / 4)];
    // rows k..k+3 (each 4 columns) -> columns n..n+3 (each 4 k, k ascending)
    const unsigned t0 = __byte_perm(r0, r1, 0x5140);
    const unsigned t1 = __byte_perm(r2, r3, 0x5140);
    const unsigned t2 = __byte_perm(r0, r1, 0x7362);
    const unsigned t3 = __byte_perm(r2, r3, 0x7362);
    col[0][kb] = __byte_perm(t0, t1, 0x5410);
    col[1][kb] = __byte_perm(t0, t1, 0x7632);
    col[2][kb] = __byte_perm(t2, t3, 0x5410);
    col[3][kb] = __byte_perm(t2, t3, 0x7632);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<uint4*>(ft + static_cast<int64_t>(n0 + nw * 4 + c) * k + k0 + kc * 16) =
        make_uint4(col[c][0], col[c][1], col[c][2], col[c][3]);
}

__global__ void __launch_bounds__(kThreads, 1)
spmv_mxu_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_f, int* __restrict__ out,
                int k, int r, int n_tiles, int64_t units, int blocks) {
  extern __shared__ uint8_t smem_raw[];
  // stages 1024-aligned for the 128-byte swizzle; barriers after them
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int k_steps = k / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t u_begin = static_cast<int64_t>(blockIdx.x) * units / blocks;
  const int64_t u_end = static_cast<int64_t>(blockIdx.x + 1) * units / blocks;

  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int64_t u = u_begin; u < u_end; ++u) {
        const int64_t tile = u / k_steps;
        const int kb = static_cast<int>(u - tile * k_steps);
        mbar_wait(empty(s), ph ^ 1u);
        mbar_expect_tx(full(s), kStageBytes);
        const uint32_t st = base + s * kStageBytes;
        tma_load(st, &tm_a, full(s), kb * kBK, static_cast<int>(tile / n_tiles) * kBM,
                 kEvictFirst);
        tma_load(st + kABytes, &tm_f, full(s), kb * kBK,
                 static_cast<int>(tile % n_tiles) * kBN, kEvictLast);
        if (++s == kStages) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;          // consumer warpgroup: rows cw * 128 of a tile
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  int s = 0;
  uint32_t ph = 0;
  int64_t u = u_begin;
  while (u < u_end) {
    const int64_t tile = u / k_steps;
    const int64_t tile_end = (tile + 1) * k_steps;
    const int64_t seg_end = u_end < tile_end ? u_end : tile_end;
    const bool whole = u == tile * k_steps && seg_end == tile_end;
    int acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = 0;
    for (; u < seg_end; ++u) {
      mbar_wait(full(s), ph);
      const uint32_t sa = base + s * kStageBytes + cw * 128 * kBK;
      const uint32_t sf = base + s * kStageBytes + kABytes;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const uint64_t db = smem_desc(sf + kk * 32);
        wgmma_s8(acc[0], smem_desc(sa + kk * 32), db);
        wgmma_s8(acc[1], smem_desc(sa + 64 * kBK + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(empty(s));
      if (++s == kStages) {
        s = 0;
        ph ^= 1u;
      }
    }
    // epilogue: accumulator register 4c + 2h + e of an m64n128 tile holds
    // row 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e
    const int row0 = static_cast<int>(tile / n_tiles) * kBM + cw * 128 + warp * 16 + (lane >> 2);
    const int col0 = static_cast<int>(tile % n_tiles) * kBN + 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + m * 64 + h * 8;
        if (row >= k) continue;   // a ragged last tile: rows past K are padding
        int* p = out + static_cast<int64_t>(row) * r + col0;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int v0 = acc[m][4 * c + 2 * h];
          const int v1 = acc[m][4 * c + 2 * h + 1];
          if (whole) {
            *reinterpret_cast<int2*>(p + 8 * c) = make_int2(v0, v1);
          } else {
            if (v0) atomicAdd(p + 8 * c, v0);
            if (v1) atomicAdd(p + 8 * c + 1, v1);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded (no
// -lcuda on the link line).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major int8 [rows, cols] matrix, boxes of box_rows x 128
// bytes, 128-byte swizzle; rows past the end read as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int64_t rows,
              int64_t cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int spmv_mxu_launch(const void* a_core8, const void* frontier8, void* ft,
                               void* out, int64_t k, int64_t r, int64_t units,
                               int64_t blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || r <= 0) return static_cast<int>(cudaGetLastError());
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_a, tm_f;
  if (!make_map(enc, &tm_a, a_core8, k, k, kBM) || !make_map(enc, &tm_f, ft, r, k, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>(r / kBN);
  const int m_tiles = static_cast<int>((k + kBM - 1) / kBM);
  const int t_blocks = static_cast<int>(k / kBK) * n_tiles;
  spmv_prep_kernel<<<t_blocks + m_tiles * n_tiles, kPrepThreads, 0, s>>>(
      static_cast<const int8_t*>(frontier8), static_cast<int8_t*>(ft),
      static_cast<int*>(out), static_cast<int>(k), static_cast<int>(r), n_tiles, units,
      static_cast<int>(blocks));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spmv_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_mxu_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, s>>>(
      tm_a, tm_f, static_cast<int*>(out), static_cast<int>(k), static_cast<int>(r),
      n_tiles, units, static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}
