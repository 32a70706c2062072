// Multi-source Boolean SpMV over the dense heavy core, int8 tensor cores,
// for Hopper (sm_90a).
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
//   R = 128 the launch must read A once, K^2 bytes = 3.77 GB (1.13 ms at
//   3.35 TB/s), while its 2 K^2 R = 0.97 T integer operations take 0.49 ms at
//   the 1,979 TOP/s of the int8 tensor cores.  F (7.9 MB) and the output
//   (31 MB) are small beside A.
//
// What the design does about it: a block owns a 128 x 128 output tile, so
//   with R = 128 every byte of A is read from device memory exactly once
//   (16-byte streaming loads, `__ldcs`); F is re-read by every row block and
//   lives in L2.  Each 64-deep step stages A [128 x 64] and F [64 x 128] in
//   shared memory; the next step's global loads are issued before the
//   tensor-core work.  F is k-major in memory, and `mma` wants k contiguous
//   per column, so each thread reads a 4 (k) x 4 (n) byte block with
//   coalesced row loads, transposes it in registers with `__byte_perm`, and
//   stores four k-contiguous words.  The F tile's words are XOR-swizzled
//   (`swz`) so that both these stores and the fragment loads avoid bank
//   conflicts; A rows are padded to 80 bytes for the same reason.  Eight
//   warps (2 x 4) each hold a 64 x 32 int32 accumulator and issue
//   `mma.sync.m16n8k32.s8.s8.s32`: integer accumulation is exact in any
//   order, so the result is bit-identical to the plain version.  The TPU
//   kernel's sequential k grid axis with its revisited output block becomes
//   the loop over k inside the block.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
// The caller guarantees K % 128 == 0, R % 128 == 0, contiguous int8 inputs,
// a contiguous int32 output and 16-byte aligned pointers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;           // output rows per block
constexpr int kBN = 128;           // output columns (frontiers) per block
constexpr int kBK = 64;            // k per step, bytes
constexpr int kAStride = kBK + 16; // A tile row, bytes (20 words: conflict-free)
constexpr int kFWords = kBK / 4;   // F tile row, 32-bit words (16)

// Word position inside an F tile row: k-word `kw` of column `n`.
__device__ __forceinline__ int swz(int n, int kw) {
  return kw ^ ((((n >> 1) & 3) << 2) ^ ((n >> 2) & 15));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
spmv_mxu_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ f,
                int* __restrict__ out, int64_t k, int64_t r) {
  __shared__ __align__(16) int8_t as[kBM * kAStride];  // [m][k]
  __shared__ __align__(16) unsigned fs[kBN * kFWords]; // [n][k/4], swizzled

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1: rows warp_m * 64
  const int warp_n = warp & 3;   // 0..3: columns warp_n * 32
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;

  uint4 ra[2];
  unsigned rf[2][4];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + kThreads * q;  // 512 16-byte pieces of A
      const int row = idx >> 2;
      const int c = idx & 3;
      ra[q] = __ldcs(reinterpret_cast<const uint4*>(a + (m0 + row) * k + k0 + c * 16));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = tid + kThreads * q;    // 512 blocks of 4 (k) x 4 (n) bytes
      const int nq = u & 31;
      const int kq = u >> 5;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rf[q][e] = __ldg(reinterpret_cast<const unsigned*>(
            f + (k0 + kq * 4 + e) * r + n0 + nq * 4));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + kThreads * q;
      *reinterpret_cast<uint4*>(as + (idx >> 2) * kAStride + (idx & 3) * 16) = ra[q];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = tid + kThreads * q;
      const int nq = u & 31;
      const int kq = u >> 5;
      // rows k..k+3 (each 4 columns) -> columns n..n+3 (each 4 k, k ascending)
      const unsigned t0 = __byte_perm(rf[q][0], rf[q][1], 0x5140);
      const unsigned t1 = __byte_perm(rf[q][2], rf[q][3], 0x5140);
      const unsigned t2 = __byte_perm(rf[q][0], rf[q][1], 0x7362);
      const unsigned t3 = __byte_perm(rf[q][2], rf[q][3], 0x7362);
      const unsigned col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = nq * 4 + c;
        fs[n * kFWords + swz(n, kq)] = col[c];
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  for (int64_t k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // every warp is done reading the previous tiles
    store();
    __syncthreads();
    if (k0 + kBK < k) load(k0 + kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = as + (warp_m * 64 + mt * 16 + g) * kAStride + ks + t * 4;
        af[mt][0] = *reinterpret_cast<const unsigned*>(p);
        af[mt][1] = *reinterpret_cast<const unsigned*>(p + 8 * kAStride);
        af[mt][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mt][3] = *reinterpret_cast<const unsigned*>(p + 8 * kAStride + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = warp_n * 32 + nt * 8 + g;
        const int kw = ks / 4 + t;
        bf[nt][0] = fs[n * kFWords + swz(n, kw)];
        bf[nt][1] = fs[n * kFWords + swz(n, kw + 4)];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int64_t row = m0 + warp_m * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int64_t col = n0 + warp_n * 32 + nt * 8 + t * 2;
      *reinterpret_cast<int2*>(out + row * r + col) =
          make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(out + (row + 8) * r + col) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace

extern "C" int spmv_mxu_launch(const void* a_core8, const void* frontier8,
                               void* out, int64_t k, int64_t r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 0 && r > 0) {
    const dim3 grid(static_cast<unsigned>(k / kBM), static_cast<unsigned>(r / kBN));
    spmv_mxu_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(a_core8), static_cast<const int8_t*>(frontier8),
        static_cast<int*>(out), k, r);
  }
  return static_cast<int>(cudaGetLastError());
}
