// Fused xDeepFM CIN layer for Hopper (sm_90a), on the tensor cores.
//
// Replaces: the Pallas TPU kernel `cin_layer` / `_make_kernel` in
//   src/repro/kernels/cin.py (pallas_call at line 64).  It computes
//
//       out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d]
//
//   for x0 [B, F0, D], xl [B, Fl, D], w [H, F0, Fl] (fp32) -> out [B, H, D],
//   in the TPU kernel's own factoring, without the [B, F0, Fl, D] outer
//   product (82 GB at B = 262,144, F0 = 39, Fl = 200, D = 10):
//
//       P_i[h, n] = sum_j w[h, i, j] * xl[b, j, d]      n = b * D + d
//       out[h, n] = sum_i x0[b, i, d] * P_i[h, n]
//
// What bounds it on this card: operations, on the tensor cores.  A layer
//   does 2 * B * H * F0 * Fl * D flops against about 4 * B * (F0 + Fl + H)
//   * D bytes of activations (w, 6.24 MB, stays in the 50 MB L2): some
//   3,000 flops per byte.  On the fp32 cores the bound is 67 TFLOP/s.  The
//   tensor cores take TF32 (10 mantissa bits), and one TF32 pass breaks the
//   reference tolerance rtol = atol = 2e-4, so every product is taken in
//   three passes (3xTF32): a = hi + lo with hi = rna_tf32(a) and
//   lo = rna_tf32(a - hi), and a * b ~ lo_a * hi_b + hi_a * lo_b + hi_a *
//   hi_b, all into one fp32 accumulator.  The dropped lo_a * lo_b is below
//   2^-22 of the product, the error of hi + lo below 2^-22 of a: fp32-level
//   error.  The bound is then 3 x the flops over the 495 TFLOP/s of TF32.
//
// What the design does about it:
//   - A block owns 80 columns n (8 batch rows at D = 10; any B and D: the
//     columns run across rows and the ragged end is masked) and up to 16
//     filter tiles.  The block's xl rows are loaded once into shared
//     memory, split into hi / lo as they arrive, in the order of the mma B
//     fragments (one conflict-free 16-byte load gives a lane its hi and lo
//     values), and serve as the right operand of all F0 products P_i.
//   - Each warp owns one 16-filter m tile of every P_i and of the output
//     (H = 200 pads to 208, 13 warps: 4% waste) across the 80 columns, as
//     ten m16n8k8 tiles: `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`,
//     three per tile and k step.  No other warp needs its w rows, so each
//     warp streams its own 16 x 8 w tile per k step from L2 through a
//     4-stage ring of 16-byte `cp.async` copies (the wrapper pads w's last
//     axis to a multiple of 4 with zeros, so every row is 16-byte aligned)
//     and splits the fragments in registers with integer rounding.  The k
//     order inside each 8-wide step is permuted (lane t holds j = 2t and
//     2t + 1) alike in both operands, which leaves the sum unchanged.
//   - After each P_i the warp adds x0[b, i, d] * P_i into a second register
//     tile with fp32 FMAs (1/Fl of the flops), so P_i never leaves
//     registers.  The output tile is staged in shared memory and stored in
//     the [B, H, D] order.
//   - At small B the grid would not fill 132 SMs: the wrapper's plan
//     (`kernels/cin.py::cin_plan`) splits the F0 sum over `splits` blocks
//     (gridDim.z), whose partials go to a scratch [splits, B, H, D] and are
//     summed in a fixed order by a second kernel launched here: no float
//     atomics, so two calls give the same bits.
//   - Fl above 256 and F0 above 64 per split are taken in chunks (the sum
//     is linear in both), so shared memory stays below 227 KB.
//   - Left for a later step: `wgmma` with TMA.  `mma.sync` reaches about
//     64% of the TF32 rate on this card, and each warp re-reads its B
//     fragments from shared memory.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success)
// or cudaErrorInvalidValue for a plan it cannot run.  The caller guarantees
// contiguous fp32 tensors, w as [H, F0, ldw] with zeros beyond Fl, and a
// scratch of splits * B * H * D floats when splits > 1.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNT = 10;           // n tiles (8 columns each) per warp
constexpr int kBN = 8 * kNT;      // 80 columns per block
constexpr int kMaxWarps = 16;     // 16-filter m tiles per block, one per warp
constexpr int kStage = kBN + 4;   // row stride of the staged output tile
constexpr int kRingStages = 4;    // w tiles in flight per warp
constexpr int kRing = kRingStages * 16 * 8;  // floats of one warp's w ring
constexpr int kMaxKSteps = 32;    // xl in shared memory: up to 256 values of j
constexpr int kMaxIChunk = 64;    // x0 in shared memory: up to 64 values of i
constexpr int kXsFloats = kMaxKSteps * kBN * 16 > kMaxWarps * 16 * kStage
                              ? kMaxKSteps * kBN * 16 : kMaxWarps * 16 * kStage;
constexpr int kMaxSmem = 4 * (kXsFloats + kMaxIChunk * kBN + kMaxWarps * kRing);
static_assert(kMaxSmem <= 232448, "shared memory above the 227 KB a block can use");

struct Params {
  const float* x0;
  const float* xl;
  const float* w;
  float* out;          // [B, H, D], or the scratch [splits, B, H, D]
  int64_t n_cols;      // B * D
  int f0, fl, h, d;
  int ldw;             // row stride of w's last axis: Fl rounded up to 4
  int splits;          // blocks sharing the F0 sum of one tile (gridDim.z)
  int ks_chunk;        // k steps of 8 values of j held in shared memory
  int i_chunk;         // values of i of x0 held in shared memory
};

// Round to the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32),
// with two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Asynchronous 16-byte copy global -> shared; src_bytes < 16 fills the rest with 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a * b on one m16n8k8 tile, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
cin_layer_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x;
  const int n_warps = nthreads >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment thread in group

  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t n_end = n0 + kBN < p.n_cols ? n0 + kBN : p.n_cols;
  const int64_t b_first = n0 / p.d;
  const int n_rows = static_cast<int>((n_end - 1) / p.d - b_first + 1);
  const int h_blk = blockIdx.y * n_warps * 16;  // first filter of the block
  const int h0 = h_blk + warp * 16;             // first filter of the warp
  const bool active = h0 < p.h;

  // this block's share of the F0 sum: i in [i_lo, i_hi)
  const int z = blockIdx.z;
  const int i_base = p.f0 / p.splits, i_rem = p.f0 % p.splits;
  const int i_lo = z * i_base + min(z, i_rem);
  const int i_hi = i_lo + i_base + (z < i_rem ? 1 : 0);

  const int xs_floats = max(p.ks_chunk * kBN * 16, n_warps * 16 * kStage);
  float* xs = smem;               // xl chunk: [ks][n][t] x {hi 2t, hi 2t+1, lo 2t, lo 2t+1}
  float* x0s = smem + xs_floats;  // x0 chunk: [i][n]
  float* ring = x0s + p.i_chunk * kBN + warp * kRing;  // [stage][16 filters][8 j]
  const float4* xs4 = reinterpret_cast<const float4*>(xs);

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  for (int j0 = 0; j0 < p.fl; j0 += p.ks_chunk * 8) {
    const int jn = min(p.ks_chunk * 8, p.fl - j0);
    const int kcs = (jn + 7) >> 3;
    __syncthreads();  // every warp is done with the previous chunk
    // xl chunk: one (k step, column) record of 8 j values per thread
    for (int e = threadIdx.x; e < kcs * kBN; e += nthreads) {
      const int ks = e / kBN;
      const int nl = e - ks * kBN;
      const int64_t n = n0 + nl;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = 0.f;
      if (n < n_end) {
        const int64_t b = n / p.d;
        const float* src = p.xl + (b * p.fl + j0 + ks * 8) * p.d + (n - b * p.d);
        const int jq = min(8, jn - ks * 8);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < jq) v[q] = __ldg(src + static_cast<int64_t>(q) * p.d);
      }
      float4* dst = reinterpret_cast<float4*>(xs) + (ks * kBN + nl) * 4;
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const uint32_t h_a = to_tf32(v[2 * tt]), h_b = to_tf32(v[2 * tt + 1]);
        const uint32_t l_a = to_tf32(v[2 * tt] - __uint_as_float(h_a));
        const uint32_t l_b = to_tf32(v[2 * tt + 1] - __uint_as_float(h_b));
        dst[tt] = make_float4(__uint_as_float(h_a), __uint_as_float(h_b),
                              __uint_as_float(l_a), __uint_as_float(l_b));
      }
    }

    for (int ic0 = i_lo; ic0 < i_hi; ic0 += p.i_chunk) {
      const int ni = min(p.i_chunk, i_hi - ic0);
      if (ic0 != i_lo) __syncthreads();  // every warp is done with the previous x0 chunk
      for (int e = threadIdx.x; e < ni * kBN; e += nthreads) {
        const int il = e / kBN;
        const int64_t n = n0 + (e - il * kBN);
        float v = 0.f;
        if (n < n_end) {
          const int64_t b = n / p.d;
          v = __ldg(p.x0 + (b * p.f0 + ic0 + il) * p.d + (n - b * p.d));
        }
        x0s[e] = v;
      }
      __syncthreads();
      if (!active) continue;

      // steps s = il * kcs + ks over (i, k step).  Step s's w tile goes to
      // ring stage s % kRingStages: lane L copies filter h0 + L / 2,
      // j .. j + 3 with j = 8 ks + 4 (L % 2), one 16-byte copy.
      const int steps = ni * kcs;
      const int row = h0 + (lane >> 1);
      const bool row_ok = row < p.h;
      auto fetch = [&](int s) {
        const int il = s / kcs;
        const int j = j0 + (s - il * kcs) * 8 + 4 * (lane & 1);
        float* dst = ring + (s % kRingStages) * 128 + 4 * lane;
        const bool ok = row_ok && j < p.fl;  // then j + 3 < ldw: w's padding is 0
        cp_async16(dst, p.w + (ok ? (static_cast<int64_t>(row) * p.f0 + ic0 + il) * p.ldw + j : 0),
                   ok ? 16 : 0);
      };
      float pt[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) pt[nt][q] = 0.f;
      int ks = 0, il = 0;
#pragma unroll
      for (int q = 0; q < kRingStages - 1; ++q) {
        if (q < steps) fetch(q);
        cp_async_commit();
      }
      for (int s = 0; s < steps; ++s) {
        cp_async_wait<kRingStages - 2>();  // step s's tile has landed
        __syncwarp();                      // ... for every lane; stage s - 1 is read
        // A fragments: rows g and g + 8, k = t and t + 4 (j = 2t and 2t + 1)
        const float* wa = ring + (s % kRingStages) * 128 + g * 8 + 2 * t;
        const float2 w_lo = *reinterpret_cast<const float2*>(wa);
        const float2 w_hi = *reinterpret_cast<const float2*>(wa + 64);
        if (s + kRingStages - 1 < steps) fetch(s + kRingStages - 1);
        cp_async_commit();
        const float a[4] = {w_lo.x, w_hi.x, w_lo.y, w_hi.y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[q] = to_tf32(a[q]);
          al[q] = to_tf32(a[q] - __uint_as_float(ah[q]));
        }
        // B fragments of the ten n tiles, then the three passes
        const float4* xb = xs4 + (ks * kBN + g) * 4 + t;
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float4 bv = xb[nt * 32];
          bh[nt][0] = __float_as_uint(bv.x);
          bh[nt][1] = __float_as_uint(bv.y);
          bl[nt][0] = __float_as_uint(bv.z);
          bl[nt][1] = __float_as_uint(bv.w);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(pt[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(pt[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(pt[nt], ah, bh[nt][0], bh[nt][1]);
        if (++ks == kcs) {  // P_i is complete: out += x0[., i, .] * P_i
          const float* xr = x0s + il * kBN + 2 * t;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float2 xv = *reinterpret_cast<const float2*>(xr + nt * 8);
            acc[nt][0] = fmaf(xv.x, pt[nt][0], acc[nt][0]);
            acc[nt][1] = fmaf(xv.y, pt[nt][1], acc[nt][1]);
            acc[nt][2] = fmaf(xv.x, pt[nt][2], acc[nt][2]);
            acc[nt][3] = fmaf(xv.y, pt[nt][3], acc[nt][3]);
#pragma unroll
            for (int q = 0; q < 4; ++q) pt[nt][q] = 0.f;
          }
          ks = 0;
          ++il;
        }
      }
    }
  }

  // stage the output tile [filter][column] and store it in [B, H, D] order
  __syncthreads();
  float* st = smem;
  if (active) {
    float* r0 = st + (warp * 16 + g) * kStage + 2 * t;
    float* r1 = r0 + 8 * kStage;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      *reinterpret_cast<float2*>(r0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(r1 + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  const int mh = min(n_warps * 16, p.h - h_blk);
  const int per_row = mh * p.d;
  float* out = p.out + static_cast<int64_t>(z) * p.n_cols * p.h;
  for (int e = threadIdx.x; e < n_rows * per_row; e += nthreads) {
    const int r = e / per_row;
    const int rem = e - r * per_row;
    const int hl = rem / p.d;
    const int dd = rem - hl * p.d;
    const int64_t b = b_first + r;
    const int64_t n = b * p.d + dd;
    if (n < n0 || n >= n_end) continue;
    out[(b * p.h + h_blk + hl) * p.d + dd] = st[hl * kStage + (n - n0)];
  }
}

// out[e] = sum over z of part[z][e], z in order: the same bits every call.
__global__ void __launch_bounds__(256)
cin_layer_kernel_sum_splits(const float* __restrict__ part, float* __restrict__ out,
                            int64_t total, int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    float s = part[e];
    for (int z = 1; z < splits; ++z) s += part[z * total + e];
    out[e] = s;
  }
}

}  // namespace

extern "C" int cin_layer_launch(const void* x0, const void* xl, const void* w,
                                void* out, void* scratch, int64_t b, int f0,
                                int fl, int h, int d, int ldw, int warps,
                                int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_cols = b * d;
  if (n_cols > 0 && h > 0) {
    if (f0 < 1 || fl < 1 || ldw < fl || ldw % 4 || warps < 1 || warps > kMaxWarps ||
        splits < 1 || splits > f0 || (splits > 1 && scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    // above 48 KB only after opting in, once per device
    static bool opted_in[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && !opted_in[dev]) {
      cudaFuncSetAttribute(cin_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
      opted_in[dev] = true;
    }
    Params p;
    p.x0 = static_cast<const float*>(x0);
    p.xl = static_cast<const float*>(xl);
    p.w = static_cast<const float*>(w);
    p.out = static_cast<float*>(splits > 1 ? scratch : out);
    p.n_cols = n_cols;
    p.f0 = f0;
    p.fl = fl;
    p.h = h;
    p.d = d;
    p.ldw = ldw;
    p.splits = splits;
    p.ks_chunk = std::min((fl + 7) / 8, kMaxKSteps);
    p.i_chunk = std::min((f0 + splits - 1) / splits, kMaxIChunk);
    const int m_tiles = (h + 15) / 16;
    const int xs_floats = std::max(p.ks_chunk * kBN * 16, warps * 16 * kStage);
    const size_t smem =
        4 * static_cast<size_t>(xs_floats + p.i_chunk * kBN + warps * kRing);
    const dim3 grid(static_cast<unsigned>((n_cols + kBN - 1) / kBN),
                    static_cast<unsigned>((m_tiles + warps - 1) / warps),
                    static_cast<unsigned>(splits));
    cin_layer_kernel<<<grid, warps * 32, smem, s>>>(p);
    if (splits > 1) {
      const int64_t total = n_cols * h;
      const int64_t blocks = std::min<int64_t>((total + 255) / 256, 132 * 16);
      cin_layer_kernel_sum_splits<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          static_cast<const float*>(scratch), static_cast<float*>(out), total, splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
