// Fused xDeepFM CIN layer for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `cin_layer` / `_make_kernel` in
//   src/repro/kernels/cin.py (pallas_call at line 64).  It computes
//
//       out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d]
//
//   for x0 [B, F0, D], xl [B, Fl, D], w [H, F0, Fl] (fp32) -> out [B, H, D],
//   without the [B, F0, Fl, D] outer product in device memory (82 GB at
//   B = 262,144 and full width: F0 = 39, Fl = 200, D = 10).
//
// What bounds it on this card: fp32 operations.  A layer does
//   2 * B * H * F0 * Fl * D flops (31.2 GFLOP per 1,000 rows at Fl = 200)
//   against about 4 * B * (F0 + Fl + H) * D bytes of activations plus the
//   6.24 MB of w: some 3,000 flops per byte, far above the H100's ~20 fp32
//   flops per byte.  So the work is bounded by the 67 TFLOP/s of the fp32
//   cores.  The tensor cores are not used: TF32 keeps ~3 decimal digits,
//   which breaks the reference tolerance rtol = atol = 2e-4.
//
// What the design does about it: the layer is one matrix product whose
//   right operand is made on the fly,
//
//       out[h, n] = sum_k w[h, k] * z[k, n],   k = (i, j),  n = (b, d),
//       z[k, n]   = x0[b, i, d] * xl[b, j, d],
//
//   so the outer product only ever exists as an 8 x 128 tile in shared
//   memory.  A block owns 64 filters h by 128 columns n (n = b * D + d runs
//   over the batch rows in order, so any B and D work and the ragged end is
//   masked).  Each step takes one i and 8 values of j: the block's 256
//   threads load the w tile and build the z tile (one multiply per element)
//   into shared memory; each thread then accumulates an 8 (h) x 4 (n)
//   register tile with fp32 FMAs, reading w as a warp-wide broadcast and z
//   as one conflict-free 16-byte load per lane.  The next step's global
//   loads are issued before the FMAs.  w (6.24 MB per layer) is read from
//   L2 by every block.  The TPU wrapper's padding of D to 128 lanes and its
//   batch-tile halving are TPU layout and are not carried over.  At H = 200
//   the last of the four 64-row tiles is 8/64 full: a known 22% waste.
//
// C interface (loaded with ctypes): returns cudaGetLastError() (0 = success).
// The caller guarantees contiguous fp32 tensors and 16-byte aligned pointers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;                     // h rows per thread
constexpr int kTN = 4;                     // n columns per thread
constexpr int kBM = kTM * (kThreads / 32); // 64 h rows per block (one warp row each)
constexpr int kBN = kTN * 32;              // 128 n columns per block
constexpr int kBK = 8;                     // j values per step
constexpr int kAStride = kBM + 4;          // padding: conflict-free transposed stores

__global__ void __launch_bounds__(kThreads)
cin_layer_kernel(const float* __restrict__ x0, const float* __restrict__ xl,
                 const float* __restrict__ w, float* __restrict__ out,
                 int64_t n_cols, int f0, int fl, int n_h, int d) {
  __shared__ __align__(16) float as[kBK][kAStride];  // w tile, [j][h]
  __shared__ __align__(16) float bs[kBK][kBN];       // z tile, [j][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int h0 = blockIdx.y * kBM;

  // z loader: column ld_n of the tile, rows ld_k + 2 r.
  const int ld_n = tid % kBN;
  const int ld_k = tid / kBN;
  const int64_t n = n0 + ld_n;
  const bool n_ok = n < n_cols;
  const int64_t row_b = n_ok ? n / d : 0;
  const int col_d = n_ok ? static_cast<int>(n % d) : 0;
  const float* x0_col = x0 + row_b * f0 * d + col_d;  // + i * d
  const float* xl_col = xl + row_b * fl * d + col_d;  // + j * d

  // w loader: filter la_m of the tile, j offsets la_k and la_k + 1.
  const int la_m = tid >> 2;
  const int la_k = (tid & 3) * 2;
  const bool m_ok = h0 + la_m < n_h;
  const float* w_row =
      w + static_cast<int64_t>(m_ok ? h0 + la_m : 0) * f0 * fl;

  const int j_steps = (fl + kBK - 1) / kBK;
  const int n_steps = f0 * j_steps;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[m][c] = 0.f;

  float ra[2], rb[4];
  auto load = [&](int step) {
    const int i = step / j_steps;
    const int j0 = (step - i * j_steps) * kBK;
    const float x0v = n_ok ? __ldg(x0_col + i * d) : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ld_k + 2 * r;
      rb[r] = (n_ok && j < fl) ? x0v * __ldg(xl_col + static_cast<int64_t>(j) * d) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = j0 + la_k + q;
      ra[q] = (m_ok && j < fl) ? __ldg(w_row + i * fl + j) : 0.f;
    }
  };

  load(0);
  for (int step = 0; step < n_steps; ++step) {
    __syncthreads();  // every thread is done reading the previous tiles
#pragma unroll
    for (int r = 0; r < 4; ++r) bs[ld_k + 2 * r][ld_n] = rb[r];
    as[la_k][la_m] = ra[0];
    as[la_k + 1][la_m] = ra[1];
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][warp * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][warp * kTM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][lane * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[m][c] = fmaf(a[m], bv[c], acc[m][c]);
    }
  }

#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    const int64_t nn = n0 + lane * kTN + c;
    if (nn >= n_cols) continue;
    float* o = out + (nn / d) * n_h * d + nn % d;
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int hh = h0 + warp * kTM + m;
      if (hh < n_h) o[static_cast<int64_t>(hh) * d] = acc[m][c];
    }
  }
}

}  // namespace

extern "C" int cin_layer_launch(const void* x0, const void* xl, const void* w,
                                void* out, int64_t b, int f0, int fl, int h,
                                int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_cols = b * d;
  if (n_cols > 0 && h > 0) {
    const dim3 grid(static_cast<unsigned>((n_cols + kBN - 1) / kBN),
                    static_cast<unsigned>((h + kBM - 1) / kBM));
    cin_layer_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x0), static_cast<const float*>(xl),
        static_cast<const float*>(w), static_cast<float*>(out), n_cols, f0, fl,
        h, d);
  }
  return static_cast<int>(cudaGetLastError());
}
