// Fused xDeepFM CIN layer for Hopper (sm_90a): one 3xTF32 GEMM on `wgmma`,
// its A operand formed in registers, the filter weights streamed by TMA.
//
// Replaces: the Pallas TPU kernel `cin_layer` / `_make_kernel` in
//   src/repro/kernels/cin.py (pallas_call at line 64).  It computes
//
//       out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d]
//
//   for x0 [B, F0, D], xl [B, Fl, D], w [H, F0, Fl] (fp32) -> out [B, H, D],
//   without the [B, F0, Fl, D] outer product in memory (82 GB at
//   B = 262,144, F0 = 39, Fl = 200, D = 10).
//
// What bounds it on this card: operations, on the tensor cores.  A layer
//   does 2 B H F0 Fl D flops against about 4 B (F0 + Fl + H) D bytes of
//   activations: some 3,000 flops per byte.  The tensor cores take TF32
//   (10 mantissa bits), and one TF32 pass breaks the reference tolerance
//   rtol = atol = 2e-4, so every product is taken in three passes (3xTF32):
//   a = hi + lo with hi = rna_tf32(a), lo = rna_tf32(a - hi), and
//   a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b in one fp32 accumulator.  The
//   dropped lo_a lo_b is below 2^-22 of the product.  The bound is 3 x the
//   flops over the 495 TFLOP/s of TF32.
//   The tensor cores add into their fp32 accumulator rounding toward zero,
//   so each wgmma moves the sum toward zero by up to an ulp.  Over all of
//   K (2,925 wgmma at Fl = 200) that bias reaches the order of the
//   tolerance.  So a sum on the tensor cores runs at most 16 K units (240
//   wgmma); it is then added in fp32 into the block's outputs, which stay
//   in L2 meanwhile (a flush).
//
// What the design does: one GEMM.  With n = b D + d and k = (i, j),
//
//       out[n, h] = sum_k z[n, k] W[h, k],   z[n, (i, j)] = x0[b, i, d] xl[b, j, d]
//
//   M runs over n, N over the filters, K over (i, j): no per-i epilogue, and
//   forming z is 1/H of the flops, on the CUDA cores.
//   - K order.  K is walked in units (i chunk c, j): a unit is the 8-wide i
//     blocks of chunk c (up to 5, i.e. 40 values of i) at one j, one k8
//     step each, with i padded to a multiple of 8 (F0 = 39 -> 40: 2.5% of
//     the work is padding).  So a thread's x0 values of the chunk (5 blocks
//     x 2 rows x 2 k = 20 floats) stay in registers for the whole chunk, and
//     a unit needs only one xl value per row, loaded one unit ahead from
//     L2: the inner loop reads no shared memory to form A.
//   - A in registers.  `wgmma.mma_async.m64nNk8.f32.tf32.tf32` takes A from
//     registers in the m16n8k8 fragment of each warp (a0 (g, t), a1 (g + 8,
//     t), a2 (g, t + 4), a3 (g + 8, t + 4); g = lane / 4, t = lane % 4) and
//     B from shared memory; TF32 takes no transpose, so both are K-major.
//     Forming A in registers costs no shared-memory traffic; staging z in
//     shared memory for the descriptor form of A would add a store, a proxy
//     fence and a warpgroup barrier to every k8 step.
//   - One wgmma group a unit.  A consumer warpgroup forms z for its 64 rows
//     and all the unit's k8 steps (40 registers), splits it into hi / lo,
//     issues lo.w_hi, hi.w_lo, hi.w_hi for each step (15 `wgmma`), and
//     waits for the group before it runs any other instruction: ptxas
//     reuses the registers of an in-flight register-A `wgmma`, and once it
//     has to insert a wait on a divergent path (a barrier spin, the refill
//     below) it serialises every `wgmma` of the kernel (its C7518 / C7520
//     notes): each waits for the one before it.  The other warpgroup's
//     group keeps the tensor cores busy while this one forms its next A.
//     An i block past the chunk's end has x0 = 0, so its z is 0; it reads
//     the unit's last step of w, and the loop has no branch around `wgmma`.
//   - B through TMA.  A prep kernel (`cin_layer_kernel_prep`, same entry
//     point) writes w_hi and w_lo once per call into the caller's scratch
//     [2, H_pad, K_pad], K-major in the K order above, zero-padded so that
//     every row is 16-byte aligned and K_pad is a whole number of 32-float
//     boxes.  [N x 32] boxes of both, in the 128-byte swizzle, stream into a
//     ring of `mbarrier`-guarded stages shared by both warpgroups (4 stages
//     of 51 KB at N = 200).  There is no producer warp: a ninth warp would
//     put three warps on one SM sub-partition and cap every thread at 168
//     registers, which spills a 64 x 200 accumulator (100 registers) beside
//     A and x0.  With 256 threads a thread may use 255.  Instead the second
//     warpgroup to free a box (a counter per stage in shared memory) issues
//     the TMA load of the box a ring further on.  Barrier waits trap after
//     4 s, so a pipeline fault fails the launch instead of hanging the card.
//   - N is the wgmma width, built for 16, 32, 64, 128 and 200: H = 200
//     takes one tile with no padding; H above 200 takes several tiles
//     (gridDim.y), and the filter padding is zeros.  A wider tile spills
//     (the accumulator takes N / 2 registers a thread).
//   - Flushes.  A flush adds the thread's N / 2 sums into its outputs,
//     scattered in the [B, H, D] order, with fp32 reductions
//     (`red.global.add`, which return nothing, so no load latency is
//     waited for); the first stores.  Each output has one writer, so the
//     adds land in its program order and the bits repeat.  At Fl = 200 a
//     block flushes 13 times.
//   - A block is 128 rows (2 warpgroups) by one filter tile.  Each block
//     reads all of w_hi and w_lo from L2 (2 K N 4 bytes): at full rate some
//     5 TB/s of weights from L2.  That, the shared-memory reads of B by
//     64-row `wgmma`, the formation of A between groups and the flushes
//     are what hold it below the tensor-core rate.
//   - Small batches: the plan (`kernels/cin.py::cin_plan`) splits the K
//     units over `splits` blocks (gridDim.z) when the row tiles do not fill
//     the card; the partials go to a scratch [splits, B, H, D] and are summed
//     in a fixed order by `cin_layer_kernel_sum_splits`: no float atomics,
//     so two calls give the same bits.
//
// C interface (loaded with ctypes): returns 0 on success, else the
// cudaError_t of the failing call (cudaErrorInvalidValue for a plan it cannot
// run or a tensor map it cannot encode, cudaErrorNotSupported when libcuda
// has no cuTensorMapEncodeTiled).  mode 0 runs the layer (prep, product, split
// sum); mode 1 only writes w_hi / w_lo.  The caller guarantees contiguous
// fp32 tensors, 16-byte aligned, the weight scratch [2, H_pad, K_pad] and,
// when splits > 1, the partial scratch [splits, B, H, D].
#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsWG = 64;                // rows n per warpgroup (wgmma m64)
constexpr int kWarpgroups = 2;
constexpr int kBM = kRowsWG * kWarpgroups;  // rows n per block
constexpr int kThreads = 128 * kWarpgroups;
static_assert(kWarpgroups == 2, "the ring's refill counts two frees a box");
constexpr int kBoxK = 32;                 // floats of k per TMA box: one 128-byte swizzle row
constexpr int kStepsPerBox = kBoxK / 8;   // k8 steps per box
constexpr int kChunkIb = 5;               // 8-wide i blocks per chunk (x0 in registers)
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;        // dynamic shared memory a block can use
constexpr int kPrepThreads = 256;

constexpr int kFlushUnits = 16;           // K units a tensor-core sum runs (at most 240 wgmma)

// Ring stages of an N-wide filter tile: as many [N x 32] box pairs (w_hi,
// w_lo) as fit beside the 1024-byte alignment slack and the barriers.
__host__ __device__ constexpr int stages_for(int n) {
  return (kSmemLimit - 1024 - 16 * kMaxStages) / (256 * n) < kMaxStages
             ? (kSmemLimit - 1024 - 16 * kMaxStages) / (256 * n)
             : kMaxStages;
}
__host__ __device__ constexpr int smem_for(int n) {
  return stages_for(n) * 256 * n + 1024 + 16 * stages_for(n);
}
static_assert(smem_for(200) <= kSmemLimit && stages_for(200) >= 2, "ring above 227 KB");

// L2 cache policy of the weight boxes (CUTLASS's CacheHintSm90::EVICT_LAST):
// every block of the grid reads them again.
constexpr uint64_t kEvictLast = 0x14F0000000000000ull;

struct Params {
  const float* x0;
  const float* xl;
  float* out;          // [B, H, D], or the scratch [splits, B, H, D]
  int64_t n_cols;      // B * D
  int f0, fl, h, d;
  int ib_total;        // 8-wide blocks of i: ceil(F0 / 8)
  int units;           // K units (chunk, j): chunks * Fl
  int splits;          // blocks sharing the K units of one tile (gridDim.z)
  int h_pad;           // rows of w_hi; w_lo follows at row h_pad
};

// First k8 step of unit u (u = c Fl + j): the chunks before c are full.
__device__ __forceinline__ int unit_step(int64_t u, int fl, int ib_total, int units) {
  if (u >= units) return fl * ib_total;
  const int c = static_cast<int>(u / fl);
  const int j = static_cast<int>(u - static_cast<int64_t>(c) * fl);
  const int nib = min(kChunkIb, ib_total - kChunkIb * c);
  return kChunkIb * fl * c + j * nib;
}

// Round to the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32),
// with two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

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

// 2-D TMA load of one box at (c0 = k, c1 = row) into shared memory.
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
// rows of 128 bytes (32 floats), 8-row groups 1024 bytes apart (SBO),
// layout type 1.  A k8 step inside the row adds 32 bytes to the address.
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
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x N] = A[64 x 8] . B[N x 8]^T (+ d unless scale_d is 0): A in
// registers (TF32 bit patterns, the m16n8k8 fragment of each warp), B
// K-major in shared memory; fp32 accumulator, register 4c + 2h + e at row
// 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<200>(float (&d)[100], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99"
      "}, {%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// The wgmma group of one K unit whose k8 steps are q .. q + nib - 1 (their
// boxes have landed): form z = x0 xl for the thread's fragment of each i
// block, split it into hi and lo, and issue lo.w_hi, hi.w_lo and hi.w_hi
// into the accumulator.  Nothing here branches: an i block past nib has
// x0 = 0, so its z is 0, and it reads the unit's last step of w.
template <int N>
__device__ __forceinline__ void issue_unit(float (&acc)[N / 2], uint32_t (&ah)[kChunkIb][4],
                                           uint32_t (&al)[kChunkIb][4],
                                           const float (&x0r)[kChunkIb][2][2],
                                           const float (&xc)[2], int q, int nib, int bx_lo,
                                           uint32_t base, int keep) {
  constexpr int kStages = stages_for(N);
  constexpr uint32_t kHalf = N * 128;
#pragma unroll
  for (int ib = 0; ib < kChunkIb; ++ib) {
    const float zv[4] = {x0r[ib][0][0] * xc[0], x0r[ib][1][0] * xc[1],
                         x0r[ib][0][1] * xc[0], x0r[ib][1][1] * xc[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[ib][e] = to_tf32(zv[e]);
      al[ib][e] = to_tf32(zv[e] - __uint_as_float(ah[ib][e]));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int ib = 0; ib < kChunkIb; ++ib) {
    const int qi = q + min(ib, nib - 1);
    const int rel = qi / kStepsPerBox - bx_lo;
    const uint32_t sb = base + (rel % kStages) * 2 * kHalf + (qi % kStepsPerBox) * 32;
    const uint64_t d_hi = smem_desc(sb);
    const uint64_t d_lo = smem_desc(sb + kHalf);
    wgmma_tf32<N>(acc, al[ib], d_hi, ib == 0 ? keep : 1);
    wgmma_tf32<N>(acc, ah[ib], d_lo, 1);
    wgmma_tf32<N>(acc, ah[ib], d_hi, 1);
  }
  wgmma_commit();
}

// Blocks stride over w_split [2, H_pad, K_pad]: w_hi, then w_lo, K-major in
// the kernel's K order (unit (c, j), then the chunk's i blocks, then 8 i),
// zero past H, F0 and the last k8 step.
__global__ void __launch_bounds__(kPrepThreads)
cin_layer_kernel_prep(const float* __restrict__ w, float* __restrict__ ws, int f0, int fl,
                      int h, int h_pad, int k_pad, int ib_total) {
  const int64_t total = static_cast<int64_t>(h_pad) * k_pad;
  const int steps = fl * ib_total;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int row = static_cast<int>(e / k_pad);
    const int k = static_cast<int>(e - static_cast<int64_t>(row) * k_pad);
    const int q = k >> 3;
    float v = 0.f;
    if (row < h && q < steps) {
      const int c = q / (kChunkIb * fl);
      const int r = q - c * kChunkIb * fl;
      const int nib = min(kChunkIb, ib_total - kChunkIb * c);
      const int j = r / nib;
      const int i = 8 * (kChunkIb * c + r - j * nib) + (k & 7);
      if (i < f0) v = w[(static_cast<int64_t>(row) * f0 + i) * fl + j];
    }
    const uint32_t hi = to_tf32(v);
    ws[e] = __uint_as_float(hi);
    ws[total + e] = __uint_as_float(to_tf32(v - __uint_as_float(hi)));
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
cin_layer_kernel(const __grid_constant__ CUtensorMap tm_w, const Params p) {
  constexpr int kStages = stages_for(N);
  constexpr uint32_t kHalf = N * 128;            // bytes of one [N x 32] box
  constexpr uint32_t kStageBytes = 2 * kHalf;    // w_hi box, then w_lo box
  extern __shared__ uint8_t smem_raw[];
  // stages 1024-aligned for the 128-byte swizzle; barriers and the
  // per-stage release counters after them
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  uint32_t* freed = reinterpret_cast<uint32_t*>(smem_raw + (bars + 8u * kStages -
                                                            smem_u32(smem_raw)));
  auto full = [&](int s) { return bars + 8u * s; };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;

  // this block's share of the K units, and the boxes that hold its k8 steps
  const int z = blockIdx.z;
  const int64_t u_lo = static_cast<int64_t>(z) * p.units / p.splits;
  const int64_t u_hi = static_cast<int64_t>(z + 1) * p.units / p.splits;
  const int q_lo = unit_step(u_lo, p.fl, p.ib_total, p.units);
  const int q_hi = unit_step(u_hi, p.fl, p.ib_total, p.units);
  const int bx_lo = q_lo / kStepsPerBox;
  const int bx_hi = (q_hi + kStepsPerBox - 1) / kStepsPerBox;
  const int row_hi = blockIdx.y * N;   // the tile's rows of w_hi; w_lo at h_pad + row_hi
  // box bx (w_hi and w_lo) into its stage, completing on the stage's barrier
  auto load_box = [&](int bx) {
    const int s = (bx - bx_lo) % kStages;
    mbar_expect_tx(full(s), kStageBytes);
    const uint32_t st = base + s * kStageBytes;
    tma_load(st, &tm_w, full(s), bx * kBoxK, row_hi, kEvictLast);
    tma_load(st + kHalf, &tm_w, full(s), bx * kBoxK, p.h_pad + row_hi, kEvictLast);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int bx = bx_lo; bx < bx_hi && bx < bx_lo + kStages; ++bx) load_box(bx);
  }
  __syncthreads();

  const int warp = t >> 5;
  const int lane = t & 31;
  const int tq = lane & 3;
  // the thread's two rows n (fragment rows g and g + 8 of its warp)
  const int64_t n_first = static_cast<int64_t>(blockIdx.x) * kBM + wg * kRowsWG + warp * 16 +
                          (lane >> 2);
  bool ok[2];
  int64_t x0_row[2], xl_row[2], out_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t n = n_first + 8 * r;
    ok[r] = n < p.n_cols;
    const int64_t b = ok[r] ? n / p.d : 0;
    const int64_t dd = ok[r] ? n - b * p.d : 0;
    x0_row[r] = b * p.f0 * p.d + dd;
    xl_row[r] = b * p.fl * p.d + dd;
    out_row[r] = b * p.h * p.d + dd;
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // The thread's outputs, out[b, h, d] for its two rows and N / 4 filters.
  // A flush stores acc there (the first) or adds it with fp32 reductions
  // (`red.global.add`, no load round trip).  Each output has one writer,
  // whose adds land in program order: two calls give the same bits.
  float* out = p.out + static_cast<int64_t>(z) * p.n_cols * p.h;
  const int h0 = blockIdx.y * N + 2 * tq;
  auto flush = [&](bool first) {
    // the row bases and D through opaque moves, so that the compiler
    // forms the N / 2 addresses here and not once, hoisted out of the K
    // loop into registers it does not have
    int64_t row[2];
    int dd;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      asm volatile("mov.b64 %0, %1;" : "=l"(row[r]) : "l"(out_row[r]));
    asm volatile("mov.b32 %0, %1;" : "=r"(dd) : "r"(p.d));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!ok[r]) continue;
#pragma unroll
      for (int cc = 0; cc < N / 8; ++cc)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int hh = h0 + 8 * cc + e;
          if (hh >= p.h) continue;
          float* dst = out + row[r] + static_cast<int64_t>(hh) * dd;
          const float v = acc[4 * cc + 2 * r + e];
          if (first) *dst = v;
          else atomicAdd(dst, v);
        }
    }
  };
  float x0r[kChunkIb][2][2];   // [i block][row][k t, t + 4] of the current chunk
  int chunk = -1, nib = 0;
  int c = static_cast<int>(u_lo / p.fl);
  int j = static_cast<int>(u_lo - static_cast<int64_t>(c) * p.fl);
  float xc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    xc[r] = ok[r] ? __ldg(p.xl + xl_row[r] + static_cast<int64_t>(j) * p.d) : 0.f;
  int q = q_lo;
  int box_waited = bx_lo - 1;  // last box whose full barrier this thread passed
  int box_freed = bx_lo;       // next box this warpgroup hands back
  // Every k8 step before q_done is complete: free the boxes below it.  The
  // second warpgroup to free a box refills its stage with the box kStages
  // further on (one thread of each warpgroup counts in `freed`).
  auto release = [&](int q_done) {
    for (; box_freed < q_done / kStepsPerBox; ++box_freed) {
      if (t == 0) {
        const int s = (box_freed - bx_lo) % kStages;
        __threadfence_block();
        if ((atomicAdd(&freed[s], 1u) & 1u) && box_freed + kStages < bx_hi) {
          __threadfence_block();
          load_box(box_freed + kStages);
        }
      }
    }
  };
  uint32_t ah[kChunkIb][4], al[kChunkIb][4];   // A of the unit's k8 steps, hi and lo
  fence_acc(acc);

  for (int64_t u = u_lo; u < u_hi; ++u) {
    if (c != chunk) {
      chunk = c;
      nib = min(kChunkIb, p.ib_total - kChunkIb * c);
#pragma unroll
      for (int ib = 0; ib < kChunkIb; ++ib)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            const int i = 8 * (kChunkIb * c + ib) + tq + 4 * tt;
            x0r[ib][r][tt] = ok[r] && ib < nib && i < p.f0
                                 ? __ldg(p.x0 + x0_row[r] + static_cast<int64_t>(i) * p.d)
                                 : 0.f;
          }
    }
    // the next unit's xl, loaded one unit ahead
    int c_next = c, j_next = j + 1;
    if (j_next == p.fl) {
      j_next = 0;
      ++c_next;
    }
    float xn[2] = {0.f, 0.f};
    if (u + 1 < u_hi) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (ok[r]) xn[r] = __ldg(p.xl + xl_row[r] + static_cast<int64_t>(j_next) * p.d);
    }
    // the boxes of the unit's steps have landed
    for (const int last = (q + nib - 1) / kStepsPerBox; box_waited < last;) {
      const int rel = ++box_waited - bx_lo;
      mbar_wait(full(rel % kStages), (rel / kStages) & 1);
    }
    // the unit's 15 products in one wgmma group; while they run, no other
    // instruction of this warpgroup touches a register (ptxas would
    // otherwise serialise every wgmma), and the other warpgroup's group
    // keeps the tensor cores busy while this one forms its next A
    // Every kFlushUnits units the tensor cores' sum (rounded toward zero at
    // each wgmma, see the header) is added into the block's outputs in
    // fp32 and starts afresh.
    const int64_t seg = (u - u_lo) % kFlushUnits;
    issue_unit<N>(acc, ah, al, x0r, xc, q, nib, bx_lo, base, seg != 0);
    wgmma_wait_all();
    if (seg == kFlushUnits - 1 || u + 1 == u_hi) {
      fence_acc(acc);
      flush(u - u_lo < kFlushUnits);
    }
    q += nib;
    release(q);
    c = c_next;
    j = j_next;
    xc[0] = xn[0];
    xc[1] = xn[1];
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

template <int N>
cudaError_t launch_tile(const CUtensorMap& tm, const Params& p, int m_tiles, int n_tiles,
                        cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      cin_layer_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_for(N));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m_tiles), static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(p.splits));
  cin_layer_kernel<N><<<grid, kThreads, smem_for(N), s>>>(tm, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cin_layer_launch(const void* x0, const void* xl, const void* w, void* out,
                                void* w_split, void* part, int64_t b, int f0, int fl,
                                int h, int d, int n_tile, int splits, int mode,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_cols = b * d;
  if ((n_cols <= 0 || h <= 0) && mode == 0) return static_cast<int>(cudaGetLastError());
  const int ib_total = (f0 + 7) / 8;
  const int chunks = (ib_total + kChunkIb - 1) / kChunkIb;
  const int units = chunks * fl;
  const int n_tiles = (h + n_tile - 1) / n_tile;
  const int h_pad = n_tiles * n_tile;
  const int steps = fl * ib_total;
  const int k_pad = (steps + kStepsPerBox - 1) / kStepsPerBox * kBoxK;
  const bool n_ok =
      n_tile == 16 || n_tile == 32 || n_tile == 64 || n_tile == 128 || n_tile == 200;
  if (f0 < 1 || fl < 1 || h < 1 || d < 1 || !n_ok || splits < 1 || splits > units ||
      (mode == 0 && splits > 1 && part == nullptr) || w_split == nullptr ||
      (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);

  const int64_t w_total = static_cast<int64_t>(h_pad) * k_pad;
  const int64_t prep_blocks =
      std::min<int64_t>((w_total + kPrepThreads - 1) / kPrepThreads, 132 * 16);
  cin_layer_kernel_prep<<<static_cast<unsigned>(prep_blocks), kPrepThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(w_split), f0, fl, h, h_pad, k_pad,
      ib_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || mode == 1) return static_cast<int>(err);

  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad), static_cast<cuuint64_t>(2 * h_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBoxK), static_cast<cuuint32_t>(n_tile)};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, w_split, dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.x0 = static_cast<const float*>(x0);
  p.xl = static_cast<const float*>(xl);
  p.out = static_cast<float*>(splits > 1 ? part : out);
  p.n_cols = n_cols;
  p.f0 = f0;
  p.fl = fl;
  p.h = h;
  p.d = d;
  p.ib_total = ib_total;
  p.units = units;
  p.splits = splits;
  p.h_pad = h_pad;
  const int m_tiles = static_cast<int>((n_cols + kBM - 1) / kBM);
  switch (n_tile) {
    case 16: err = launch_tile<16>(tm, p, m_tiles, n_tiles, s); break;
    case 32: err = launch_tile<32>(tm, p, m_tiles, n_tiles, s); break;
    case 64: err = launch_tile<64>(tm, p, m_tiles, n_tiles, s); break;
    case 128: err = launch_tile<128>(tm, p, m_tiles, n_tiles, s); break;
    default: err = launch_tile<200>(tm, p, m_tiles, n_tiles, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int64_t total = n_cols * h;
    const int64_t blocks = std::min<int64_t>((total + 255) / 256, 132 * 16);
    cin_layer_kernel_sum_splits<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(out), total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
