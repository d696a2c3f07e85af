// The Hopper GEMM of the eval block chain (block_chain.cuh: kernels #1, #3
// and #4, and gemm.cu), of the attention kernel #2 (attention.cu), and of
// the training forward's four products (kernel #5) and the training
// backward's data gradients (kernel #6) in block_train.cu:
//
//   Y[m, n] = TY(epilogue(sum_k prologue(A)[m, k] * w(W[n, k]) + b[n]))
//
// with the rounding points of _block_body's dot2d products: the LayerNorm
// prologue normalises each row of A in f32 and rounds it to T, the weights
// enter the product rounded to T (for T = float: unrounded), sums
// accumulate in f32, and the epilogue (common.cuh) adds the bias, applies
// the exact (erff) GELU or adds the residual R to the product rounded to
// TY; for the data gradients, stores the bare product or multiplies it by
// gelu'(R); for the training forward, stores the biased product and its
// GELU (two outputs), or adds the product scaled by its sequence's branch
// mask to R.  A is (M, K) in T (float or bfloat16), Y (M, N) in TY (T
// unless a caller asks otherwise: #2 stores f32 products of a bf16 x and
// bf16 products of f32 attention output), R (M, N) in TR (TY unless asked:
// #5 adds f32 products to a bf16 x), W is (N, K) f32 in torch's Linear
// layout; a weight stored (K, N) is split transposed
// (split_weights_t_kernel).
//
// What bounds it on an H100 (data-sheet peaks at 700 W): scalar f32 FMAs
// peak at 67 TFLOP/s; this GEMM runs on wgmma:
//   float32   three TF32 products a_hi*w_hi + a_hi*w_lo + a_lo*w_hi per
//             product (m64nNk8, f32 accumulation), where x_hi = tf32(x) and
//             x_lo = tf32(x - x_hi): a float32-accurate product (the
//             dropped a_lo*w_lo is ~2^-22 relative) at up to 495/3 = 165
//             TFLOP/s, where one TF32 product would miss the block's 1e-4
//             bound ~5x.  At the block widths (K = C..2C = 224..768, N =
//             C..3C) that is hundreds of FLOPs per byte: tensor-bound.
//   bfloat16  one bf16 product (m64nNk16, f32 accumulation): the TPU
//             kernel's own contract (operands in the compute dtype).  At
//             989 TFLOP/s the same widths are 130-220 FLOPs per byte of A,
//             R and Y, below the card's ~295: bound by the bytes, and by
//             how fast the epilogue turns accumulators into stores.
//
// Design, float32 (gemm_kernel).  A persistent CTA per SM walks 128 x BN
// output tiles (BN = 128, or 112 where N is a multiple of 112 and not of
// 128: the face widths 224, 448, 672 tile without waste) with 288 threads:
// two consumer warpgroups of 64 rows each and one producer warp.  The
// producer's lane 0 keeps a ring of three stages of 128-byte-swizzled
// shared-memory slices full with TMA loads (the A slice, 128 rows x 128
// bytes, and the weight slices' hi and lo, BN rows x 128 bytes each),
// completed on mbarriers, running ahead into the next tile while the
// consumers store.  A consumer warpgroup makes its 64 rows of each A slice
// the product's operand in shared memory (the LayerNorm from a pre-pass's
// row statistics, row_stats_kernel, and the TF32 split: hi in place, lo
// beside it), then issues shared-memory wgmmas into partial sums,
// preparing the next slice while they run.  The partial sums of each pair
// of slices (24 TF32 wgmmas) are added to the accumulators in f32 FADDs,
// because the tensor cores' f32 accumulation truncates: summed over a
// whole K of 768 in the tensor cores, the error reached ~1e-5 of O(1)
// outputs on an H100 80GB HBM3 (700 W).  With 288 threads a thread may
// hold 224 registers; the accumulators and partial sums take 128 (BN =
// 128), and nothing spills.  The epilogue stores from the accumulators and
// masks rows >= M and columns >= N.
//
// Design, bfloat16 (gemm_bf16_kernel, below): the same CTA and ring, but
// a pure TMA -> wgmma loop (a LayerNorm is a rounding pre-pass, ln_gemm),
// one f32 accumulator over the whole K with one wgmma group in flight
// (the truncating accumulation's ~1e-5 at K = 768 is under 1/700 of a
// bf16 ulp at 1.0),
// tiles as wide as N allows (BN = 256, 224 or 192; 128 for GELU), and an
// epilogue through shared memory and TMA bulk stores.
//
// Both: the weights are rounded (bf16) or split (TF32 hi/lo) once per call
// by split_weights_kernel into a workspace the caller allocates.  TMA
// zero-fills the ragged M and K edges and the N edge of the weights.  No
// split-K: every sum has one fixed order, so results repeat bit for bit.
// The tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so nothing new
// is linked) and passed as __grid_constant__ parameters; a failed encode is
// returned as an error.
//
// What it reaches (chip_smoke.py's gemm_kernel phase, the four stages of
// each part at serve bucket 16, summed; H100 80GB HBM3 at 700 W): float32
// ~45-74 TFLOP/s of float32-accurate products, a third to a half of the
// 165 TFLOP/s bound, ahead of cuBLAS SGEMM (~47 TFLOP/s); bf16 ~255
// TFLOP/s with the weight split and the LayerNorm pre-passes (113 before
// this design; chip_ab.py's kernel A/B), ~315 for the GEMM kernels alone
// (kernel #1's four GEMMs in chip_smoke.py's kernel_stages), four fifths
// of cuBLAS's F.linear (PERF.md section 6).
// By count, a CTA's f32 slice moves ~240 KB through shared memory (TMA,
// the split, wgmma reading both operands): ~1900 cycles at 128 bytes a
// cycle, more than the slice's 1536 tensor-core cycles, so A taken from
// registers is the next step there.

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace sm90 {

constexpr int BM = 128;               // rows per CTA: two consumer warpgroups
constexpr int THREADS = 288;          // two consumer warpgroups + producer warp
constexpr int SLICE_BYTES = 128;      // K bytes per slice: one swizzle row
constexpr int A_TILE = BM * SLICE_BYTES;        // 16 KB
constexpr int W_TILE = 128 * SLICE_BYTES;       // room for BN <= 128 rows
constexpr int MAX_STAGES = 4;
constexpr int MAX_LN_K = 1024;        // LayerNorm prologue: K <= MAX_LN_K

// A stage of the f32 kernel holds the A slice (its TF32 hi half in place of
// the values and the lo half beside it) and the weight slices (hi and lo);
// for bf16 only BK and NT are read (the operand maps, the weight split).
template <typename T> struct Cfg {
  static constexpr int BK = SLICE_BYTES / (int)sizeof(T);   // 32 f32, 64 bf16
  static constexpr int NT = sizeof(T) == 4 ? 2 : 1;         // tiles per operand
  static constexpr int W_OFF = NT * A_TILE;
  static constexpr int STAGE = NT * (A_TILE + W_TILE);
  static constexpr int STAGES = 3;
  // stages, LayerNorm scale and bias, barriers, 1 KB for the alignment
  static constexpr int SMEM = STAGES * STAGE + 2 * MAX_LN_K * 4 + 2 * MAX_STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of `parity` to complete.  A wait that lasts ~10 s
// (a lost TMA transfer) traps, so a fault ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand tile in 128-byte-swizzled shared
// memory: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the tile
// 1024-byte aligned; stepping 32 bytes along K adds 2 to the address field.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define PAFUSE_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define PAFUSE_D56                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55"

// d[BN/2] = A(64 x 8) * B(8 x BN) + (scale_d ? d : 0) in TF32 (m64nBNk8),
// both operands K-major in 128-byte-swizzled shared memory (descriptors a
// and b): the f32 kernel's product.
template <int BN> struct Wgmma;

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " PAFUSE_D56
        ", %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}"
        : PAFUSE_F8(0), PAFUSE_F8(8), PAFUSE_F8(16), PAFUSE_F8(24), PAFUSE_F8(32),
          PAFUSE_F8(40), PAFUSE_F8(48), PAFUSE_F8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<112> {
  static __device__ __forceinline__ void tf32(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 " PAFUSE_D56
        "}, %56, %57, p, 1, 1;\n}"
        : PAFUSE_F8(0), PAFUSE_F8(8), PAFUSE_F8(16), PAFUSE_F8(24), PAFUSE_F8(32),
          PAFUSE_F8(40), PAFUSE_F8(48)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// d[N/2] = A(64 x 16) * B(16 x N) + (scale_d ? d : 0) in bf16 (m64nNk16, f32
// accumulation), both operands K-major in 128-byte-swizzled shared memory:
// the bf16 kernel's product.  REGS: the PTX list of the N/2 accumulator
// registers and the two descriptors, SCALE: the scale_d operand.
template <int N> struct WgmmaBf16;

#define PAFUSE_F16(i) PAFUSE_F8(i), PAFUSE_F8(i + 8)
#define PAFUSE_R16(a, b, c, d, e, f, g, h, i, j, k, l, m, n, o, p)                      \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i ", %" #j \
  ", %" #k ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p
#define PAFUSE_R64                                                                     \
  PAFUSE_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "                \
  PAFUSE_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31) ", "      \
  PAFUSE_R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47) ", "      \
  PAFUSE_R16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63)
#define PAFUSE_R128                                                                    \
  PAFUSE_R64 ", "                                                                      \
  PAFUSE_R16(64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79) ", "      \
  PAFUSE_R16(80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95) ", "      \
  PAFUSE_R16(96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111) \
  ", " PAFUSE_R16(112, 113, 114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, \
                 126, 127)

#define PAFUSE_WGMMA_BF16(N, REGS, SCALE, ...)                                          \
  template <> struct WgmmaBf16<N> {                                                     \
    static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,        \
                                               int scale_d) {                           \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                   \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS    \
                   ", p, 1, 1, 0, 0;\n}"                                                \
                   : __VA_ARGS__                                                        \
                   : "l"(a), "l"(b), "r"(scale_d));                                     \
    }                                                                                   \
  };

PAFUSE_WGMMA_BF16(128, PAFUSE_R64 "}, %64, %65", "%66", PAFUSE_F16(0), PAFUSE_F16(16),
                  PAFUSE_F16(32), PAFUSE_F16(48))
PAFUSE_WGMMA_BF16(96, PAFUSE_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
                  PAFUSE_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)
                  ", " PAFUSE_R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
                                  47) "}, %48, %49",
                  "%50", PAFUSE_F16(0), PAFUSE_F16(16), PAFUSE_F16(32))
PAFUSE_WGMMA_BF16(256, PAFUSE_R128 "}, %128, %129", "%130", PAFUSE_F16(0), PAFUSE_F16(16),
                  PAFUSE_F16(32), PAFUSE_F16(48), PAFUSE_F16(64), PAFUSE_F16(80),
                  PAFUSE_F16(96), PAFUSE_F16(112))
PAFUSE_WGMMA_BF16(224, PAFUSE_R64 ", "
                  PAFUSE_R16(64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79)
                  ", " PAFUSE_R16(80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94,
                                  95) ", "
                  PAFUSE_R16(96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108,
                             109, 110, 111) "}, %112, %113",
                  "%114", PAFUSE_F16(0), PAFUSE_F16(16), PAFUSE_F16(32), PAFUSE_F16(48),
                  PAFUSE_F16(64), PAFUSE_F16(80), PAFUSE_F16(96))
PAFUSE_WGMMA_BF16(192, PAFUSE_R64 ", "
                  PAFUSE_R16(64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79)
                  ", " PAFUSE_R16(80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94,
                                  95) "}, %96, %97",
                  "%98", PAFUSE_F16(0), PAFUSE_F16(16), PAFUSE_F16(32), PAFUSE_F16(48),
                  PAFUSE_F16(64), PAFUSE_F16(80))
#undef PAFUSE_WGMMA_BF16
#undef PAFUSE_R128
#undef PAFUSE_R64
#undef PAFUSE_R16
#undef PAFUSE_F16
#undef PAFUSE_F8
#undef PAFUSE_D56

// ---------------------------------------------------------------------------
// The weights in the product's operand type, once per call: f32 -> TF32 hi
// and lo halves (hi + lo == w to ~2^-22), bf16 -> w rounded to bf16 (lo
// unused).  n elements of W (out, in) keep their layout.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float w, float& hi, float& lo) {
  hi = __uint_as_float(tf32_bits(w));
  lo = __uint_as_float(tf32_bits(w - hi));
}

template <typename T>
__global__ void split_weights_kernel(const float* __restrict__ W, T* __restrict__ hi,
                                     T* __restrict__ lo, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float w = W[i];
    if constexpr (sizeof(T) == 4) {
      split_tf32(w, hi[i], lo[i]);
    } else {
      hi[i] = from_f32<T>(w);
    }
  }
}

// The f32 split of a weight stored (rows, cols) = (K, N), as a data gradient
// Y = A W takes it, into hi and lo (N, K): the K-major operand that TF32
// wgmma needs (its transposing layouts exist only for 16-bit types).  32 x
// 32 tiles through shared memory, so reads and writes are both coalesced.
constexpr int SPLIT_T_TILE = 32;

__global__ void __launch_bounds__(SPLIT_T_TILE * 8)
split_weights_t_kernel(const float* __restrict__ W, float* __restrict__ hi,
                       float* __restrict__ lo, int rows, int cols) {
  __shared__ float tile[SPLIT_T_TILE][SPLIT_T_TILE + 1];
  const int r0 = blockIdx.y * SPLIT_T_TILE, c0 = blockIdx.x * SPLIT_T_TILE;
  for (int i = threadIdx.y; i < SPLIT_T_TILE; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = W[(long long)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < SPLIT_T_TILE; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < rows && c < cols) {
      const long long o = (long long)c * rows + r;
      split_tf32(tile[threadIdx.x][i], hi[o], lo[o]);
    }
  }
}

// Row statistics of the LayerNorm prologue: stats[m] = (mean, rstd) of row
// m of X (M, K), two-pass in f32 with eps 1e-6, one warp per row (the
// arithmetic of common.cuh's layernorm_kernel).
constexpr int STATS_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
row_stats_kernel(const T* __restrict__ X, float2* __restrict__ stats, long long M, int K) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* row = X + m * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f32<T>(row[k]);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f32<T>(row[k]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)K + kLnEps);
  if (lane == 0) stats[m] = make_float2(mean, rstd);
}

// ---------------------------------------------------------------------------
// The GEMM kernel (see the top of the file).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ln_apply(float a, float2 st, float s, float b) {
  return (a - st.x) * st.y * s + b;
}

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float tf32_round(float v) { return __uint_as_float(tf32_bits(v)); }

// Operands of the training forward's epilogues, unread by the others:
// EPI_MASK_RESIDUAL scales row m's product by mask[m / L], EPI_STORE_GELU
// stores gelu(Y) into Y2 (M, N) f32.
struct EpiExtra {
  const float* mask = nullptr;
  float* Y2 = nullptr;
  int L = 1;
};

// Make one consumer warpgroup's 64 rows of an f32 A slice in shared memory
// the product's operand: the LayerNorm (PRO_LAYERNORM) and the TF32 split,
// hi in place and lo into the stage's second A tile.  Thread i of the warpgroup takes the 16-byte chunks i + 128 j
// (j < 4): row (i + 128 j) / 8 of the 64, physical chunk i % 8, which
// holds K columns (i % 8 ^ row % 8) * 16 bytes on (the 128-byte swizzle).
// st[j]: that row's (mean, rstd).  Ends with the proxy fence and the
// warpgroup's barrier that make the tiles visible to its wgmmas.
template <int PRO>
__device__ __forceinline__ void transform_slice(uint8_t* stage, int wg, int tid,
                                                const float2 (&st)[4], const float* lns,
                                                const float* lnb, int kb) {
  uint8_t* a = stage + wg * (A_TILE / 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = tid + 128 * j, row = idx >> 3, phys = idx & 7;
    const int chunk = phys ^ (row & 7);
    uint8_t* p = a + row * SLICE_BYTES + phys * 16;
    float v[4];
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
    if (PRO == PRO_LAYERNORM) {
      const int k = kb + chunk * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = ln_apply(v[q], st[j], lns[k + q], lnb[k + q]);
    }
    float hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = tf32_round(v[q]);
      lo[q] = tf32_round(v[q] - hi[q]);
    }
    *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(hi);
    *reinterpret_cast<float4*>(p + A_TILE) = *reinterpret_cast<const float4*>(lo);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// Issue one f32 slice's wgmmas for a warpgroup's 64 rows into part (the
// first overwrites it when `fresh`, else they add to it), smallest products
// first, as one commit group.
template <int BN>
__device__ __forceinline__ void issue_slice(float (&part)[BN / 2], const uint8_t* stage,
                                            int wg, bool fresh) {
  const uint8_t* a = stage + wg * (A_TILE / 2);
  const uint8_t* w = stage + Cfg<float>::W_OFF;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = smem_desc(a) + 2 * kk, dw = smem_desc(w) + 2 * kk;
    const uint64_t dal = smem_desc(a + A_TILE) + 2 * kk;
    const uint64_t dwl = smem_desc(w + W_TILE) + 2 * kk;
    Wgmma<BN>::tf32(part, dal, dw, kk > 0 || !fresh);     // a_lo * w_hi
    Wgmma<BN>::tf32(part, da, dwl, 1);          // a_hi * w_lo
    Wgmma<BN>::tf32(part, da, dw, 1);           // a_hi * w_hi
  }
  wgmma_commit();
}

template <typename T, typename TY, typename TR, int BN, int PRO, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_wlo, const float* __restrict__ bias,
            const float* __restrict__ ln_s, const float* __restrict__ ln_b,
            const float2* __restrict__ stats, const TR* __restrict__ R, TY* __restrict__ Y,
            int M, int N, int K, const EpiExtra ex) {
  static_assert(sizeof(T) == 4, "bf16 A runs on gemm_bf16_kernel");
  using Cf = Cfg<T>;
  constexpr int STAGES = Cf::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* lns = reinterpret_cast<float*>(smem + STAGES * Cf::STAGE);
  float* lnb = lns + MAX_LN_K;
  uint64_t* full = reinterpret_cast<uint64_t*>(lnb + MAX_LN_K);
  uint64_t* empty = full + MAX_STAGES;

  const int nk = (K + Cf::BK - 1) / Cf::BK;
  const int n_tiles = (N + BN - 1) / BN, tiles = n_tiles * ((M + BM - 1) / BM);
  if (PRO == PRO_LAYERNORM) {
    // zero past K, where TMA zero-fills A and W: the padded columns stay 0
    for (int k = threadIdx.x; k < nk * Cf::BK; k += THREADS) {
      lns[k] = k < K ? ln_s[k] : 0.f;
      lnb[k] = k < K ? ln_b[k] : 0.f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Persistent: the CTA takes tiles blockIdx.x, + gridDim.x, ..., the N
  // tiles of one row tile next to each other (they share its A rows in
  // L2); it counts slices over all its tiles for the ring's stages and
  // phases, so the producer loads the next tile while the consumers store.
  if (threadIdx.x >= 256) {
    // producer warp: lane 0 keeps the ring full
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          uint8_t* st = smem + s * Cf::STAGE;
          mbar_expect_tx(&full[s], A_TILE + Cf::NT * BN * SLICE_BYTES);
          tma_load_2d(st, &tm_a, &full[s], ks * Cf::BK, m0);
          tma_load_2d(st + Cf::W_OFF, &tm_w, &full[s], ks * Cf::BK, n0);
          if (Cf::NT == 2)
            tma_load_2d(st + Cf::W_OFF + W_TILE, &tm_wlo, &full[s], ks * Cf::BK, n0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  // the accumulator rows of this thread (wgmma's layout): r0 and r0 + 8
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4, t = lane % 4;
  float acc[BN / 2], part[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, it += nk) {
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
    float2 st[4];                       // the rows transform_slice takes
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wg * 64 + tid / 8 + 16 * j;
      st[j] = PRO == PRO_LAYERNORM && m < M ? stats[m] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // Slices go to the tensor cores in pairs summed in part: slice ks + 1
    // is prepared while slice ks's wgmmas run and chained onto them, slice
    // ks + 2 while those of ks + 1 run; each stage is handed back as soon
    // as its wgmmas are done.  Then part is added to acc in f32 (round to
    // nearest: the tensor cores' own accumulation truncates, so each
    // partial sum spans at most two slices).
    auto stage = [&](int i) { return smem + (i % STAGES) * Cf::STAGE; };
    auto ready = [&](int i, int ks) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      transform_slice<PRO>(stage(i), wg, tid, st, lns, lnb, ks * Cf::BK);
    };
    auto release = [&](int i) {
      if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    };
    ready(it, 0);
    issue_slice<BN>(part, stage(it), wg, true);
#pragma unroll 1
    for (int ks = 0; ks < nk; ks += 2) {
      const int i = it + ks;
      if (ks + 1 < nk) {
        ready(i + 1, ks + 1);
        issue_slice<BN>(part, stage(i + 1), wg, false);
        wgmma_wait<1>();
        release(i);
        if (ks + 2 < nk) ready(i + 2, ks + 2);
        wgmma_wait<0>();
        release(i + 1);
      } else {
        wgmma_wait<0>();
        release(i);
      }
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) acc[q] += part[q];
      if (ks + 2 < nk) issue_slice<BN>(part, stage(i + 2), wg, true);
    }

    // epilogue: accumulator 4j + 2h + {0, 1} is (row r0 + 8h, col 8j + 2t + {0, 1})
    constexpr bool BIAS = EPI == EPI_STORE || EPI == EPI_GELU || EPI == EPI_RESIDUAL ||
                          EPI == EPI_MASK_RESIDUAL || EPI == EPI_STORE_GELU;
    float mk[2] = {0.f, 0.f};           // the rows' branch masks
    if constexpr (EPI == EPI_MASK_RESIDUAL) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        mk[h] = m < M ? ex.mask[m / ex.L] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;             // N % 8 == 0, so n + 1 < N as well
      const float b0 = BIAS ? bias[n] : 0.f, b1 = BIAS ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = (long long)m0 + r0 + 8 * h;
        if (m >= M) continue;
        float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
        if (BIAS) {
          y0 += b0;
          y1 += b1;
        }
        if (EPI == EPI_GELU) {
          y0 = gelu(y0);
          y1 = gelu(y1);
        }
        if (EPI == EPI_RESIDUAL) {
          const float2 r = load2<TR>(R + m * N + n);
          y0 = r.x + round_to<TY>(y0);
          y1 = r.y + round_to<TY>(y1);
        }
        if (EPI == EPI_GELU_GRAD) {
          const float2 u = load2<TR>(R + m * N + n);
          y0 *= gelu_grad(u.x);
          y1 *= gelu_grad(u.y);
        }
        if constexpr (EPI == EPI_MASK_RESIDUAL) {
          const float2 r = load2<TR>(R + m * N + n);
          y0 = r.x + mk[h] * y0;
          y1 = r.y + mk[h] * y1;
        }
        if constexpr (EPI == EPI_STORE_GELU) store2<float>(ex.Y2 + m * N + n, gelu(y0), gelu(y1));
        store2<TY>(Y + m * N + n, y0, y1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 GEMM kernel: Y = T(epilogue(A @ W^T + b)) with A, W, R and Y in
// bf16 (EPI_STORE, EPI_GELU or EPI_RESIDUAL).  A pure TMA -> wgmma loop: A
// comes already normalised (a LayerNorm is ln_gemm's pre-pass), so no
// consumer touches a slice, and one f32 accumulator takes the whole K with
// one wgmma group in flight (the group of slice ks - 1 retires while that
// of ks runs, and only then is its stage handed back).  Both consumer
// warpgroups share each 128 x BN tile, 64 rows each (m64nBNk16, BN / 2
// accumulator registers a thread).
//
// The epilogue goes through shared memory: each thread writes its
// accumulator pairs, biased, activated and rounded, into the tile buffer
// (32-column blocks of 128 rows x 64 bytes, 64-byte swizzled, so a warp's
// 8 rows x 16 bytes land in 32 distinct banks), and one thread of each
// warpgroup stores its 64 rows with TMA bulk stores, which clip the ragged
// M and N edges.  The residual R arrives the same way: the producer loads
// the tile's R into the buffer with TMA (once the previous tile's stores
// have read it), and each thread reads its pairs where it then writes.
// ---------------------------------------------------------------------------

constexpr int SMEM_LIMIT = 232448;     // shared memory a CTA may use on sm_90
constexpr int BF16_MAX_STAGES = 8;
constexpr int EPI_BLOCK = BM * 64;     // 32 bf16 columns x 128 rows

template <int BN> struct Bf16Cfg {
  static_assert(BN % 32 == 0, "the epilogue stores 32-column blocks");
  static constexpr int STAGE = A_TILE + BN * SLICE_BYTES;   // A + W slices
  static constexpr int BUF = (BN / 32) * EPI_BLOCK;         // the Y / R tile
  static constexpr int FIT = (SMEM_LIMIT - BUF - 2048) / STAGE;
  static constexpr int STAGES = FIT < BF16_MAX_STAGES ? FIT : BF16_MAX_STAGES;
  // stages, the tile buffer, barriers and 1 KB for the alignment
  static constexpr int SMEM = STAGES * STAGE + BUF + 2048;
};

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_r,
                 const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ bias,
                 int M, int N, int K) {
  using T = __nv_bfloat16;
  using Cf = Bf16Cfg<BN>;
  constexpr int STAGES = Cf::STAGES, BK = SLICE_BYTES / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* buf = smem + STAGES * Cf::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + Cf::BUF);
  uint64_t* empty = full + BF16_MAX_STAGES;
  uint64_t* r_full = empty + BF16_MAX_STAGES;    // R is in the buffer
  uint64_t* r_free = r_full + 1;                 // the tile's stores have read it

  const int nk = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN, tiles = n_tiles * ((M + BM - 1) / BM);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // one arrival per consumer warp
    }
    mbar_init(r_full, 1);
    mbar_init(r_free, 2);             // one arrival per consumer warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Persistent, as gemm_kernel: the CTA takes tiles blockIdx.x, +
  // gridDim.x, ..., the N tiles of one row tile next to each other.
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      int it = 0, jj = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++jj) {
        const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          uint8_t* st = smem + s * Cf::STAGE;
          mbar_expect_tx(&full[s], Cf::STAGE);
          tma_load_2d(st, &tm_a, &full[s], ks * BK, m0);
          tma_load_2d(st + A_TILE, &tm_w, &full[s], ks * BK, n0);
          // R once the ring holds the tile's first slices (waiting for the
          // last tile's stores then blocks nothing the ring could take)
          if (EPI == EPI_RESIDUAL && ks == (nk < STAGES ? nk : STAGES) - 1) {
            if (jj > 0) mbar_wait(r_free, (jj - 1) & 1);
            mbar_expect_tx(r_full, Cf::BUF);
            for (int b = 0; b < BN / 32; ++b)
              tma_load_2d(buf + b * EPI_BLOCK, &tm_r, r_full, n0 + 32 * b, m0);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  // the accumulator rows of this thread (wgmma's layout): r0 and r0 + 8
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4, t = lane % 4;
  // its pairs in the tile buffer: 16-byte chunk q of row r sits at chunk
  // q ^ ((r >> 1) & 3) (the 64-byte swizzle; r0 and r0 + 8 share it)
  uint8_t* mine = buf + r0 * 64 + 4 * t;
  const int sw = (r0 >> 1) & 3;
  float acc[BN / 2];
  int jj = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++jj) {
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM, it = jj * nk;
#pragma unroll 1
    for (int ks = 0; ks < nk; ++ks) {
      const int i = it + ks;
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      const uint8_t* st = smem + (i % STAGES) * Cf::STAGE;
      const uint64_t da = smem_desc(st + wg * (A_TILE / 2)), dw = smem_desc(st + A_TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16<BN>::mma(acc, da + 2 * kk, dw + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it + nk - 1) % STAGES]);

    // epilogue: accumulator 4c + 2h + {0, 1} is (row r0 + 8h, col 8c + 2t +
    // {0, 1}), in 32-column block c / 4, chunk c % 4
    if (EPI == EPI_RESIDUAL) {
      mbar_wait(r_full, jj & 1);
    } else if (jj > 0) {
      if (tid == 0) bulk_wait_read();   // the last tile's stores have read the buffer
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int n = n0 + 8 * c + 2 * t;
      const float b0 = n < N ? bias[n] : 0.f, b1 = n < N ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* p = reinterpret_cast<uint32_t*>(mine + (c / 4) * EPI_BLOCK +
                                                  (((c % 4) ^ sw) * 16) + h * 512);
        float y0 = acc[4 * c + 2 * h] + b0, y1 = acc[4 * c + 2 * h + 1] + b1;
        if (EPI == EPI_GELU) {
          y0 = gelu(y0);
          y1 = gelu(y1);
        }
        if (EPI == EPI_RESIDUAL) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          y0 = r.x + round_to<T>(y0);
          y1 = r.y + round_to<T>(y1);
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
        *p = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      for (int b = 0; b < BN / 32; ++b)
        tma_store_2d(&tm_y, buf + b * EPI_BLOCK + wg * (EPI_BLOCK / 2), n0 + 32 * b,
                     m0 + 64 * wg);
      bulk_commit();
      if (EPI == EPI_RESIDUAL) {
        bulk_wait_read();
        mbar_arrive(r_free);
      }
    }
  }
  if (tid == 0) bulk_wait();            // shared memory outlives the stores
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches.  Every function returns the first
// error (a failed tensor-map encode is cudaErrorInvalidValue) or
// cudaSuccess; nothing allocates or synchronises.
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major (rows, cols) T matrix in boxes of box_rows rows x
// box_cols columns, swizzled as asked, zero-filled out of bounds (and
// clipped there when stored).
template <typename T>
cudaError_t encode_box(CUtensorMap* map, const void* base, long long rows, int cols,
                       int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map,
                        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a GEMM operand: boxes of box_rows rows x one 128-byte slice,
// 128-byte swizzled.
template <typename T>
cudaError_t encode_tile(CUtensorMap* map, const void* base, long long rows, int cols,
                        int box_rows) {
  return encode_box<T>(map, base, rows, cols, Cfg<T>::BK, box_rows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// W (n floats) -> hi (and lo for f32) in T
template <typename T>
cudaError_t split_weights(const float* W, T* hi, T* lo, long long n, cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  split_weights_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      W, hi, lo, n);
  return cudaGetLastError();
}

// W (rows, cols) f32 -> the TF32 halves hi and lo of W^T (cols, rows)
inline cudaError_t split_weights_t(const float* W, float* hi, float* lo, int rows, int cols,
                                   cudaStream_t stream) {
  const dim3 grid((unsigned)((cols + SPLIT_T_TILE - 1) / SPLIT_T_TILE),
                  (unsigned)((rows + SPLIT_T_TILE - 1) / SPLIT_T_TILE));
  split_weights_t_kernel<<<grid, dim3(SPLIT_T_TILE, 8), 0, stream>>>(W, hi, lo, rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t row_stats(const T* X, float2* stats, long long M, int K, cudaStream_t stream) {
  constexpr int rows = STATS_THREADS / 32;
  row_stats_kernel<T><<<(unsigned)((M + rows - 1) / rows), STATS_THREADS, 0, stream>>>(
      X, stats, M, K);
  return cudaGetLastError();
}

template <typename T, typename TY, typename TR, int BN, int PRO, int EPI>
cudaError_t launch_gemm_bn(const T* A, const T* w_hi, const T* w_lo, const float* bias,
                           const float* ln_s, const float* ln_b, const float2* stats,
                           const TR* R, TY* Y, long long M, int N, int K, cudaStream_t stream,
                           const EpiExtra& ex) {
  CUtensorMap ma, mw, mwl;
  cudaError_t e;
  if ((e = encode_tile<T>(&ma, A, M, K, BM)) != cudaSuccess) return e;
  if ((e = encode_tile<T>(&mw, w_hi, N, K, BN)) != cudaSuccess) return e;
  if ((e = encode_tile<T>(&mwl, w_lo != nullptr ? w_lo : w_hi, N, K, BN)) != cudaSuccess)
    return e;
  auto kernel = gemm_kernel<T, TY, TR, BN, PRO, EPI>;
  constexpr int smem = Cfg<T>::SMEM;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);    // persistent
  kernel<<<grid, THREADS, smem, stream>>>(ma, mw, mwl, bias, ln_s, ln_b, stats, R, Y, (int)M,
                                          N, K, ex);
  return cudaGetLastError();
}

template <int BN, int EPI>
cudaError_t launch_gemm_bf16(const __nv_bfloat16* A, const __nv_bfloat16* W, const float* bias,
                             const __nv_bfloat16* R, __nv_bfloat16* Y, long long M, int N,
                             int K, cudaStream_t stream) {
  using T = __nv_bfloat16;
  CUtensorMap ma, mw, mr, my;
  cudaError_t e;
  if ((e = encode_tile<T>(&ma, A, M, K, BM)) != cudaSuccess ||
      (e = encode_tile<T>(&mw, W, N, K, BN)) != cudaSuccess ||
      (e = encode_box<T>(&my, Y, M, N, 32, 64, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess ||
      (e = encode_box<T>(&mr, EPI == EPI_RESIDUAL ? R : Y, M, N, 32, BM,
                         CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return e;
  auto kernel = gemm_bf16_kernel<BN, EPI>;
  constexpr int smem = Bf16Cfg<BN>::SMEM;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);    // persistent
  kernel<<<grid, THREADS, smem, stream>>>(ma, mw, mr, my, bias, (int)M, N, K);
  return cudaGetLastError();
}

// The bf16 tile for N: the widest BN that tiles N without waste (else 128,
// with the TMA zero-fill and clipping at the ragged edge).  GELU's erff
// epilogue outlasts a tile's loads, so it takes 128 (96 where that tiles N
// and 128 does not): six stages then hold the next tile's slices meanwhile
// (chip_smoke.py's gemm_kernel phase; wider tiles have three or four).
template <int EPI>
cudaError_t launch_gemm_bf16_for(const __nv_bfloat16* A, const __nv_bfloat16* W,
                                 const float* bias, const __nv_bfloat16* R, __nv_bfloat16* Y,
                                 long long M, int N, int K, cudaStream_t stream) {
  if (EPI == EPI_GELU)
    return N % 128 != 0 && N % 96 == 0
               ? launch_gemm_bf16<96, EPI>(A, W, bias, R, Y, M, N, K, stream)
               : launch_gemm_bf16<128, EPI>(A, W, bias, R, Y, M, N, K, stream);
  if (N % 256 == 0) return launch_gemm_bf16<256, EPI>(A, W, bias, R, Y, M, N, K, stream);
  if (N % 224 == 0) return launch_gemm_bf16<224, EPI>(A, W, bias, R, Y, M, N, K, stream);
  if (N % 192 == 0) return launch_gemm_bf16<192, EPI>(A, W, bias, R, Y, M, N, K, stream);
  if (N % 128 != 0 && N % 96 == 0)
    return launch_gemm_bf16<96, EPI>(A, W, bias, R, Y, M, N, K, stream);
  return launch_gemm_bf16<128, EPI>(A, W, bias, R, Y, M, N, K, stream);
}

// Y = TY(epilogue(prologue(A) @ W^T + b)) on weights already split by
// split_weights or split_weights_t (w_lo: nullptr for bf16) and, for the
// LayerNorm prologue, row statistics already made by row_stats (f32 only:
// a bf16 A is normalised by ln_gemm's pre-pass, so bf16 takes PRO_NONE,
// TY = TR = T and the epilogues store, GELU and residual).  N and K
// multiples of 8, K <= MAX_LN_K with the LayerNorm prologue, M <= 2^30;
// bias is not read by EPI_NONE and EPI_GELU_GRAD; ex (the mask and L, or
// Y2) only by EPI_MASK_RESIDUAL and EPI_STORE_GELU.  TY is T and TR is TY
// unless given (R and Y do not deduce them, so R may be nullptr).
template <typename X> struct NoDeduce { using type = X; };

template <typename T, int PRO, int EPI, typename TY = T, typename TR = TY>
cudaError_t launch_gemm(const T* A, const T* w_hi, const T* w_lo, const float* bias,
                        const float* ln_s, const float* ln_b, const float2* stats,
                        const typename NoDeduce<TR>::type* R, typename NoDeduce<TY>::type* Y,
                        long long M, int N, int K, cudaStream_t stream,
                        const EpiExtra& ex = EpiExtra{}) {
  if (M < 1 || N % 8 || K % 8 || M > (1LL << 30) ||
      (PRO == PRO_LAYERNORM && K > MAX_LN_K) ||
      (EPI == EPI_MASK_RESIDUAL && (ex.mask == nullptr || ex.L < 1)) ||
      (EPI == EPI_STORE_GELU && ex.Y2 == nullptr))
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    static_assert(PRO == PRO_NONE && sizeof(TY) == 2 && sizeof(TR) == 2 &&
                      (EPI == EPI_STORE || EPI == EPI_GELU || EPI == EPI_RESIDUAL),
                  "the bf16 GEMM: no prologue, bf16 R and Y, store, GELU or residual");
    return launch_gemm_bf16_for<EPI>(A, w_hi, bias, R, Y, M, N, K, stream);
  } else {
    if (N % 128 != 0 && N % 112 == 0)
      return launch_gemm_bn<T, TY, TR, 112, PRO, EPI>(A, w_hi, w_lo, bias, ln_s, ln_b, stats,
                                                      R, Y, M, N, K, stream, ex);
    return launch_gemm_bn<T, TY, TR, 128, PRO, EPI>(A, w_hi, w_lo, bias, ln_s, ln_b, stats, R,
                                                    Y, M, N, K, stream, ex);
  }
}

// Y = T(epilogue(LN(A) @ W^T + b)) (R: the residual's), the LayerNorm (scale ln_s, bias ln_b)
// rounded to T: f32 through the GEMM's prologue on row statistics in
// stats, bf16 through a rounding pre-pass into buf (M, K), then the bf16
// GEMM on buf.  Either way LN(A) is computed in f32 and rounded to T
// before the product.
template <typename T, int EPI>
cudaError_t ln_gemm(const T* A, const float* ln_s, const float* ln_b, const T* w_hi,
                    const T* w_lo, const float* bias, const T* R, T* Y, T* buf,
                    float2* stats, long long M, int N, int K, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    if ((err = layernorm_rows<T>(A, ln_s, ln_b, buf, M, K, nullptr, 1, 1, stream)) !=
        cudaSuccess)
      return err;
    return launch_gemm<T, PRO_NONE, EPI>(buf, w_hi, w_lo, bias, nullptr, nullptr, nullptr, R,
                                         Y, M, N, K, stream);
  } else {
    if ((err = row_stats<T>(A, stats, M, K, stream)) != cudaSuccess) return err;
    return launch_gemm<T, PRO_LAYERNORM, EPI>(A, w_hi, w_lo, bias, ln_s, ln_b, stats, R, Y,
                                              M, N, K, stream);
  }
}

}  // namespace sm90

}  // namespace
