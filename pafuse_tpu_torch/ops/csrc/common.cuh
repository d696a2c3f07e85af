// Device helpers shared by the kernels (block.cu, block_temporal.cu,
// layer.cu, attention.cu, block_train.cu, gemm.cu, attention_core.cu): dtype
// conversion, warp reductions, the prologue and epilogue codes of
// gemm_sm90.cuh's GEMM, the signatures of the attention stages and the row
// LayerNorms (f32 and a vectorised bf16 one), in an anonymous namespace of
// each source that includes them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back: the compute dtype's rounding point.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr float kLnEps = 1e-6f;

// ---------------------------------------------------------------------------
// The epilogues of gemm_sm90.cuh's GEMM:
//   EPI_STORE      Y = acc + b
//   EPI_GELU       Y = gelu(acc + b)                      exact (erf) GELU
//   EPI_RESIDUAL   Y = R + T(acc + b)
//   EPI_NONE       Y = acc                                no bias
//   EPI_GELU_GRAD  Y = acc * gelu'(R)                     R: the f32 pre-activation
//   EPI_MASK_RESIDUAL  Y = R + mask[m / L] * (acc + b)    row m of sequence m / L
//   EPI_STORE_GELU Y = acc + b, Y2 = gelu(Y)              both f32
// and its A-operand prologues (none, or the row LayerNorm rounded to T).
// The last two are the training forward's (kernel #5), in f32 throughout.
// ---------------------------------------------------------------------------

enum { PRO_NONE = 0, PRO_LAYERNORM = 1 };
enum {
  EPI_STORE = 0,
  EPI_GELU = 1,
  EPI_RESIDUAL = 2,
  EPI_NONE = 3,
  EPI_GELU_GRAD = 4,
  EPI_MASK_RESIDUAL = 5,
  EPI_STORE_GELU = 6
};

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// the exact GELU
__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.f + erff(u * kInvSqrt2));
}

// d/du of the exact GELU 0.5 u (1 + erf(u / sqrt 2))
__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.f + erff(u * kInvSqrt2)) + u * (kInvSqrt2Pi * expf(-0.5f * u * u));
}

// ---------------------------------------------------------------------------
// The attention stages live in attention_core.cu (attention_sm90.cuh) and
// attention_core_bwd.cu (attention_bwd_sm90.cuh) only; the other libraries
// call them through the addresses ops/_build.py passes, so their kernels
// compile once:
//   AttentionFn     pafuse_attention_core: is_bf16, qkv, out, sequences, L,
//                   S, C, H, scale, stream (the chains' step 2, #2's and #5's
//                   attention)
//   AttentionBwdFn  pafuse_attention_core_bwd: qkv, dO, dqkv, stats (3 *
//                   sequences * H * L floats of scratch), sequences, L, C,
//                   H, scale, stream (#6's attention backward)
// Each returns a cudaError_t.
// ---------------------------------------------------------------------------

typedef int (*AttentionFn)(int, const void*, void*, long long, int, int, int, int, float,
                           void*);
typedef int (*AttentionBwdFn)(const float*, const float*, float*, float*, long long, int, int,
                              int, float, void*);

// ---------------------------------------------------------------------------
// Launches counted on the host where they happen, by kernel, in each library
// (every source that includes this header is a library of its own):
// pafuse_kernel_launches reads them, so a caller can tell which kernels a
// call went through without a profile.  ops/_build.py's LAUNCH_KINDS names
// them in this order.
// ---------------------------------------------------------------------------

enum LaunchKind {
  LAUNCH_GEMM = 0,           // sm90::gemm_kernel (float32, wgmma)
  LAUNCH_GEMM_BF16,          // sm90::gemm_bf16_kernel
  LAUNCH_SPLIT_WEIGHTS,      // sm90::split_weights_kernel
  LAUNCH_SPLIT_WEIGHTS_T,    // sm90::split_weights_t_kernel
  LAUNCH_ROW_STATS,          // sm90::row_stats_kernel
  LAUNCH_WGRAD_WGMMA,        // wgrad_sm90.cuh's wgrad_wgmma_kernel (block_train.cu)
  LAUNCH_ATTENTION_TC,       // attention_sm90.cuh's resident attention_tc_kernel
  LAUNCH_ATTENTION_WG,       // attention_sm90.cuh's attention_wg_kernel (float32, 81-144 keys)
  LAUNCH_ATTENTION_BWD_TC,   // attention_bwd_sm90.cuh's resident attention_bwd_tc_kernel
  LAUNCH_ATTENTION_BWD_WG,   // attention_bwd_sm90.cuh's resident attention_bwd_wg_kernel
  LAUNCH_ATTENTION_BWD_PACK,  // attention_bwd_sm90.cuh's resident attention_bwd_pack_kernel
  LAUNCH_ATTENTION_STREAM,   // attention_sm90.cuh's attention_stream_kernel
  LAUNCH_ATTENTION_BWD_STREAM_A,  // attention_bwd_sm90.cuh's attention_bwd_stream_a_kernel
  LAUNCH_ATTENTION_BWD_STREAM_B,  // and attention_bwd_stream_b_kernel
  LAUNCH_LN_BWD,             // block_train.cu's ln_bwd_kernel
  LAUNCH_LN_SUMS,            // and its ordered pass, ln_sums_kernel
  LAUNCH_REDUCE_PARTIALS,    // block_train.cu's reduce_partials_kernel (the weight gradients')
  LAUNCH_KINDS
};

std::atomic<long long> kernel_launches[LAUNCH_KINDS];

// After a launch: count it when it was accepted; returns err.
inline cudaError_t counted(LaunchKind kind, cudaError_t err) {
  if (err == cudaSuccess) kernel_launches[kind].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// ---------------------------------------------------------------------------
// Row LayerNorm (the outer Spatial/Temporal norm): one warp per row,
// Y = T(LN(X)) in f32 with eps 1e-6.  With tpe (F, C) f32 it adds the
// temporal position embedding of the row's frame, Y = T(T(LN(X)) + T(tpe[f]))
// (kernel #4's layer 0, _layer_kernel's `ys + tpe.astype(cd)`), where row m
// of a (B, F, N, C) activation is frame (m / N) % F.
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const T* __restrict__ X, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ Y, long long M,
                 int C, const float* __restrict__ tpe, int F, int N) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* row = X + m * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32<T>(row[c]);
  const float mean = warp_sum(s) / (float)C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dv = to_f32<T>(row[c]) - mean;
    var += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)C + kLnEps);
  const float* trow = tpe == nullptr ? nullptr : tpe + ((m / N) % F) * C;
  T* yrow = Y + m * C;
  for (int c = lane; c < C; c += 32) {
    float y = (to_f32<T>(row[c]) - mean) * rstd * scale[c] + bias[c];
    if (trow != nullptr) y = round_to<T>(y) + round_to<T>(trow[c]);
    yrow[c] = from_f32<T>(y);
  }
}

// The same LayerNorm for bf16 rows, 16 bytes (8 values) a lane per load:
// lane l holds chunks l, l + 32, ... (NCH of them: C <= 256 NCH) of a row
// in registers, so the row is read once, and the scale and bias of those
// columns for every row it takes.  Each warp walks rows gw, gw + warps, ...
// and loads its next row before it normalises this one.  C % 8 == 0, X and
// Y 16-byte aligned.  The bf16 chain's three LayerNorms and the bf16 GEMM's
// LayerNorm pre-pass (gemm_sm90.cuh: ln_gemm) run on it.
template <int NCH>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_bf16_kernel(const __nv_bfloat16* __restrict__ X, const float* __restrict__ scale,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ Y,
                      long long M, int C, const float* __restrict__ tpe, int F, int N) {
  const int lane = threadIdx.x & 31, chunks = C / 8;
  float sc[NCH][8], bi[NCH][8];
#pragma unroll
  for (int q = 0; q < NCH; ++q) {
    const int c = lane + 32 * q;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[q][e] = c < chunks ? scale[8 * c + e] : 0.f;
      bi[q][e] = c < chunks ? bias[8 * c + e] : 0.f;
    }
  }
  const long long warps = (long long)gridDim.x * (LN_THREADS / 32);
  long long m = (long long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  uint4 next[NCH];
  auto load = [&](long long row) {
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c = lane + 32 * q;
      if (row < M && c < chunks) next[q] = reinterpret_cast<const uint4*>(X + row * C)[c];
    }
  };
  load(m);
  for (; m < M; m += warps) {
    float v[NCH][8];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&next[q]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[q][2 * e] = f.x;
        v[q][2 * e + 1] = f.y;
        if (lane + 32 * q < chunks) s += f.x + f.y;
      }
    }
    load(m + warps);
    const float mean = warp_sum(s) / (float)C;
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      if (lane + 32 * q >= chunks) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dv = v[q][e] - mean;
        var += dv * dv;
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / (float)C + kLnEps);
    const float* trow = tpe == nullptr ? nullptr : tpe + ((m / N) % F) * C;
    uint4* yrow = reinterpret_cast<uint4*>(Y + m * C);
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c = lane + 32 * q;
      if (c >= chunks) continue;
      uint4 raw;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y0 = (v[q][2 * e] - mean) * rstd * sc[q][2 * e] + bi[q][2 * e];
        float y1 = (v[q][2 * e + 1] - mean) * rstd * sc[q][2 * e + 1] + bi[q][2 * e + 1];
        if (trow != nullptr) {
          y0 = round_to<__nv_bfloat16>(y0) + round_to<__nv_bfloat16>(trow[8 * c + 2 * e]);
          y1 = round_to<__nv_bfloat16>(y1) + round_to<__nv_bfloat16>(trow[8 * c + 2 * e + 1]);
        }
        h[e] = __floats2bfloat162_rn(y0, y1);
      }
      yrow[c] = raw;
    }
  }
}

// Y = T(LN(X)) [+ tpe] over M rows of C: layernorm_kernel for f32 (C any),
// layernorm_bf16_kernel for bf16 (C <= 1024), its grid as many warps as
// stay resident on the card.
template <typename T>
cudaError_t layernorm_rows(const T* X, const float* scale, const float* bias, T* Y,
                           long long M, int C, const float* tpe, int F, int N,
                           cudaStream_t stream) {
  const long long rows = LN_THREADS / 32;
  if constexpr (sizeof(T) == 2) {
    if (C % 8 || C > 1024 || reinterpret_cast<uintptr_t>(X) % 16 ||
        reinterpret_cast<uintptr_t>(Y) % 16)
      return cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    const long long blocks = (M + rows - 1) / rows, resident = 8LL * sms;
    const unsigned grid = (unsigned)(blocks < resident ? blocks : resident);
    if (C <= 256)
      layernorm_bf16_kernel<1><<<grid, LN_THREADS, 0, stream>>>(X, scale, bias, Y, M, C, tpe,
                                                                F, N);
    else if (C <= 512)
      layernorm_bf16_kernel<2><<<grid, LN_THREADS, 0, stream>>>(X, scale, bias, Y, M, C, tpe,
                                                                F, N);
    else
      layernorm_bf16_kernel<4><<<grid, LN_THREADS, 0, stream>>>(X, scale, bias, Y, M, C, tpe,
                                                                F, N);
  } else {
    layernorm_kernel<T><<<(unsigned)((M + rows - 1) / rows), LN_THREADS, 0, stream>>>(
        X, scale, bias, Y, M, C, tpe, F, N);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches of kernel `kind` (LaunchKind) in this library since the count was
// last zeroed; with zero, also sets it to 0.  -1 for an unknown kind.
extern "C" long long pafuse_kernel_launches(int kind, int zero) {
  if (kind < 0 || kind >= LAUNCH_KINDS) return -1;
  return zero ? kernel_launches[kind].exchange(0) : kernel_launches[kind].load();
}
