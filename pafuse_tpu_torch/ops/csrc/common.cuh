// Device helpers shared by the block kernels (block.cu, block_train.cu):
// dtype conversion, warp reductions and the per-(sequence, head) attention
// kernel, in an anonymous namespace of each source that includes them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr float kLnEps = 1e-6f;

// ---------------------------------------------------------------------------
// Attention: one CTA per (sequence, head).  q, k, v of the head live in
// shared memory as f32 (k and v rows padded to an odd stride so that lanes
// reading different keys hit different banks).  One warp per query row:
// lanes split the keys for the logits, then the head dims for AV.  The
// probabilities and the output are rounded to T (no-ops for T = float).
// qkv: (B*L, 3C) in T with [q | k | v] blocks of C; out: (B*L, C) in T.
// ---------------------------------------------------------------------------

constexpr int ATTN_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int C,
                 int H, int d, float scale) {
  extern __shared__ float smem[];
  const int dp = d | 1;
  float* q = smem;
  float* k = q + L * dp;
  float* v = k + L * dp;
  float* p = v + L * dp;

  const long long b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* base = qkv + b * L * 3LL * C + (long long)h * d;
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int l = idx / d, c = idx % d;
    const T* row = base + (long long)l * 3 * C + c;
    q[l * dp + c] = to_f32<T>(row[0]);
    k[l * dp + c] = to_f32<T>(row[C]);
    v[l * dp + c] = to_f32<T>(row[2 * C]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* pw = p + warp * L;
  for (int i = warp; i < L; i += nwarps) {
    const float* qi = q + i * dp;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float* kj = k + j * dp;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qi[c], kj[c], s);
      s *= scale;
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) pw[j] = round_to<T>(pw[j] / sum);
    __syncwarp();
    T* orow = out + (b * L + i) * (long long)C + (long long)h * d;
    for (int c = lane; c < d; c += 32) {
      float o = 0.f;
      for (int j = 0; j < L; ++j) o = fmaf(pw[j], v[j * dp + c], o);
      orow[c] = from_f32<T>(o);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch_attention(const T* qkv, T* out, long long B, int L, int C, int H,
                             float scale, cudaStream_t stream) {
  const int d = C / H;
  const size_t smem =
      sizeof(float) * (3 * (size_t)L * (d | 1) + (size_t)(ATTN_THREADS / 32) * L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  attention_kernel<T><<<(unsigned)(B * H), ATTN_THREADS, smem, stream>>>(qkv, out, L, C,
                                                                         H, d, scale);
  return cudaGetLastError();
}

}  // namespace
