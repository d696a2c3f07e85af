// Fused multi-head self-attention (QKV -> per-head softmax attention ->
// output projection), eval only, for Hopper (sm_90a).
//
// Replaces: pafuse_tpu/ops/attention.py::pallas_attention (the TPU kernel
// _attention_kernel).  Computes, per sequence of L tokens, with x and out in
// T (float or bfloat16):
//
//   qkv = f32(x) @ Wqkv + bqkv          f32; the weights stay f32 for either T
//   a   = softmax(q k^T / sqrt(d)) v    per head; logits, softmax and AV in f32
//   out = T(a @ Wproj + bproj)          the one rounding point
//
// These are the rounding points of _attention_kernel, not those of the fused
// block (block.cu), which rounds the weights, qkv, the probabilities and the
// head outputs to T: here qkv and the attention output live in f32 scratch
// and only the store of `out` rounds.  No LayerNorm, no MLP.
//
// What bounds it on this card: ~8*B*L*C^2 + 4*B*L^2*C FLOPs against
// ~2*B*L*C*sizeof(T) bytes of activations (the 4*C^2 f32 weights stay in the
// 50 MB L2), i.e. hundreds of FLOPs per byte for C = 224..384: arithmetic,
// and the two GEMMs are ~90% of it.  The TPU kernel holds a 32-sequence
// tile, the weights and every intermediate in VMEM for one pass; on the H100
// the QKV weight alone (384x1152 f32, 1.7 MB) exceeds a block's 227 KB of
// shared memory, so the design is a chain of launches:
//   0. the two weights split into TF32 hi and lo halves (split_weights)
//      into the caller's workspace; for bfloat16 x, x converted to f32
//      there too (one read and one write of x; a bf16 value is exact in
//      TF32, so the three-product GEMM's a_lo * w_hi product adds zeros);
//   1. qkv on gemm_sm90.cuh's GEMM (TMA + wgmma, float32 as three TF32
//      products, partial sums per pair of K slices added in f32), f32 out;
//   2. the attention in f32 on the tensor cores: attention_core.cu's
//      pafuse_attention_core (attention_sm90.cuh: (sequence, head) units in
//      shared memory, mma.sync, each product as three TF32 products, the
//      softmax on the fragments), called through the address `attention`
//      (common.cuh: AttentionFn) with is_bf16 = 0 whatever T is;
//   3. the projection on the same GEMM, f32 A, T out.
// The TPU pads L to a multiple of 8 and masks the padded keys with -1e30
// and pads B to its 32-row tile; nothing is padded in device memory here:
// TMA zero-fills the ragged row tile, the GEMM's epilogue masks it, and the
// attention pads its shared-memory tiles with zeros and masks the padded
// keys to -inf, so no pad row enters a softmax or a sum.  The face widths
// (3C = 672, C = 224) tile with the GEMM's 112-column tiles.
//
// Plain C interface for ctypes: returns the cudaError_t of the first launch
// that failed, or 0.  Nothing here allocates or synchronises; everything
// launches on the caller's stream.

#include "gemm_sm90.cuh"

namespace {

// Workspace bytes (ops/attention.py::attention_workspace_bytes says the
// same): the TF32 hi and lo halves of Wqkv and Wproj, and for bfloat16 x an
// f32 copy of x.
inline long long attention_workspace_bytes(int is_bf16, long long M, int C) {
  return 4LL * (8LL * C * C + (is_bf16 ? M * C : 0));
}

__global__ void bf16_to_f32_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                                   long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = __bfloat162float(x[i]);
}

template <typename T>
cudaError_t fused_attention(const T* x, T* out, float* qkv, float* attn, void* ws,
                            const float* wqkv, const float* bqkv, const float* wproj,
                            const float* bproj, AttentionFn attention, long long B, int L,
                            int C, int H, float scale, cudaStream_t stream) {
  using namespace sm90;
  const long long M = B * L;
  cudaError_t err;

  // 0. the weights' TF32 halves; x in f32
  float* qkv_hi = static_cast<float*>(ws);
  float* qkv_lo = qkv_hi + 3LL * C * C;
  float* proj_hi = qkv_lo + 3LL * C * C;
  float* proj_lo = proj_hi + (long long)C * C;
  if ((err = split_weights<float>(wqkv, qkv_hi, qkv_lo, 3LL * C * C, stream)) != cudaSuccess ||
      (err = split_weights<float>(wproj, proj_hi, proj_lo, (long long)C * C, stream)) !=
          cudaSuccess)
    return err;
  const float* xf;
  if constexpr (sizeof(T) == 4) {
    xf = x;
  } else {
    float* copy = proj_lo + (long long)C * C;
    const long long blocks = (M * C + 255) / 256;
    bf16_to_f32_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
        x, copy, M * C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    xf = copy;
  }

  // 1. qkv = f32(x) @ Wqkv + bqkv, kept in f32
  err = launch_gemm<float, PRO_NONE, EPI_STORE>(xf, qkv_hi, qkv_lo, bqkv, nullptr, nullptr,
                                                nullptr, nullptr, qkv, M, 3 * C, C, stream);
  if (err != cudaSuccess) return err;

  // 2. per-head attention in f32 (the float32 instantiation's rounding
  //    points are no-ops)
  err = (cudaError_t)attention(0, qkv, attn, B, L, 1, C, H, scale, stream);
  if (err != cudaSuccess) return err;

  // 3. out = T(attn @ Wproj + bproj)
  return launch_gemm<float, PRO_NONE, EPI_STORE, T>(attn, proj_hi, proj_lo, bproj, nullptr,
                                                    nullptr, nullptr, nullptr, out, M, C, C,
                                                    stream);
}

}  // namespace

// ws: ws_bytes >= attention_workspace_bytes(is_bf16, B * L, C); attention:
// the address of attention_core.cu's pafuse_attention_core.
extern "C" int pafuse_fused_attention(int is_bf16, const void* x, void* out, float* qkv,
                                      float* attn, void* ws, long long ws_bytes,
                                      const float* wqkv, const float* bqkv,
                                      const float* wproj, const float* bproj,
                                      void* attention, long long B, int L, int C, int H,
                                      float scale, void* stream) {
  if (ws_bytes < attention_workspace_bytes(is_bf16, B * L, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AttentionFn fn = reinterpret_cast<AttentionFn>(attention);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)fused_attention<T>(static_cast<const T*>(x), static_cast<T*>(out), qkv,
                                   attn, ws, wqkv, bqkv, wproj, bproj, fn, B, L, C, H, scale,
                                   s);
  }
  return (int)fused_attention<float>(static_cast<const float*>(x), static_cast<float*>(out),
                                     qkv, attn, ws, wqkv, bqkv, wproj, bproj, fn, B, L, C, H,
                                     scale, s);
}
