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
// 50 MB L2), i.e. hundreds of FLOPs per byte for C = 224..384: arithmetic.
// The TPU kernel holds a 32-sequence tile, the weights and every
// intermediate in VMEM for one pass; on the H100 the QKV weight alone
// (384x1152 f32, 1.7 MB) exceeds a block's 227 KB of shared memory, so the
// design is a chain of three launches of common.cuh's kernels: the tiled
// linear_kernel for QKV (f32 weights, unrounded), one attention CTA per
// (sequence, head) with q, k and v in shared memory (attention_kernel,
// instantiated for f32), and linear_kernel again for the projection.  The TPU pads L to a multiple of 8 and masks the
// padded keys with -1e30 and pads B to its 32-row tile; nothing is padded
// here: the GEMMs mask their ragged row and column tiles and the attention
// CTA runs over the L real keys, so no pad row enters a softmax or a sum.
// The GEMMs use scalar f32 FMAs (no tensor cores), so d = 28 and N = 3*224
// need no padding either; wgmma/TMA tiles are later work.
//
// Plain C interface for ctypes: returns the cudaError_t of the first launch
// that failed, or 0.  Nothing here allocates or synchronises; everything
// launches on the caller's stream.

#include "common.cuh"

namespace {

template <typename T>
cudaError_t fused_attention(const T* x, T* out, float* qkv, float* attn,
                            const float* wqkv, const float* bqkv, const float* wproj,
                            const float* bproj, long long B, int L, int C, int H,
                            float scale, cudaStream_t stream) {
  const long long M = B * L;
  cudaError_t err;

  // 1. qkv = f32(x) @ Wqkv + bqkv, kept in f32
  err = launch_linear<T, float, false, PRO_NONE, EPI_STORE>(
      x, wqkv, bqkv, nullptr, nullptr, nullptr, qkv, M, 3 * C, C, stream);
  if (err != cudaSuccess) return err;

  // 2. per-head attention in f32 (rounding points of attention_kernel<float>
  //    are no-ops)
  err = launch_attention<float>(qkv, attn, B, L, C, H, scale, stream);
  if (err != cudaSuccess) return err;

  // 3. out = T(attn @ Wproj + bproj)
  return launch_linear<float, T, false, PRO_NONE, EPI_STORE>(
      attn, wproj, bproj, nullptr, nullptr, nullptr, out, M, C, C, stream);
}

}  // namespace

extern "C" int pafuse_fused_attention(int is_bf16, const void* x, void* out, float* qkv,
                                      float* attn, const float* wqkv, const float* bqkv,
                                      const float* wproj, const float* bproj, long long B,
                                      int L, int C, int H, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)fused_attention<T>(static_cast<const T*>(x), static_cast<T*>(out), qkv,
                                   attn, wqkv, bqkv, wproj, bproj, B, L, C, H, scale, s);
  }
  return (int)fused_attention<float>(static_cast<const float*>(x), static_cast<float*>(out),
                                     qkv, attn, wqkv, bqkv, wproj, bproj, B, L, C, H, scale,
                                     s);
}
