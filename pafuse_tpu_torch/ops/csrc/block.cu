// Fused MixSTE transformer block + outer LayerNorm, eval only, for Hopper
// (sm_90a).
//
// Replaces: pafuse_tpu/ops/attention.py::pallas_block (the TPU kernel
// _block_kernel -> _block_body).  Computes, per sequence of L tokens:
//
//   h   = LN1(x)                        -> compute dtype T
//   qkv = h @ Wqkv + bqkv               -> T
//   a   = softmax(q k^T / sqrt(d)) v    per head; logits and softmax in f32,
//                                       probabilities rounded to T, AV
//                                       accumulated in f32 and rounded to T
//   x1  = x + T(a @ Wproj + bproj)      residual add in T
//   u   = T(gelu(LN2(x1) @ Wfc1 + bfc1)) exact (erf) GELU in f32
//   x2  = x1 + T(u @ Wfc2 + bfc2)       residual add in T
//   out = T(LN_outer(x2))               LayerNorm in f32, eps 1e-6
//
// Weights stay f32 in device memory in the torch (out, in) layout; the
// products take them in the compute dtype (the TPU kernel's "weights cast
// to the compute dtype" rounding point) and accumulate in f32.
//
// What bounds it on an H100: for the part widths (C = 224..384, L <= 68)
// the work is ~16*B*L*C^2 + 4*B*L^2*C FLOPs against ~2*B*L*C*sizeof(T)
// bytes of activations (+ 8*C^2*4 bytes of weights, which stay in the 50 MB
// L2), hundreds of FLOPs per byte: the block is bound by arithmetic, and
// 92-98% of it is the four GEMMs.  The TPU kernel keeps all of a block's
// weights in VMEM and runs the block in one pass; one QKV weight alone
// (384x1152 f32, 1.7 MB) exceeds the 227 KB of shared memory an H100 CTA
// can use, so the design is a short chain of launches (block_chain.cuh):
// four GEMMs on the tensor cores (gemm_sm90.cuh: TMA-fed wgmma, the
// LayerNorm prologue and the bias, GELU and residual epilogues fused; in
// float32 three TF32 products per product, which keep float32 accuracy at
// up to 165 TFLOP/s against the 67 TFLOP/s of scalar f32 FMAs (H100 SXM
// data-sheet peaks at 700 W); in bfloat16 one bf16 product after a
// LayerNorm pre-pass, bound by the bytes it moves), one attention
// kernel on the tensor cores too (attention_sm90.cuh: a CTA's (sequence,
// head) units in shared memory, mma.sync products, the softmax on the
// fragments; the padded keys masked to -inf), and one row LayerNorm.
// The intermediates (qkv, attention out, x1, MLP hidden) round-trip
// through device memory.
//
// Here the chain runs over contiguous sequences (S = 1).  `attention` is
// the address of attention_core.cu's pafuse_attention_core (block_chain.cuh:
// AttentionFn).
//
// Plain C interface for ctypes: every function returns the cudaError_t of
// the first launch that failed, or 0.  Nothing here allocates or
// synchronises; everything launches on the caller's stream.

#include "block_chain.cuh"

extern "C" int pafuse_fused_block(
    int is_bf16, const void* x, void* out, void* qkv, void* attn, void* x1,
    void* hidden, const float* n1s, const float* n1b, const float* wqkv,
    const float* bqkv, const float* wproj, const float* bproj, const float* n2s,
    const float* n2b, const float* wfc1, const float* bfc1, const float* wfc2,
    const float* bfc2, const float* nos, const float* nob, void* attention, void* ws,
    long long ws_bytes, long long B, int L, int C, int H, int hid, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AttentionFn attn_fn = reinterpret_cast<AttentionFn>(attention);
  const float* p[14] = {n1s, n1b, wqkv, bqkv, wproj, bproj, n2s,
                        n2b, wfc1, bfc1, wfc2, bfc2, nos, nob};
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)block_chain<T>(static_cast<const T*>(x), static_cast<T*>(out),
                               static_cast<T*>(qkv), static_cast<T*>(attn),
                               static_cast<T*>(x1), static_cast<T*>(hidden), p, B, L, 1,
                               C, H, hid, scale, nullptr, 1, 1, attn_fn, ws, ws_bytes, s);
  }
  return (int)block_chain<float>(static_cast<const float*>(x), static_cast<float*>(out),
                                 static_cast<float*>(qkv), static_cast<float*>(attn),
                                 static_cast<float*>(x1), static_cast<float*>(hidden), p,
                                 B, L, 1, C, H, hid, scale, nullptr, 1, 1, attn_fn, ws,
                                 ws_bytes, s);
}
