// Fused MixSTE temporal block + outer (Temporal) LayerNorm on the native
// (B, F, N, C) activation layout, eval only, for Hopper (sm_90a).
//
// Replaces: pafuse_tpu/ops/attention.py::pallas_block_temporal (the TPU
// kernel _block_t_kernel -> _block_body).  Tokens are the F frames; the
// sequences are the B*N (sample, joint) pairs.  It computes what block.cu
// computes on x.transpose(1, 2), with the same rounding points (LN1 output,
// qkv, probabilities, head outputs, the two residual branches and the
// output rounded to T), and returns the result in (B, F, N, C), so neither
// of the two device-memory transposes around a temporal block is needed.
//
// Design: the TPU kernel reads (1, F, TBn, C) tiles and swaps the (F, N)
// axes in VMEM.  Here the swap costs nothing: every stage of the block
// except the attention is row-wise (LayerNorm prologues, GEMMs with bias,
// GELU and residual epilogues, the outer LayerNorm), so it runs on the
// M = B*F*N rows in memory order whatever the token axis is, and the
// attention kernel reads frame l of sequence (b, n) from row
// b*F*N + l*N + n (attention_sm90.cuh's strided layout, S = N).  Its CTAs
// take all heads of neighbouring joints, so each token's copy is still a
// whole contiguous row and the gather coalesces as well as the contiguous
// case.  This is block.cu's launch chain (block_chain.cuh) on those rows:
// only the F real keys enter a softmax (the padded ones are masked to
// -inf), and no CTA reads past the N joints, so the TPU kernel's zeroing
// of an overhanging joint tile has no counterpart.
//
// What bounds it on an H100: the same work as kernel #1 at the temporal
// shape, ~16*M*C^2 + 4*B*N*F^2*C FLOPs against ~2*M*C*sizeof(T) bytes of
// activations: arithmetic.  The four GEMMs run on the tensor cores
// (gemm_sm90.cuh: TMA-fed wgmma, three TF32 products per float32 product,
// one bf16 product for bfloat16), as kernel #1's do.
//
// Plain C interface for ctypes: returns the cudaError_t of the first launch
// that failed, or 0.  Nothing here allocates or synchronises; everything
// launches on the caller's stream.

#include "block_chain.cuh"

extern "C" int pafuse_fused_block_temporal(
    int is_bf16, const void* x, void* out, void* qkv, void* attn, void* x1,
    void* hidden, const float* n1s, const float* n1b, const float* wqkv,
    const float* bqkv, const float* wproj, const float* bproj, const float* n2s,
    const float* n2b, const float* wfc1, const float* bfc1, const float* wfc2,
    const float* bfc2, const float* nos, const float* nob, void* attention, void* ws,
    long long ws_bytes, long long B, int F, int N, int C, int H, int hid, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AttentionFn attn_fn = reinterpret_cast<AttentionFn>(attention);
  const float* p[14] = {n1s, n1b, wqkv, bqkv, wproj, bproj, n2s,
                        n2b, wfc1, bfc1, wfc2, bfc2, nos, nob};
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)block_chain<T>(static_cast<const T*>(x), static_cast<T*>(out),
                               static_cast<T*>(qkv), static_cast<T*>(attn),
                               static_cast<T*>(x1), static_cast<T*>(hidden), p, B * N,
                               F, N, C, H, hid, scale, nullptr, 1, 1, attn_fn, ws, ws_bytes, s);
  }
  return (int)block_chain<float>(static_cast<const float*>(x), static_cast<float*>(out),
                                 static_cast<float*>(qkv), static_cast<float*>(attn),
                                 static_cast<float*>(x1), static_cast<float*>(hidden), p,
                                 B * N, F, N, C, H, hid, scale, nullptr, 1, 1, attn_fn, ws,
                                 ws_bytes, s);
}
