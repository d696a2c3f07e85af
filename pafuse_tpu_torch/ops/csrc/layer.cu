// One fused MixSTE layer on the (B, F, N, C) activation, eval only, for
// Hopper (sm_90a).
//
// Replaces: pafuse_tpu/ops/attention.py::pallas_layer (the TPU kernel
// _layer_kernel).  Computes, with x and out in T (float or bfloat16):
//
//   ys  = T(Spatial_norm(block_s(x)))      tokens = the N joints, sequences
//                                          the B*F (sample, frame) pairs
//   ys  = T(ys + T(tpe[f]))                layer 0 only (tpe given)
//   out = T(Temporal_norm(block_t(ys)))    tokens = the F frames, sequences
//                                          the B*N (sample, joint) pairs
//
// each block with block.cu's rounding points.  The TPU kernel holds one
// sample's (F, N, C) tile in VMEM and exposes the two token axes by an
// in-VMEM transpose.  Here one QKV weight alone (384x1152 f32, 1.7 MB) is
// beyond the 227 KB of shared memory a CTA can use, let alone a layer's two
// blocks, so the layer is two block chains (block_chain.cuh) back to back,
// with the activation kept in (B, F, N, C) throughout: the spatial chain
// attends over contiguous rows (S = 1) and its outer LayerNorm adds the
// temporal position embedding of each row's frame; the temporal chain
// attends over frames with stride N (S = N).  No transpose is materialised
// anywhere, the activation touches device memory once in and once out
// besides the intermediates, and one set of scratch (qkv, attn, x1, hidden)
// serves both halves, with ys (M, C) between them.
//
// What bounds it on an H100: two blocks of ~16*M*C^2 FLOPs plus the
// attention (4*B*F*N^2*C spatial, 4*B*N*F^2*C temporal) against
// ~2*M*C*sizeof(T) bytes of activations: arithmetic, 92-98% of it in the
// eight GEMMs.  They run on the tensor cores (gemm_sm90.cuh: TMA-fed wgmma
// with the LayerNorm prologues and the bias, GELU and residual epilogues
// fused; three TF32 products per float32 product, which keep float32
// accuracy at up to 165 TFLOP/s against the 67 TFLOP/s of scalar f32 FMAs,
// H100 SXM data-sheet peaks at 700 W; one bf16 product for bfloat16, whose
// LayerNorms are rounding pre-passes).
// Each half splits its own weights into the one workspace ws before its
// GEMMs.
//
// Plain C interface for ctypes: returns the cudaError_t of the first launch
// that failed, or 0.  Nothing here allocates or synchronises; everything
// launches on the caller's stream.

#include "block_chain.cuh"

namespace {

template <typename T>
cudaError_t fused_layer(const T* x, T* out, T* ys, T* qkv, T* attn, T* x1, T* hidden,
                        const float* const* sp, const float* const* tp,
                        const float* tpe, long long B, int F, int N, int C, int H,
                        int hid, float scale, AttentionFn attention, void* ws,
                        long long ws_bytes, cudaStream_t stream) {
  // spatial block + Spatial_norm (+ tpe): B*F sequences of N joints
  const cudaError_t err = block_chain<T>(x, ys, qkv, attn, x1, hidden, sp, B * F, N, 1,
                                         C, H, hid, scale, tpe, F, N, attention, ws,
                                         ws_bytes, stream);
  if (err != cudaSuccess) return err;
  // temporal block + Temporal_norm: B*N sequences of F frames, stride N
  return block_chain<T>(ys, out, qkv, attn, x1, hidden, tp, B * N, F, N, C, H, hid,
                        scale, nullptr, 1, 1, attention, ws, ws_bytes, stream);
}

}  // namespace

extern "C" int pafuse_fused_layer(
    int is_bf16, const void* x, void* out, void* ys, void* qkv, void* attn, void* x1,
    void* hidden, const float* s0, const float* s1, const float* s2, const float* s3,
    const float* s4, const float* s5, const float* s6, const float* s7,
    const float* s8, const float* s9, const float* s10, const float* s11,
    const float* s12, const float* s13, const float* t0, const float* t1,
    const float* t2, const float* t3, const float* t4, const float* t5,
    const float* t6, const float* t7, const float* t8, const float* t9,
    const float* t10, const float* t11, const float* t12, const float* t13,
    const float* tpe, void* attention, void* ws, long long ws_bytes, long long B, int F,
    int N, int C, int H, int hid, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AttentionFn attn_fn = reinterpret_cast<AttentionFn>(attention);
  const float* sp[14] = {s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13};
  const float* tp[14] = {t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11, t12, t13};
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)fused_layer<T>(static_cast<const T*>(x), static_cast<T*>(out),
                               static_cast<T*>(ys), static_cast<T*>(qkv),
                               static_cast<T*>(attn), static_cast<T*>(x1),
                               static_cast<T*>(hidden), sp, tp, tpe, B, F, N, C, H, hid,
                               scale, attn_fn, ws, ws_bytes, s);
  }
  return (int)fused_layer<float>(static_cast<const float*>(x), static_cast<float*>(out),
                                 static_cast<float*>(ys), static_cast<float*>(qkv),
                                 static_cast<float*>(attn), static_cast<float*>(x1),
                                 static_cast<float*>(hidden), sp, tp, tpe, B, F, N, C, H,
                                 hid, scale, attn_fn, ws, ws_bytes, s);
}
