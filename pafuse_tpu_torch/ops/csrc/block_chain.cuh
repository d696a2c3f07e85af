// One eval block + outer LayerNorm as a chain of launches: kernels #1
// (block.cu), #3 (block_temporal.cu) and both halves of #4 (layer.cu); the
// computation is described in block.cu.
//
//   0. the four weights in the GEMM's operand type     split_weights_kernel
//   1. qkv    = T(LN1(x) @ Wqkv + bqkv)          ln_gemm (LN prologue or pre-pass)
//   2. attn   = per-head softmax attention        attention_tc_kernel (S),
//                                                 through `attention`
//   3. x1     = x + T(attn @ Wproj + bproj)       sm90 GEMM, residual
//   4. hidden = T(gelu(LN2(x1) @ Wfc1 + bfc1))    ln_gemm, GELU
//   5. x2     = x1 + T(hidden @ Wfc2 + bfc2)      sm90 GEMM, into the attn buffer
//   6. out    = T(LN_outer(x2)) [+ tpe]           layernorm_rows
//
// x, out: rows = seqs * L, laid out with S as attention_sm90.cuh says; every
// stage but the attention is row-wise, so the layout reaches only step 2.
// p: the 14 block tensors in block.py's order.  Scratch: qkv (rows, 3C),
// attn, x1 (rows, C), hidden (rows, hid), all in T, and the workspace ws of
// chain_workspace_bytes: the split weights, then the row statistics (f32).
// A bf16 chain writes T(LN1(x)) and T(LN2(x1)) into the attn buffer, which
// is free at steps 1 and 4.  tpe: nullptr, or (F, C) added by step 6 with
// rows in (B, F, N, C) order.

#pragma once

#include "gemm_sm90.cuh"

namespace {

// Step 2: attention_core.cu's pafuse_attention_core (attention_sm90.cuh's
// tensor-core kernel), whose address the caller passes as an AttentionFn
// (common.cuh), so that kernel's instantiations are compiled into one
// library.

// Bytes of a chain's workspace (ops/gemm.py::chain_workspace_bytes says the
// same): room for the TF32 hi and lo halves of the four weights (8C^2 +
// 4C*hid f32; a bf16 chain uses a quarter of it) and the (mean, rstd) of
// every row.
inline long long chain_workspace_bytes(long long M, int C, int hid) {
  return 4LL * (2LL * (4LL * C * C + 2LL * hid * C) + 2LL * M);
}

template <typename T>
cudaError_t block_chain(const T* x, T* out, T* qkv, T* attn, T* x1, T* hidden,
                        const float* const* p, long long seqs, int L, int S, int C,
                        int H, int hid, float scale, const float* tpe, int F, int N,
                        AttentionFn attention, void* ws, long long ws_bytes,
                        cudaStream_t stream) {
  using namespace sm90;
  const long long M = seqs * L;
  if (ws_bytes < chain_workspace_bytes(M, C, hid)) return cudaErrorInvalidValue;
  cudaError_t err;
  // 0. [hi | lo] (f32) or the rounded copy (bf16) of each weight, in order
  const long long sizes[4] = {3LL * C * C, (long long)C * C, (long long)hid * C,
                              (long long)C * hid};
  const float* src[4] = {p[2], p[4], p[8], p[10]};
  const T* hi[4];
  const T* lo[4];
  T* w = static_cast<T*>(ws);
  for (int i = 0; i < 4; ++i) {
    T* l = Cfg<T>::NT == 2 ? w + sizes[i] : nullptr;
    if ((err = split_weights<T>(src[i], w, l, sizes[i], stream)) != cudaSuccess) return err;
    hi[i] = w;
    lo[i] = l;
    w += Cfg<T>::NT * sizes[i];
  }
  float2* stats = reinterpret_cast<float2*>(static_cast<char*>(ws) +
                                            8LL * (4LL * C * C + 2LL * hid * C));

  err = ln_gemm<T, EPI_STORE>(x, p[0], p[1], hi[0], lo[0], p[3], nullptr, qkv, attn, stats, M,
                              3 * C, C, stream);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)attention(sizeof(T) == 2, qkv, attn, seqs, L, S, C, H, scale, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, PRO_NONE, EPI_RESIDUAL>(attn, hi[1], lo[1], p[5], nullptr, nullptr,
                                               nullptr, x, x1, M, C, C, stream);
  if (err != cudaSuccess) return err;
  err = ln_gemm<T, EPI_GELU>(x1, p[6], p[7], hi[2], lo[2], p[9], nullptr, hidden, attn, stats,
                             M, hid, C, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, PRO_NONE, EPI_RESIDUAL>(hidden, hi[3], lo[3], p[11], nullptr, nullptr,
                                               nullptr, x1, attn, M, C, hid, stream);
  if (err != cudaSuccess) return err;
  return layernorm_rows<T>(attn, p[12], p[13], out, M, C, tpe, F, N, stream);
}

}  // namespace
