// The attention stages on the tensor cores: the forward (attention_sm90.cuh)
// and the training backward (attention_bwd_sm90.cuh), built into this one
// library.  Kernels #1, #3 and #4 (block.cu, block_temporal.cu, layer.cu),
// #2 (attention.cu) and #5 (block_train.cu's forward) call
// pafuse_attention_core, and #6 (block_train.cu's backward)
// pafuse_attention_core_bwd, through the addresses
// ops/_build.py::attention_function and attention_bwd_function pass them
// (block_chain.cuh: AttentionFn, AttentionBwdFn); ops/attention_core.py
// calls both alone.
//
// Plain C interface for ctypes: the kernel functions return the cudaError_t
// of their launch, or 0.  Nothing here allocates or synchronises; it
// launches on the caller's stream.

#include "attention_bwd_sm90.cuh"

// Shared memory of one (sequence, head) at (L, d) in bytes, 0 where the
// kernel does not take d; and the most one CTA may have.
extern "C" long long pafuse_attention_core_unit_bytes(int is_bf16, int L, int d) {
  return attn_tc::unit_bytes(is_bf16 ? 2 : 4, L, d);
}

extern "C" long long pafuse_attention_core_smem_limit() { return attn_tc::SMEM_MAX; }

// The same for the backward (float32).
extern "C" long long pafuse_attention_core_bwd_unit_bytes(int L, int d) {
  return attn_bwd::unit_bytes(L, d);
}

// qkv (rows, 3C) and out (rows, C) in T: seqs sequences of L tokens, token l
// of sequence s at row (s / S) * L * S + l * S + s % S.
extern "C" int pafuse_attention_core(int is_bf16, const void* qkv, void* out, long long seqs,
                                     int L, int S, int C, int H, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)launch_attention_tc<T>(static_cast<const T*>(qkv), static_cast<T*>(out), seqs,
                                       L, C, H, scale, s, S);
  }
  return (int)launch_attention_tc<float>(static_cast<const float*>(qkv),
                                         static_cast<float*>(out), seqs, L, C, H, scale, s, S);
}

// float32 qkv (rows, 3C), dO (rows, C) and dqkv (rows, 3C) of seqs
// contiguous sequences of L tokens: dqkv = [dq | dk | dv].
extern "C" int pafuse_attention_core_bwd(const float* qkv, const float* dO, float* dqkv,
                                         long long seqs, int L, int C, int H, float scale,
                                         void* stream) {
  return (int)launch_attention_bwd_tc(qkv, dO, dqkv, seqs, L, C, H, scale,
                                      static_cast<cudaStream_t>(stream));
}
