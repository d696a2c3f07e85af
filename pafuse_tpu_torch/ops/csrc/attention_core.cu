// The block chain's attention stage (attention_sm90.cuh): the one library
// its kernels are built into.  Kernels #1, #3 and #4 (block.cu,
// block_temporal.cu, layer.cu) call pafuse_attention_core through the
// address ops/_build.py::attention_function passes them (block_chain.cuh:
// AttentionFn, step 2); ops/attention_core.py calls it alone on a qkv the
// caller gives.
//
// Plain C interface for ctypes: pafuse_attention_core returns the
// cudaError_t of its launch, or 0.  Nothing here allocates or synchronises;
// it launches on the caller's stream.

#include "attention_sm90.cuh"

// Shared memory of one (sequence, head) at (L, d) in bytes, 0 where the
// kernel does not take d; and the most one CTA may have.
extern "C" long long pafuse_attention_core_unit_bytes(int is_bf16, int L, int d) {
  return attn_tc::unit_bytes(is_bf16 ? 2 : 4, L, d);
}

extern "C" long long pafuse_attention_core_smem_limit() { return attn_tc::SMEM_MAX; }

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
