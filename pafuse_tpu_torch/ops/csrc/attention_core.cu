// The attention forward on the tensor cores (attention_sm90.cuh: the
// resident kernel and the streamed one), built into this one library.
// Kernels #1, #3 and #4 (block.cu, block_temporal.cu, layer.cu), #2
// (attention.cu) and #5 (block_train.cu's forward) call
// pafuse_attention_core through the address ops/_build.py::
// attention_function passes them (common.cuh: AttentionFn);
// ops/attention_core.py calls it alone.  The backward lives in its own
// library, attention_core_bwd.cu, so that the two build in parallel.
//
// Plain C interface for ctypes: the kernel functions return the cudaError_t
// of their launch, or 0.  Nothing here allocates or synchronises; it
// launches on the caller's stream.

#include "attention_sm90.cuh"

// Which kernel takes (L, d) in bf16 or float32: 1 the resident one, 2 the
// streamed one, 0 neither (d above 128).
extern "C" int pafuse_attention_core_variant(int is_bf16, int L, int d) {
  return attn_tc::variant(is_bf16 ? 2 : 4, L, d);
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

// Launches of the streamed kernel since the count was last zeroed (from any
// caller: this entry point or a library that calls it through its
// address); with zero, also sets the count to 0.
extern "C" long long pafuse_attention_core_stream_launches(int zero) {
  return zero ? attn_tc::stream_launches.exchange(0) : attn_tc::stream_launches.load();
}
