// The attention backward of the training block (kernel #6, step 9 of
// block_train.cu's train_bwd) on the tensor cores (attention_bwd_sm90.cuh:
// the resident kernel and the streamed one's two passes), built into this
// one library: block_train.cu calls pafuse_attention_core_bwd through the
// address ops/_build.py::attention_bwd_function passes it (common.cuh:
// AttentionBwdFn); ops/attention_core.py calls it alone.
//
// Plain C interface for ctypes: the kernel functions return the cudaError_t
// of their launches, or 0.  Nothing here allocates or synchronises; it
// launches on the caller's stream.

#include "attention_bwd_sm90.cuh"

// Which kernel takes (L, d): 1 the resident one, 2 the streamed one, 0
// neither (d above 128).
extern "C" int pafuse_attention_core_bwd_variant(int L, int d) {
  return attn_bwd::variant(L, d);
}

// float32 qkv (rows, 3C), dO (rows, C) and dqkv (rows, 3C) of seqs
// contiguous sequences of L tokens: dqkv = [dq | dk | dv]; stats: 3 * seqs
// * H * L floats of scratch where the streamed kernel takes (L, C / H) (its
// rows' statistics), else NULL.
extern "C" int pafuse_attention_core_bwd(const float* qkv, const float* dO, float* dqkv,
                                         float* stats, long long seqs, int L, int C, int H,
                                         float scale, void* stream) {
  return (int)launch_attention_bwd_tc(qkv, dO, dqkv, stats, seqs, L, C, H, scale,
                                      static_cast<cudaStream_t>(stream));
}

// Launches of the streamed kernel's pass A (pass 0) or pass B (pass 1)
// since the count was last zeroed (from any caller); with zero, also sets
// that count to 0.
extern "C" long long pafuse_attention_core_bwd_stream_launches(int pass, int zero) {
  std::atomic<long long>& n = pass ? attn_bwd::stream_b_launches : attn_bwd::stream_a_launches;
  return zero ? n.exchange(0) : n.load();
}
