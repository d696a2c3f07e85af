// The Hopper GEMM of the eval block chain (gemm_sm90.cuh), exported on its
// own for ops/gemm.py::fused_linear: one stage of the chain,
//
//   Y = T(epilogue(prologue(A) @ W^T + b))
//
// prologue: none, or the row LayerNorm (scale, bias) rounded to T (bf16:
// a pre-pass, gemm_sm90.cuh's ln_gemm);
// epilogue: store, exact GELU, or R + T(product).  It is the GEMM of
// kernels #1, #3 and #4 (pafuse_tpu/ops/attention.py::pallas_block,
// pallas_block_temporal, pallas_layer: the dot2d products of _block_body),
// whose design and bounds gemm_sm90.cuh describes.  chip_smoke.py's
// gemm_kernel phase times it stage by stage against F.linear.
//
// Plain C interface for ctypes: returns the cudaError_t of the first launch
// that failed, or 0.  Nothing here allocates or synchronises; everything
// launches on the caller's stream.

#include "gemm_sm90.cuh"

namespace {

template <typename T, int PRO, int EPI>
cudaError_t linear(const T* A, const float* W, const float* bias, const float* ln_s,
                   const float* ln_b, const T* R, T* Y, void* ws, long long M, int N, int K,
                   cudaStream_t stream) {
  using namespace sm90;
  T* hi = static_cast<T*>(ws);
  T* lo = Cfg<T>::NT == 2 ? hi + (long long)N * K : nullptr;
  cudaError_t err = split_weights<T>(W, hi, lo, (long long)N * K, stream);
  if (err != cudaSuccess) return err;
  if (PRO == PRO_NONE)
    return launch_gemm<T, PRO_NONE, EPI>(A, hi, lo, bias, nullptr, nullptr, nullptr, R, Y, M,
                                         N, K, stream);
  float2* stats = reinterpret_cast<float2*>(static_cast<char*>(ws) + 8LL * N * K);
  T* buf = hi + (long long)N * K;       // bf16: LN(A) after the rounded weight
  return ln_gemm<T, EPI>(A, ln_s, ln_b, hi, lo, bias, R, Y, buf, stats, M, N, K, stream);
}

template <typename T, int PRO>
cudaError_t linear_epi(int epi, const T* A, const float* W, const float* bias,
                       const float* ln_s, const float* ln_b, const T* R, T* Y, void* ws,
                       long long M, int N, int K, cudaStream_t stream) {
  switch (epi) {
    case EPI_STORE:
      return linear<T, PRO, EPI_STORE>(A, W, bias, ln_s, ln_b, R, Y, ws, M, N, K, stream);
    case EPI_GELU:
      return linear<T, PRO, EPI_GELU>(A, W, bias, ln_s, ln_b, R, Y, ws, M, N, K, stream);
    case EPI_RESIDUAL:
      return linear<T, PRO, EPI_RESIDUAL>(A, W, bias, ln_s, ln_b, R, Y, ws, M, N, K, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t linear_any(int pro, int epi, const void* A, const float* W, const float* bias,
                       const float* ln_s, const float* ln_b, const void* R, void* Y,
                       void* ws, long long M, int N, int K, cudaStream_t stream) {
  const T* a = static_cast<const T*>(A);
  const T* r = static_cast<const T*>(R);
  T* y = static_cast<T*>(Y);
  if (pro == PRO_LAYERNORM)
    return linear_epi<T, PRO_LAYERNORM>(epi, a, W, bias, ln_s, ln_b, r, y, ws, M, N, K, stream);
  if (pro == PRO_NONE)
    return linear_epi<T, PRO_NONE>(epi, a, W, bias, ln_s, ln_b, r, y, ws, M, N, K, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// prologue: 0 none, 1 LayerNorm; epilogue: 0 store, 1 GELU, 2 residual.
// ws: ws_bytes >= 8 N K + 8 M for f32, the weight's TF32 hi and lo halves,
// then the (mean, rstd) of every row; 2 N K + 2 M K for bf16, the rounded
// weight, then LN(A) (ops/gemm.py::linear_workspace_bytes).
extern "C" int pafuse_linear_sm90(int is_bf16, int prologue, int epilogue, const void* A,
                                  const float* W, const float* bias, const float* ln_s,
                                  const float* ln_b, const void* R, void* Y, void* ws,
                                  long long ws_bytes, long long M, int N, int K,
                                  void* stream) {
  if (ws_bytes < (is_bf16 ? 2LL * N * K + 2LL * M * K : 8LL * N * K + 8LL * M))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)linear_any<__nv_bfloat16>(prologue, epilogue, A, W, bias, ln_s, ln_b, R, Y,
                                          ws, M, N, K, s);
  return (int)linear_any<float>(prologue, epilogue, A, W, bias, ln_s, ln_b, R, Y, ws, M, N,
                                K, s);
}
