// Trainable MixSTE transformer block + outer LayerNorm with stochastic-depth
// branch masks: forward and backward, for Hopper (sm_90a).
//
// Replaces: pafuse_tpu/ops/block_grad.py::block_train_apply, whose forward
// runs the TPU kernel _train_fwd_kernel and whose custom VJP runs
// _train_bwd_kernel.  Per sequence b of L tokens, all arithmetic in f32
// whatever the dtype T of x (the TPU train kernel keeps no bf16 rounding
// points); only the block output y and the input gradient dx are in T:
//
//   x1 = x0 + m1[b] * (Attn(LN1(x0)) @ Wproj^T + bproj)
//   x2 = x1 + m2[b] * (gelu(LN2(x1) @ Wfc1^T + bfc1) @ Wfc2^T + bfc2)
//   y  = T(LN_outer(x2))                     LayerNorm eps 1e-6, exact GELU
//
// The backward follows block_grad.py:165-238: outer-LN backward; fc2 dgrad
// with the GELU' epilogue; fc1 dgrad; LN2 backward plus the residual; proj
// dgrad; attention backward per (sequence, head); qkv dgrad; LN1 backward
// plus the residual; and the 14 parameter gradients, summed over all B*L
// rows.
//
// What bounds it on this card: the forward is ~16*M*C^2 + 4*B*L^2*C FLOPs
// and the backward twice that, against ~2-3*M*C*sizeof(T) bytes of block
// input and output: hundreds of FLOPs per byte, so both are bound by
// arithmetic.  The design:
//   * Saved, not recomputed.  The TPU kernel recomputes the forward inside
//     the backward because VMEM holds one tile's intermediates only.  Here
//     the forward writes what the backward needs (LN outputs and row
//     statistics, qkv, attention output, x1, fc1 pre-activation and GELU
//     output, x2: 8C + 2*hidden + 6 floats a row) to one device workspace.
//     At the training batch that is about 27 GB for the 48 blocks of a step,
//     a third of the card's 80 GB, and it saves the third of the backward's
//     FLOPs that a recompute would add.
//   * A chain of launches, as block.cu, with the row LayerNorms, the
//     attention forward and backward on the tensor cores (attention_core.cu
//     and attention_core_bwd.cu: attention_sm90.cuh and
//     attention_bwd_sm90.cuh, (sequence, head) units in shared memory or
//     streamed through it, mma.sync products as three TF32 products; called
//     through the addresses the caller passes, AttentionFn and
//     AttentionBwdFn), and LayerNorm-backward row kernels.  Every GEMM
//     runs on the tensor cores, every float32 product as three TF32
//     products a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
//     (x_hi = tf32(x), x_lo = tf32(x - x_hi); the dropped a_lo*b_lo is
//     ~2^-22 relative), with partial sums over at most two 32-deep K slices
//     added in f32 FADDs (the tensor cores' own f32 accumulation
//     truncates):
//       - the forward's four (kernel #5) on gemm_sm90.cuh's TMA + wgmma
//         GEMM with fused epilogues: bias (qkv); bias with the
//         pre-activation u and gelu(u) both stored (fc1, as the backward
//         needs u); and R + m[b] * (product + bias) (proj with R = x in T,
//         fc2 with R = x1), so a bf16 x is read as it is (the GEMM's R type
//         TR) and needs no converting pass.  A torch Linear weight is
//         stored (N, K), K-major already, so each call splits the four
//         weights as stored (split_weights_kernel) into a temporary of the
//         call, not into the workspace that lives until the backward;
//       - the data gradients Y = dY W (fc2 with the GELU' epilogue, fc1,
//         proj, qkv) on gemm_sm90.cuh's TMA + wgmma GEMM.  TF32 wgmma takes
//         K-major operands only, and W is stored (K, N), so each call first
//         splits the four weights transposed (split_weights_t_kernel) into
//         its scratch;
//       - the weight gradients dW = dY^T X on wgrad_mma_kernel, mma.sync
//         m16n8k8 TF32: both of its operands have the summed row index m as
//         their row, so neither is K-major for wgmma, while mma.sync takes
//         fragments that threads load from shared memory in any layout (the
//         slices arrive by cp.async as stored, 32 rows of m by 128 columns).
//   * Deterministic parameter gradients.  The TPU grid runs in order and
//     accumulates into revisited output blocks; CTAs here run concurrently.
//     Each weight gradient dW = dY^T X is computed per fixed chunk of
//     RED_ROWS rows into its own partial (the chunk's rows in order), and a
//     second kernel sums the partials in chunk order; bias and
//     LayerNorm-parameter gradients go the same way (column sums per chunk,
//     then the ordered sum).  No float atomics and no split-K whose order
//     varies: two identical calls give bit-identical gradients.
//   * No padding in device memory: L and B are taken as they are (the TPU
//     pads L to 8 and B to the tile, and masks the pad); the attention
//     stages pad their shared-memory tiles with zeros and mask the padded
//     keys, so nothing from a pad row enters a sum.
//
// Plain C interface for ctypes: the kernel functions return the cudaError_t
// of the first launch that failed, or 0; the size functions return float
// counts.  Nothing here allocates or synchronises; everything launches on
// the caller's stream.

#include "gemm_sm90.cuh"

namespace {

// rows per partial sum of a weight or bias gradient, and of a LayerNorm
// parameter gradient
constexpr int RED_ROWS = 1024;
constexpr int LNB_ROWS = 64;

struct Params {
  const float *n1s, *n1b, *wqkv, *bqkv, *wproj, *bproj, *n2s, *n2b, *wfc1, *bfc1,
      *wfc2, *bfc2, *nos, *nob;
};

// The 14 gradients, carved in parameter order from one f32 buffer, so that
// each LayerNorm's (scale, bias) pair is adjacent.
struct Grads {
  float *n1s, *n1b, *wqkv, *bqkv, *wproj, *bproj, *n2s, *n2b, *wfc1, *bfc1, *wfc2,
      *bfc2, *nos, *nob;
};

Grads carve_grads(float* p, int C, int hid) {
  Grads g;
  const long long c = C, h = hid;
  g.n1s = p; p += c;
  g.n1b = p; p += c;
  g.wqkv = p; p += 3 * c * c;
  g.bqkv = p; p += 3 * c;
  g.wproj = p; p += c * c;
  g.bproj = p; p += c;
  g.n2s = p; p += c;
  g.n2b = p; p += c;
  g.wfc1 = p; p += h * c;
  g.bfc1 = p; p += h;
  g.wfc2 = p; p += c * h;
  g.bfc2 = p; p += c;
  g.nos = p; p += c;
  g.nob = p;
  return g;
}

// What the forward saves for the backward (f32, row-major, M = B*L rows).
struct Saved {
  float *h1, *qkv, *o, *x1, *h2, *u, *gu, *x2;
  float *mean1, *rstd1, *mean2, *rstd2, *meano, *rstdo;
};

long long saved_floats(long long M, int C, int hid) {
  return M * (8LL * C + 2LL * hid + 6);
}

Saved carve_saved(float* p, long long M, int C, int hid) {
  Saved s;
  s.h1 = p; p += M * C;
  s.qkv = p; p += M * 3 * C;
  s.o = p; p += M * C;
  s.x1 = p; p += M * C;
  s.h2 = p; p += M * C;
  s.u = p; p += M * hid;
  s.gu = p; p += M * hid;
  s.x2 = p; p += M * C;
  s.mean1 = p; p += M;
  s.rstd1 = p; p += M;
  s.mean2 = p; p += M;
  s.rstd2 = p; p += M;
  s.meano = p; p += M;
  s.rstdo = p;
  return s;
}

// Backward scratch: the activation gradients, one buffer of partial sums
// that the reductions use in turn (stream order keeps them apart), and the
// TF32 hi and lo halves of the four weights, transposed, for the data
// gradients (wt: fc2, fc1, proj, qkv in turn, each hi then lo).
struct Scratch {
  float *dx2, *dm, *du, *dh2, *dx1, *da, *dO, *dqkv, *dh1, *part, *wt;
};

long long n_chunks(long long M, int rows) { return (M + rows - 1) / rows; }

long long part_floats(long long M, int C, int hid) {
  const long long c = C, h = hid;
  const long long w = n_chunks(M, RED_ROWS) * (3 * c * c > h * c ? 3 * c * c : h * c);
  const long long b = n_chunks(M, RED_ROWS) * (3 * c > h ? 3 * c : h);
  const long long l = n_chunks(M, LNB_ROWS) * 2 * c;
  return w > b ? (w > l ? w : l) : (b > l ? b : l);
}

// The TF32 hi and lo halves of the four weights: the forward's (as stored)
// or the backward's (transposed).
long long split_floats(int C, int hid) {
  return 2LL * (4LL * C * C + 2LL * hid * C);
}

long long scratch_floats(long long M, int C, int hid) {
  return M * (10LL * C + hid) + part_floats(M, C, hid) + split_floats(C, hid);
}

Scratch carve_scratch(float* p, long long M, int C, int hid) {
  Scratch s;
  s.dx2 = p; p += M * C;
  s.dm = p; p += M * C;
  s.du = p; p += M * hid;
  s.dh2 = p; p += M * C;
  s.dx1 = p; p += M * C;
  s.da = p; p += M * C;
  s.dO = p; p += M * C;
  s.dqkv = p; p += M * 3 * C;
  s.dh1 = p; p += M * C;
  s.part = p; p += part_floats(M, C, hid);
  s.wt = p;
  return s;
}

// ---------------------------------------------------------------------------
// Row LayerNorm forward, one warp per row: Y = T(LN(X)), and the row mean
// and reciprocal standard deviation for the backward.
// (LN_THREADS threads a CTA, from common.cuh.)
// ---------------------------------------------------------------------------

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const TIn* __restrict__ X, const float* __restrict__ scale,
              const float* __restrict__ bias, TOut* __restrict__ Y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out, long long M,
              int C) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const TIn* row = X + m * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32<TIn>(row[c]);
  const float mean = warp_sum(s) / (float)C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dv = to_f32<TIn>(row[c]) - mean;
    var += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)C + kLnEps);
  TOut* yrow = Y + m * C;
  for (int c = lane; c < C; c += 32)
    yrow[c] = from_f32<TOut>((to_f32<TIn>(row[c]) - mean) * rstd * scale[c] + bias[c]);
  if (lane == 0) {
    mean_out[m] = mean;
    rstd_out[m] = rstd;
  }
}

// The forward's GEMM  Y (M, N) = epilogue(A (M, K) W^T + b) for a torch
// Linear weight W (N, K), on gemm_sm90.cuh's GEMM with W already split into
// w_hi and w_lo (N, K) by split_weights: EPI_STORE (qkv), EPI_STORE_GELU
// (u and gu = gelu(u) into Y2) or EPI_MASK_RESIDUAL (Y = R + mask[m / L] *
// (A W^T + b), R in TR: the block input x in T, or x1).
template <int EPI, typename TR = float>
cudaError_t fwd_linear(const float* A, const float* w_hi, const float* w_lo, const float* bias,
                       const TR* R, const float* mask, int L, float* Y, float* Y2, long long M,
                       int N, int K, cudaStream_t stream) {
  return sm90::launch_gemm<float, PRO_NONE, EPI, float, TR>(
      A, w_hi, w_lo, bias, nullptr, nullptr, nullptr, R, Y, M, N, K, stream,
      sm90::EpiExtra{mask, Y2, L});
}

// The data-gradient GEMM  Y (M, N) = A (M, K) W [* gelu'(aux)] for a weight
// W stored (K, N), on gemm_sm90.cuh's GEMM, with W^T already split into
// wt_hi and wt_lo (N, K) by split_weights_t.
template <int EPI>
cudaError_t data_grad(const float* A, const float* wt_hi, const float* wt_lo,
                      const float* aux, float* Y, long long M, int N, int K,
                      cudaStream_t stream) {
  return sm90::launch_gemm<float, PRO_NONE, EPI>(A, wt_hi, wt_lo, nullptr, nullptr, nullptr,
                                                  nullptr, aux, Y, M, N, K, stream);
}

// ---------------------------------------------------------------------------
// Weight-gradient partials on the tensor cores:
//   P[p, n, k] = sum over the rows m of chunk p (RED_ROWS rows, in order)
//                of D[m, n] * X[m, k];  D (M, N), X (M, K) row-major.
// A CTA of 8 warps takes a 128 (n) x 128 (k) tile of one chunk; grid: k
// tiles on x, n tiles on y, chunks on z.  The chunk's rows go through a
// ring of WG_STAGES shared-memory slices of 32 rows of D and of X each,
// loaded by cp.async as stored (16 bytes a thread, zero-filled past the
// chunk, N and K).  mma.sync.m16n8k8 (TF32) takes A = D^T and B = X: a
// thread's fragment elements are single floats that it reads from the
// slices (row stride WG_LD = 8 mod 32 banks, so a warp's 32 reads hit 32
// banks) and splits into TF32 halves in registers.  Warp w owns rows
// 64 (w / 4) and columns 32 (w % 4) of the tile: 4 x 4 fragments of 16 x 8,
// three products each per 8 rows of m, summed in `part` over two slices and
// then added to `acc` in f32.
// ---------------------------------------------------------------------------

constexpr int WG_TILE = 128;                      // n and k per CTA
constexpr int WG_ROWS = 32;                       // rows m per slice
constexpr int WG_LD = WG_TILE + 8;                // shared row stride (floats)
constexpr int WG_SLICE = WG_ROWS * WG_LD;         // floats per operand slice
constexpr int WG_STAGES = 3;
constexpr int WG_THREADS = 256;
constexpr int WG_SMEM = WG_STAGES * 2 * WG_SLICE * 4;
static_assert(RED_ROWS % (2 * WG_ROWS) == 0, "a chunk is whole pairs of slices");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The TF32 halves of v as mma.sync operands.
__device__ __forceinline__ void split_bits(float v, uint32_t& hi, uint32_t& lo) {
  hi = sm90::tf32_bits(v);
  lo = sm90::tf32_bits(v - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Slice rows m0.. (< r1) of D's columns n0.. and X's columns k0.. into ds
// and xs: 32 rows x 32 chunks of 16 bytes each, four chunks a thread.
__device__ __forceinline__ void wgrad_load(float* ds, float* xs, const float* D, const float* X,
                                           long long m0, long long r1, int n0, int k0, int N,
                                           int K) {
#pragma unroll
  for (int j = 0; j < WG_ROWS * WG_TILE / 4 / WG_THREADS; ++j) {
    const int c = threadIdx.x + WG_THREADS * j, row = c >> 5, col = (c & 31) * 4;
    const long long m = m0 + row;
    const bool vd = m < r1 && n0 + col < N, vx = m < r1 && k0 + col < K;
    cp_async16(ds + row * WG_LD + col, vd ? D + m * N + n0 + col : D, vd);
    cp_async16(xs + row * WG_LD + col, vx ? X + m * K + k0 + col : X, vx);
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_mma_kernel(const float* __restrict__ D, const float* __restrict__ X,
                 float* __restrict__ P, long long M, int N, int K) {
  extern __shared__ __align__(16) float wg_smem[];
  const int k0 = blockIdx.x * WG_TILE, n0 = blockIdx.y * WG_TILE;
  const long long r0 = (long long)blockIdx.z * RED_ROWS;
  const long long r1 = r0 + RED_ROWS < M ? r0 + RED_ROWS : M;
  const int slices = (int)((r1 - r0 + WG_ROWS - 1) / WG_ROWS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;            // fragment row group, column
  const int wn = (warp >> 2) * 64, wk = (warp & 3) * 32;
  auto ds_of = [&](int s) { return wg_smem + (s % WG_STAGES) * 2 * WG_SLICE; };

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < slices)
      wgrad_load(ds_of(s), ds_of(s) + WG_SLICE, D, X, r0 + s * WG_ROWS, r1, n0, k0, N, K);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
#pragma unroll 1
  for (int s = 0; s < slices; ++s) {
    asm volatile("cp.async.wait_group %0;" ::"n"(WG_STAGES - 2) : "memory");
    __syncthreads();      // slice s is in; every warp is done with slice s - 1
    const int next = s + WG_STAGES - 1;
    if (next < slices)
      wgrad_load(ds_of(next), ds_of(next) + WG_SLICE, D, X, r0 + next * WG_ROWS, r1, n0, k0,
                 N, K);
    asm volatile("cp.async.commit_group;" ::: "memory");

    if (s % 2 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    }
    const float* ds = ds_of(s);
    const float* xs = ds + WG_SLICE;
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 8; ++kk) {
      // fragment rows m = 8 kk + t and 8 kk + t + 4 of the slice
      const float* d0 = ds + (8 * kk + t) * WG_LD + wn + g;
      const float* x0 = xs + (8 * kk + t) * WG_LD + wk + g;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_bits(x0[8 * j], bh[j][0], bl[j][0]);
        split_bits(x0[8 * j + 4 * WG_LD], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t ah[4], al[4];
        split_bits(d0[16 * i], ah[0], al[0]);
        split_bits(d0[16 * i + 8], ah[1], al[1]);
        split_bits(d0[16 * i + 4 * WG_LD], ah[2], al[2]);
        split_bits(d0[16 * i + 8 + 4 * WG_LD], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {     // smallest products first
          mma_tf32(part[i][j], al, bh[j]);
          mma_tf32(part[i][j], ah, bl[j]);
          mma_tf32(part[i][j], ah, bh[j]);
        }
      }
    }
    if (s % 2 == 1 || s == slices - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // fragment (i, j): element 2h + {0, 1} is (row 16 i + g + 8 h, col 8 j + 2 t + {0, 1})
  float* out = P + (long long)blockIdx.z * N * K;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn + 16 * i + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + wk + 8 * j + 2 * t;
        if (k < K)      // K % 8 == 0, so k + 1 < K as well
          *reinterpret_cast<float2*>(out + (long long)n * K + k) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// Column-sum partials  P[p, n] = sum over the rows m of chunk p of D[m, n].
constexpr int COL_THREADS = 256;

__global__ void __launch_bounds__(COL_THREADS)
colsum_kernel(const float* __restrict__ D, float* __restrict__ P, long long M, int N) {
  const int n = blockIdx.x * COL_THREADS + threadIdx.x;
  if (n >= N) return;
  const long long r0 = (long long)blockIdx.y * RED_ROWS;
  const long long r1 = r0 + RED_ROWS < M ? r0 + RED_ROWS : M;
  float s = 0.f;
  for (long long m = r0; m < r1; ++m) s += D[m * N + n];
  P[(long long)blockIdx.y * N + n] = s;
}

// out[e] = sum over p = 0, 1, ... of P[p, e]: the second, ordered pass.
__global__ void __launch_bounds__(COL_THREADS)
reduce_partials_kernel(const float* __restrict__ P, long long nparts, long long E,
                       float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * COL_THREADS + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (long long p = 0; p < nparts; ++p) s += P[p * E + e];
  out[e] = s;
}

cudaError_t reduce_partials(const float* P, long long nparts, long long E, float* out,
                            cudaStream_t stream) {
  reduce_partials_kernel<<<(unsigned)((E + COL_THREADS - 1) / COL_THREADS), COL_THREADS,
                           0, stream>>>(P, nparts, E, out);
  return cudaGetLastError();
}

// dW (N, K) = D^T X in fixed order: the partials, then the ordered pass.
// N and K multiples of 8 (the 8-byte stores of the partials).
cudaError_t weight_grad(const float* D, const float* X, float* part, float* dW, long long M,
                        int N, int K, cudaStream_t stream) {
  if (M < 1 || N % 8 || K % 8) return cudaErrorInvalidValue;
  const long long nch = n_chunks(M, RED_ROWS);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((K + WG_TILE - 1) / WG_TILE), (unsigned)((N + WG_TILE - 1) / WG_TILE),
                  (unsigned)nch);
  wgrad_mma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(D, X, part, M, N, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, nch, (long long)N * K, dW, stream);
}

// dW (N, K) = D^T X and db (N) = column sums of D, both in fixed order.
cudaError_t weight_grads(const float* D, const float* X, float* part, float* dW,
                         float* db, long long M, int N, int K, cudaStream_t stream) {
  cudaError_t err = weight_grad(D, X, part, dW, M, N, K, stream);
  if (err != cudaSuccess) return err;
  const long long nch = n_chunks(M, RED_ROWS);
  colsum_kernel<<<dim3((unsigned)((N + COL_THREADS - 1) / COL_THREADS), (unsigned)nch),
                  COL_THREADS, 0, stream>>>(D, part, M, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, nch, N, db, stream);
}

// ---------------------------------------------------------------------------
// LayerNorm backward, LNB_ROWS rows per CTA, one warp per row at a time:
//   DX = R + rstd * (g*s - mean_C(g*s) - xhat * mean_C(g*s*xhat)),
//   DXM = mask[m / L] * DX (the masked branch gradient, when asked for),
// and per-CTA partials P[p, 0, c] = sum of g*xhat, P[p, 1, c] = sum of g
// over the CTA's rows (warps in fixed order), for the scale and bias
// gradients.  xhat is recomputed from X and the saved row statistics.  A
// lane holds MAXJ columns of a row: C <= 512 at LNB_MAXJ, C <= 1024 at
// LNB_WIDE_MAXJ, whose warps' partials go through one shared buffer twice
// (the scale sums, then the bias sums: the same order) to stay within the
// 48 KB of static shared memory.
// ---------------------------------------------------------------------------

constexpr int LNB_THREADS = 256, LNB_WARPS = LNB_THREADS / 32;
constexpr int LNB_MAXJ = 16;          // C <= 32 * LNB_MAXJ = 512
constexpr int LNB_WIDE_MAXJ = 32;     // C <= 1024

template <typename TG, typename TX, typename TO, int MAXJ>
__global__ void __launch_bounds__(LNB_THREADS)
ln_bwd_kernel(const TG* __restrict__ G, const TX* __restrict__ X,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ R,
              const float* __restrict__ mask, int L, TO* __restrict__ DX,
              float* __restrict__ DXM, float* __restrict__ P, long long M, int C) {
  constexpr int MAXC = 32 * MAXJ, PARTS = MAXJ > LNB_MAXJ ? 1 : 2;
  __shared__ float red[LNB_WARPS][PARTS][MAXC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * LNB_ROWS;
  float ps[MAXJ], pb[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) ps[j] = pb[j] = 0.f;

  for (int r = warp; r < LNB_ROWS; r += LNB_WARPS) {
    const long long m = r0 + r;
    if (m >= M) break;
    const float mu = mean[m], inv = rstd[m];
    float gv[MAXJ], xh[MAXJ];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      gv[j] = xh[j] = 0.f;
      if (c < C) {
        const float dy = to_f32<TG>(G[m * C + c]);
        const float xhat = (to_f32<TX>(X[m * C + c]) - mu) * inv;
        const float gs = dy * scale[c];
        gv[j] = dy;
        xh[j] = xhat;
        s1 += gs;
        s2 += gs * xhat;
        ps[j] += dy * xhat;
        pb[j] += dy;
      }
    }
    s1 = warp_sum(s1) / (float)C;
    s2 = warp_sum(s2) / (float)C;
    const float mk = DXM != nullptr ? mask[m / L] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        float dx = inv * (gv[j] * scale[c] - s1 - xh[j] * s2);
        if (R != nullptr) dx += R[m * C + c];
        DX[m * C + c] = from_f32<TO>(dx);
        if (DXM != nullptr) DXM[m * C + c] = mk * dx;
      }
    }
  }

  float* out = P + (long long)blockIdx.x * 2 * C;
  if constexpr (PARTS == 2) {
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < C) {
        red[warp][0][c] = ps[j];
        red[warp][1][c] = pb[j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += LNB_THREADS) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < LNB_WARPS; ++w) {
        a += red[w][0][c];
        b += red[w][1][c];
      }
      out[c] = a;
      out[C + c] = b;
    }
  } else {
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int c = lane + 32 * j;
        if (c < C) red[warp][0][c] = part == 0 ? ps[j] : pb[j];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < C; c += LNB_THREADS) {
        float a = 0.f;
        for (int w = 0; w < LNB_WARPS; ++w) a += red[w][0][c];
        out[part * C + c] = a;
      }
      __syncthreads();     // read before the bias sums overwrite it
    }
  }
}

// LayerNorm backward over all rows, then (dscale, dbias) into ds_db (2C
// adjacent floats) by the ordered second pass.
template <typename TG, typename TX, typename TO>
cudaError_t ln_backward(const TG* G, const TX* X, const float* mean, const float* rstd,
                        const float* scale, const float* R, const float* mask, int L,
                        TO* DX, float* DXM, float* part, float* ds_db, long long M,
                        int C, cudaStream_t stream) {
  const long long nch = n_chunks(M, LNB_ROWS);
  if (C > 32 * LNB_WIDE_MAXJ) return cudaErrorInvalidValue;
  if (C <= 32 * LNB_MAXJ)
    ln_bwd_kernel<TG, TX, TO, LNB_MAXJ><<<(unsigned)nch, LNB_THREADS, 0, stream>>>(
        G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C);
  else
    ln_bwd_kernel<TG, TX, TO, LNB_WIDE_MAXJ><<<(unsigned)nch, LNB_THREADS, 0, stream>>>(
        G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, nch, 2LL * C, ds_db, stream);
}

// ---------------------------------------------------------------------------
// The two chains.
// ---------------------------------------------------------------------------

#define RETURN_IF_ERROR(expr)               \
  do {                                      \
    const cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

template <typename T>
cudaError_t train_fwd(const T* x, const float* m1, const float* m2, const Params& p,
                      T* y, float* ws, float* split, AttentionFn attention, long long B,
                      int L, int C, int H, int hid, float scale, cudaStream_t st) {
  const long long M = B * L;
  const Saved s = carve_saved(ws, M, C, hid);
  const unsigned ln_grid = (unsigned)((M + LN_THREADS / 32 - 1) / (LN_THREADS / 32));
  const float* none = nullptr;

  // 0. the four weights W (N, K) -> their TF32 halves, into split
  const float* w[4] = {p.wqkv, p.wproj, p.wfc1, p.wfc2};
  const long long n[4] = {3LL * C * C, (long long)C * C, (long long)hid * C,
                          (long long)C * hid};
  const float* hi[4];
  const float* lo[4];
  for (int i = 0; i < 4; ++i) {
    RETURN_IF_ERROR(sm90::split_weights<float>(w[i], split, split + n[i], n[i], st));
    hi[i] = split;
    lo[i] = split + n[i];
    split += 2 * n[i];
  }

  // 1. h1 = LN1(x0)
  ln_fwd_kernel<T, float><<<ln_grid, LN_THREADS, 0, st>>>(x, p.n1s, p.n1b, s.h1,
                                                          s.mean1, s.rstd1, M, C);
  RETURN_IF_ERROR(cudaGetLastError());
  // 2. qkv = h1 Wqkv^T + bqkv
  RETURN_IF_ERROR(fwd_linear<EPI_STORE>(s.h1, hi[0], lo[0], p.bqkv, none, nullptr, L, s.qkv,
                                        nullptr, M, 3 * C, C, st));
  // 3. o = per-head softmax(q k^T * scale) v, float32 on the tensor cores
  RETURN_IF_ERROR((cudaError_t)attention(0, s.qkv, s.o, B, L, 1, C, H, scale, st));
  // 4. x1 = x0 + m1 * (o Wproj^T + bproj)
  RETURN_IF_ERROR((fwd_linear<EPI_MASK_RESIDUAL, T>(s.o, hi[1], lo[1], p.bproj, x, m1, L,
                                                    s.x1, nullptr, M, C, C, st)));
  // 5. h2 = LN2(x1)
  ln_fwd_kernel<float, float><<<ln_grid, LN_THREADS, 0, st>>>(s.x1, p.n2s, p.n2b, s.h2,
                                                              s.mean2, s.rstd2, M, C);
  RETURN_IF_ERROR(cudaGetLastError());
  // 6. u = h2 Wfc1^T + bfc1, gu = gelu(u)
  RETURN_IF_ERROR(fwd_linear<EPI_STORE_GELU>(s.h2, hi[2], lo[2], p.bfc1, none, nullptr, L,
                                             s.u, s.gu, M, hid, C, st));
  // 7. x2 = x1 + m2 * (gu Wfc2^T + bfc2)
  RETURN_IF_ERROR(fwd_linear<EPI_MASK_RESIDUAL>(s.gu, hi[3], lo[3], p.bfc2, s.x1, m2, L, s.x2,
                                                nullptr, M, C, hid, st));
  // 8. y = T(LN_outer(x2))
  ln_fwd_kernel<float, T><<<ln_grid, LN_THREADS, 0, st>>>(s.x2, p.nos, p.nob, y, s.meano,
                                                          s.rstdo, M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t train_bwd(const T* x, const T* g, const float* m1, const float* m2,
                      const Params& p, float* ws, T* dx, float* grads, float* scratch,
                      float* stats, AttentionBwdFn attention_bwd, long long B, int L, int C,
                      int H, int hid, float scale, cudaStream_t st) {
  const long long M = B * L;
  const Saved s = carve_saved(ws, M, C, hid);
  const Grads gr = carve_grads(grads, C, hid);
  const Scratch t = carve_scratch(scratch, M, C, hid);
  const float* none = nullptr;

  // 0. the four weights W (K, N) -> the TF32 halves of W^T (N, K)
  const float* w[4] = {p.wfc2, p.wfc1, p.wproj, p.wqkv};
  const int rows[4] = {C, hid, C, 3 * C}, cols[4] = {hid, C, C, C};
  const float* hi[4];
  const float* lo[4];
  float* wt = t.wt;
  for (int i = 0; i < 4; ++i) {
    const long long n = (long long)rows[i] * cols[i];
    RETURN_IF_ERROR(sm90::split_weights_t(w[i], wt, wt + n, rows[i], cols[i], st));
    hi[i] = wt;
    lo[i] = wt + n;
    wt += 2 * n;
  }

  // 1. outer LN: dx2 = LNo'(g), dm = m2 * dx2; dnos, dnob
  RETURN_IF_ERROR((ln_backward<T, float, float>(g, s.x2, s.meano, s.rstdo, p.nos, none,
                                                m2, L, t.dx2, t.dm, t.part, gr.nos, M,
                                                C, st)));
  // 2. du = (dm Wfc2) * gelu'(u)
  RETURN_IF_ERROR(data_grad<EPI_GELU_GRAD>(t.dm, hi[0], lo[0], s.u, t.du, M, hid, C, st));
  // 3. dWfc2 = dm^T gu, dbfc2 = sum of dm
  RETURN_IF_ERROR(weight_grads(t.dm, s.gu, t.part, gr.wfc2, gr.bfc2, M, C, hid, st));
  // 4. dh2 = du Wfc1
  RETURN_IF_ERROR(data_grad<EPI_NONE>(t.du, hi[1], lo[1], none, t.dh2, M, C, hid, st));
  // 5. dWfc1 = du^T h2, dbfc1 = sum of du
  RETURN_IF_ERROR(weight_grads(t.du, s.h2, t.part, gr.wfc1, gr.bfc1, M, hid, C, st));
  // 6. LN2: dx1 = dx2 + LN2'(dh2), da = m1 * dx1; dn2s, dn2b
  RETURN_IF_ERROR((ln_backward<float, float, float>(t.dh2, s.x1, s.mean2, s.rstd2, p.n2s,
                                                    t.dx2, m1, L, t.dx1, t.da, t.part,
                                                    gr.n2s, M, C, st)));
  // 7. dO = da Wproj
  RETURN_IF_ERROR(data_grad<EPI_NONE>(t.da, hi[2], lo[2], none, t.dO, M, C, C, st));
  // 8. dWproj = da^T o, dbproj = sum of da
  RETURN_IF_ERROR(weight_grads(t.da, s.o, t.part, gr.wproj, gr.bproj, M, C, C, st));
  // 9. attention backward -> dqkv, on the tensor cores
  RETURN_IF_ERROR(
      (cudaError_t)attention_bwd(s.qkv, t.dO, t.dqkv, stats, B, L, C, H, scale, st));
  // 10. dh1 = dqkv Wqkv
  RETURN_IF_ERROR(data_grad<EPI_NONE>(t.dqkv, hi[3], lo[3], none, t.dh1, M, C, 3 * C, st));
  // 11. dWqkv = dqkv^T h1, dbqkv = sum of dqkv
  RETURN_IF_ERROR(
      weight_grads(t.dqkv, s.h1, t.part, gr.wqkv, gr.bqkv, M, 3 * C, C, st));
  // 12. LN1: dx0 = dx1 + LN1'(dh1); dn1s, dn1b
  return ln_backward<float, T, T>(t.dh1, x, s.mean1, s.rstd1, p.n1s, t.dx1, none, L, dx,
                                  nullptr, t.part, gr.n1s, M, C, st);
}

}  // namespace

extern "C" long long pafuse_block_train_saved_floats(long long B, int L, int C, int hid) {
  return saved_floats(B * L, C, hid);
}

extern "C" long long pafuse_block_train_scratch_floats(long long B, int L, int C,
                                                       int hid) {
  return scratch_floats(B * L, C, hid);
}

// The forward's weight split, a temporary of each forward call.
extern "C" long long pafuse_block_train_split_floats(int C, int hid) {
  return split_floats(C, hid);
}

// The forward's GEMM alone (for its tests and timings): Y (M, N) = A (M,
// K) W^T + b for W (N, K), with ws (8 N K bytes) taking W's split, and the
// epilogue 0: store; 1: also Y2 = gelu(Y); 2: Y = R + mask[m / L] * (A W^T
// + b), R (M, N) float32 or (r_is_bf16) bfloat16.
extern "C" int pafuse_fwd_linear(const float* A, const float* W, const float* bias,
                                 int epilogue, const void* R, int r_is_bf16,
                                 const float* mask, int L, float* Y, float* Y2, float* ws,
                                 long long M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)N * K;
  const float* none = nullptr;
  RETURN_IF_ERROR(sm90::split_weights<float>(W, ws, ws + n, n, st));
  switch (epilogue) {
    case 0:
      return (int)fwd_linear<EPI_STORE>(A, ws, ws + n, bias, none, nullptr, 1, Y, nullptr, M,
                                        N, K, st);
    case 1:
      return (int)fwd_linear<EPI_STORE_GELU>(A, ws, ws + n, bias, none, nullptr, 1, Y, Y2, M,
                                             N, K, st);
    case 2:
      if (r_is_bf16)
        return (int)fwd_linear<EPI_MASK_RESIDUAL>(
            A, ws, ws + n, bias, static_cast<const __nv_bfloat16*>(R), mask, L, Y, nullptr,
            M, N, K, st);
      return (int)fwd_linear<EPI_MASK_RESIDUAL>(A, ws, ws + n, bias,
                                                static_cast<const float*>(R), mask, L, Y,
                                                nullptr, M, N, K, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward's two GEMMs alone (for their tests and timings):
// Y (M, N) = A (M, K) W for W stored (K, N), times gelu'(aux) when aux is
// not NULL, with ws (8 N K bytes) taking the split of W^T; and dW (N, K) =
// D^T X summed in the backward's fixed order through part
// (pafuse_weight_grad_part_floats floats).
extern "C" int pafuse_data_grad(const float* A, const float* W, const float* aux, float* Y,
                                float* ws, long long M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)N * K;
  RETURN_IF_ERROR(sm90::split_weights_t(W, ws, ws + n, K, N, st));
  if (aux != nullptr)
    return (int)data_grad<EPI_GELU_GRAD>(A, ws, ws + n, aux, Y, M, N, K, st);
  return (int)data_grad<EPI_NONE>(A, ws, ws + n, nullptr, Y, M, N, K, st);
}

extern "C" long long pafuse_weight_grad_part_floats(long long M, int N, int K) {
  return n_chunks(M, RED_ROWS) * N * K;
}

extern "C" int pafuse_weight_grad(const float* D, const float* X, float* part, float* dW,
                                  long long M, int N, int K, void* stream) {
  return (int)weight_grad(D, X, part, dW, M, N, K, static_cast<cudaStream_t>(stream));
}

extern "C" int pafuse_block_train_fwd(
    int is_bf16, const void* x, const float* m1, const float* m2, const float* n1s,
    const float* n1b, const float* wqkv, const float* bqkv, const float* wproj,
    const float* bproj, const float* n2s, const float* n2b, const float* wfc1,
    const float* bfc1, const float* wfc2, const float* bfc2, const float* nos,
    const float* nob, void* y, float* ws, float* split, void* attention, long long B, int L,
    int C, int H, int hid, float scale, void* stream) {
  const Params p{n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b,
                 wfc1, bfc1, wfc2, bfc2, nos, nob};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttentionFn fn = reinterpret_cast<AttentionFn>(attention);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)train_fwd<T>(static_cast<const T*>(x), m1, m2, p, static_cast<T*>(y), ws,
                             split, fn, B, L, C, H, hid, scale, st);
  }
  return (int)train_fwd<float>(static_cast<const float*>(x), m1, m2, p,
                               static_cast<float*>(y), ws, split, fn, B, L, C, H, hid, scale,
                               st);
}

// stats: the streamed attention backward's row statistics (3 * B * H * L
// floats), or NULL where the resident kernel takes (L, C / H).
extern "C" int pafuse_block_train_bwd(
    int is_bf16, const void* x, const void* g, const float* m1, const float* m2,
    const float* n1s, const float* n1b, const float* wqkv, const float* bqkv,
    const float* wproj, const float* bproj, const float* n2s, const float* n2b,
    const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
    const float* nos, const float* nob, float* ws, void* dx, float* grads,
    float* scratch, float* stats, void* attention_bwd, long long B, int L, int C, int H,
    int hid, float scale, void* stream) {
  const Params p{n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b,
                 wfc1, bfc1, wfc2, bfc2, nos, nob};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttentionBwdFn fn = reinterpret_cast<AttentionBwdFn>(attention_bwd);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return (int)train_bwd<T>(static_cast<const T*>(x), static_cast<const T*>(g), m1, m2,
                             p, ws, static_cast<T*>(dx), grads, scratch, stats, fn, B, L, C,
                             H, hid, scale, st);
  }
  return (int)train_bwd<float>(static_cast<const float*>(x), static_cast<const float*>(g),
                               m1, m2, p, ws, static_cast<float*>(dx), grads, scratch, stats,
                               fn, B, L, C, H, hid, scale, st);
}
