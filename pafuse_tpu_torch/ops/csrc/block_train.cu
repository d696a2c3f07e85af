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
//       - the weight and bias gradients dW = dY^T X, db = the column sums
//         of dY on wgrad_sm90.cuh's wgrad_wgmma_kernel (TMA + wgmma, A = dY^T
//         from registers, B = X^T split once a CTA into K-major tiles in
//         shared memory; both operands have the summed row index m as their
//         row, so neither arrives K-major), which takes the bias sums from
//         the same reads of dY.
//   * Deterministic parameter gradients.  The TPU grid runs in order and
//     accumulates into revisited output blocks; CTAs here run concurrently.
//     Each weight gradient dW = dY^T X and its bias gradient are computed
//     per fixed chunk of rows (wgrad::chunk_rows, a function of M, N and K
//     alone) into their own partial, and a second kernel sums the partials
//     in chunk order; the LayerNorm-parameter gradients go the same way
//     (column sums per CTA over ln_rows(M, C) rows, then ln_sums_kernel's
//     fixed two-level order).  No float atomics and no split-K whose order
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

#include "wgrad_sm90.cuh"

namespace {

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

long long n_chunks(long long M, long long rows) { return (M + rows - 1) / rows; }

// ---------------------------------------------------------------------------
// The LayerNorm backward's rows rule (ops/block_train.py's
// ln_backward_rows is its twin).  A lane holds NCH chunks of 4 columns of a
// row: the width class, 1, 2, 3, 4, 6 or 8 chunks for C up to 128, 256,
// 384, 512, 768 or 1024.  lnb_ctas(NCH) CTAs of a class fit an SM (its
// launch bound), and the grid is one wave of them on the card's 132 SMs:
// each CTA takes ln_rows(M, C) consecutive rows, the last what is left, so
// a call writes ln_parts(M, C) <= 396 partials whatever M is.
// ---------------------------------------------------------------------------

constexpr int LNB_THREADS = 256, LNB_WARPS = LNB_THREADS / 32, LNB_SMS = 132;

constexpr int lnb_chunks(int C) {
  return C <= 128 ? 1 : C <= 256 ? 2 : C <= 384 ? 3 : C <= 512 ? 4 : C <= 768 ? 6 : 8;
}

constexpr int lnb_ctas(int nch) { return nch <= 2 ? 3 : nch <= 4 ? 2 : 1; }

long long ln_rows(long long M, int C) {
  return n_chunks(M, (long long)LNB_SMS * lnb_ctas(lnb_chunks(C)));
}

long long ln_parts(long long M, int C) { return n_chunks(M, ln_rows(M, C)); }

long long part_floats(long long M, int C, int hid) {
  // the four weight gradients (N, K): fc2, fc1, proj, qkv
  const int shapes[4][2] = {{C, hid}, {hid, C}, {C, C}, {3 * C, C}};
  long long most = ln_parts(M, C) * 2 * C;
  for (const auto& nk : shapes) {
    const long long w = wgrad::part_floats(M, nk[0], nk[1]);
    most = w > most ? w : most;
  }
  return most;
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

constexpr int RED_THREADS = 128, RED_UNROLL = 32;

// out[e] = sum over p = 0, 1, ... of P[p, e], in that order: the weight
// gradients' second, ordered pass.  A thread keeps the loads of RED_UNROLL
// parts in flight and adds them one by one, so it waits one load's latency
// per RED_UNROLL parts, not per part; the order of the additions, and so
// the bits, are the same.
__global__ void __launch_bounds__(RED_THREADS)
reduce_partials_kernel(const float* __restrict__ P, long long nparts, long long E,
                       float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= E) return;
  const float* col = P + e;
  float s = 0.f;
  long long p = 0;
  for (; p + RED_UNROLL <= nparts; p += RED_UNROLL) {
    float v[RED_UNROLL];
#pragma unroll
    for (int q = 0; q < RED_UNROLL; ++q) v[q] = __ldg(col + (p + q) * E);
#pragma unroll
    for (int q = 0; q < RED_UNROLL; ++q) s += v[q];
  }
  for (; p < nparts; ++p) s += __ldg(col + p * E);
  out[e] = s;
}

cudaError_t reduce_partials(const float* P, long long nparts, long long E, float* out,
                            cudaStream_t stream) {
  reduce_partials_kernel<<<(unsigned)((E + RED_THREADS - 1) / RED_THREADS), RED_THREADS,
                           0, stream>>>(P, nparts, E, out);
  return counted(LAUNCH_REDUCE_PARTIALS, cudaGetLastError());
}

// dW (N, K) = D^T X and db (N) = the column sums of D, both in fixed order,
// into dwdb (dW, then db: carve_grads keeps each weight's gradient and its
// bias's adjacent): the chunks' partials of both (wgrad_wgmma_kernel, one
// read of D), then one ordered pass over both.  N and K multiples of 8.
cudaError_t weight_grads(const float* D, const float* X, float* part, float* dwdb,
                         long long M, int N, int K, cudaStream_t stream) {
  const cudaError_t err = wgrad::partials(D, X, part, M, N, K, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, wgrad::chunks(M, N, K), (long long)N * K + N, dwdb, stream);
}

// ---------------------------------------------------------------------------
// LayerNorm backward (block_grad.py's _ln_bwd, :55, at the TPU kernel's
// :166, :188 and :237), one warp a row:
//   DX = R + rstd * (g*s - mean_C(g*s) - xhat * mean_C(g*s*xhat)),
//   DXM = mask[m / L] * DX (the masked branch gradient, when asked for),
// and per-CTA partials P[p, 0, c] = sum of g*xhat, P[p, 1, c] = sum of g
// over the CTA's rows, for the scale and bias gradients.  xhat is
// recomputed from X and the saved row statistics.  f32 arithmetic whatever
// TG, TX and TO; only DX is rounded to TO.
//
// What bounds it: bytes.  Per element it reads G and X (and R) and writes
// DX (and DXM), 16-20 bytes in float32, for ~12 FLOPs.  The design:
//   * a lane owns contiguous 4-column chunks c4 = lane + 32 q (q < NCH), so
//     every access is one 16-byte (float32) or 8-byte (bfloat16) vector, and
//     a row's G, X and R loads are all issued before its two warp sums;
//   * the width class NCH is a template argument: a 224- or 256-column row
//     holds 2 chunks a lane, not 512 columns' worth of registers, and
//     lnb_ctas(NCH) CTAs of 256 threads fit an SM (the launch bound);
//   * one wave of ln_parts(M, C) CTAs, each ln_rows(M, C) consecutive rows,
//     so no partly empty last wave, and at most 396 partials of 2C floats;
//   * the scale in shared memory, read from device memory once a CTA.
// Two rows in flight a warp, or a ring of shared memory filled by bulk
// copies (TMA) a stage of eight rows at a time from a producer warp, were
// no faster on the H100 (PERF.md §6); a copy of the same bytes takes ~93%
// of its time there.  A warp takes the CTA's rows
// warp, warp + 8, ... and sums its columns over them in that order; the
// CTA adds its warps' sums in warp order (through shared memory: the scale
// sums, then the bias sums).  C % 8 == 0, the tensors 16-byte aligned.
// ---------------------------------------------------------------------------

// 4 consecutive values of a row to and from f32: one 16-byte float32 or
// 8-byte bfloat16 access.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename TG, typename TX, typename TO, int NCH>
__global__ void __launch_bounds__(LNB_THREADS, lnb_ctas(NCH))
ln_bwd_kernel(const TG* __restrict__ G, const TX* __restrict__ X,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ R,
              const float* __restrict__ mask, int L, TO* __restrict__ DX,
              float* __restrict__ DXM, float* __restrict__ P, long long M, int C,
              long long rows) {
  constexpr int W = 128 * NCH;            // the class's widest row
  __shared__ __align__(16) float sc[W];
  __shared__ __align__(16) float red[LNB_WARPS][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, chunks = C >> 2;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  for (int c = threadIdx.x; c < C; c += LNB_THREADS) sc[c] = scale[c];
  __syncthreads();

  float ps[NCH][4], pb[NCH][4];
#pragma unroll
  for (int q = 0; q < NCH; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) ps[q][e] = pb[q][e] = 0.f;

  for (long long m = r0 + warp; m < r1; m += LNB_WARPS) {
    const float mu = __ldg(mean + m), inv = __ldg(rstd + m);
    const float mk = DXM != nullptr ? __ldg(mask + (unsigned)m / (unsigned)L) : 0.f;
    float g[NCH][4], xh[NCH][4], rv[NCH][4];
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c4 = lane + 32 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) g[q][e] = xh[q][e] = rv[q][e] = 0.f;
      if (c4 < chunks) {
        load4(G + m * C + 4 * c4, g[q]);
        load4(X + m * C + 4 * c4, xh[q]);
        if (R != nullptr) load4(R + m * C + 4 * c4, rv[q]);
      }
    }
    // g -> g*s and x -> xhat in place; the row sums and the column partials
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      if (lane + 32 * q >= chunks) continue;
      const float4 s4 = *reinterpret_cast<const float4*>(sc + 4 * (lane + 32 * q));
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dy = g[q][e];
        const float xhat = (xh[q][e] - mu) * inv;
        const float gs = dy * s[e];
        g[q][e] = gs;
        xh[q][e] = xhat;
        s1 += gs;
        s2 += gs * xhat;
        ps[q][e] += dy * xhat;
        pb[q][e] += dy;
      }
    }
    s1 = warp_sum(s1) / (float)C;
    s2 = warp_sum(s2) / (float)C;
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c4 = lane + 32 * q;
      if (c4 >= chunks) continue;
      float dx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dx[e] = inv * (g[q][e] - s1 - xh[q][e] * s2);
        if (R != nullptr) dx[e] += rv[q][e];
      }
      store4(DX + m * C + 4 * c4, dx);
      if (DXM != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[e] *= mk;
        store4(DXM + m * C + 4 * c4, dx);
      }
    }
  }

  float* out = P + (long long)blockIdx.x * 2 * C;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c4 = lane + 32 * q;
      if (c4 < chunks) store4(&red[warp][4 * c4], part == 0 ? ps[q] : pb[q]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += LNB_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < LNB_WARPS; ++w) a += red[w][c];
      out[part * C + c] = a;
    }
    __syncthreads();     // read before the bias sums overwrite it
  }
}

// The ordered sum of the LayerNorm partials, out[e] = the sum over p of
// P[p, e] for E = 2C columns (dscale, then dbias), in a fixed two-level
// order: thread (s, col) of a CTA's 32 columns adds the partials p = s, s +
// LNS_SPLIT, s + 2 LNS_SPLIT, ... in that order, LNS_LOADS loads in flight;
// then thread (0, col) adds the LNS_SPLIT sums in s order.  A CTA of 1024
// threads a 32 columns: at most 396 partials make 13 loads a thread, one
// round trip, where one thread a column waited for hundreds.
constexpr int LNS_SPLIT = 32, LNS_THREADS = 32 * LNS_SPLIT, LNS_LOADS = 16;

__global__ void __launch_bounds__(LNS_THREADS)
ln_sums_kernel(const float* __restrict__ P, int nparts, int E, float* __restrict__ out) {
  __shared__ float sub[LNS_SPLIT][32];
  const int col = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + col;
  float acc = 0.f;
  if (e < E) {
    for (int p0 = s; p0 < nparts; p0 += LNS_SPLIT * LNS_LOADS) {
      float v[LNS_LOADS];
#pragma unroll
      for (int u = 0; u < LNS_LOADS; ++u) {
        const int p = p0 + u * LNS_SPLIT;
        v[u] = p < nparts ? __ldg(P + (long long)p * E + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LNS_LOADS; ++u)
        if (p0 + u * LNS_SPLIT < nparts) acc += v[u];
    }
  }
  sub[s][col] = acc;
  __syncthreads();
  if (s == 0 && e < E) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < LNS_SPLIT; ++k) t += sub[k][col];
    out[e] = t;
  }
}

template <typename TG, typename TX, typename TO, int NCH>
cudaError_t ln_backward_n(const TG* G, const TX* X, const float* mean, const float* rstd,
                          const float* scale, const float* R, const float* mask, int L,
                          TO* DX, float* DXM, float* part, float* ds_db, long long M,
                          int C, cudaStream_t stream) {
  const long long rows = ln_rows(M, C), parts = n_chunks(M, rows);
  ln_bwd_kernel<TG, TX, TO, NCH><<<(unsigned)parts, LNB_THREADS, 0, stream>>>(
      G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C, rows);
  const cudaError_t err = counted(LAUNCH_LN_BWD, cudaGetLastError());
  if (err != cudaSuccess) return err;
  ln_sums_kernel<<<(unsigned)((2 * C + 31) / 32), LNS_THREADS, 0, stream>>>(
      part, (int)parts, 2 * C, ds_db);
  return counted(LAUNCH_LN_SUMS, cudaGetLastError());
}

// LayerNorm backward over all M (1 to 2^31 - 1) rows of C (a multiple of
// 8, at most 1024), then (dscale, dbias) into ds_db (2C adjacent floats)
// by the ordered second pass; part takes ln_parts(M, C) * 2C floats.
template <typename TG, typename TX, typename TO>
cudaError_t ln_backward(const TG* G, const TX* X, const float* mean, const float* rstd,
                        const float* scale, const float* R, const float* mask, int L,
                        TO* DX, float* DXM, float* part, float* ds_db, long long M,
                        int C, cudaStream_t stream) {
  if (M < 1 || M > 0x7fffffffLL || C < 8 || C % 8 || C > 1024) return cudaErrorInvalidValue;
#define LN_BACKWARD(NCH)                                                               \
  ln_backward_n<TG, TX, TO, NCH>(G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, \
                                 ds_db, M, C, stream)
  switch (lnb_chunks(C)) {
    case 1: return LN_BACKWARD(1);
    case 2: return LN_BACKWARD(2);
    case 3: return LN_BACKWARD(3);
    case 4: return LN_BACKWARD(4);
    case 6: return LN_BACKWARD(6);
    default: return LN_BACKWARD(8);
  }
#undef LN_BACKWARD
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
  RETURN_IF_ERROR(weight_grads(t.dm, s.gu, t.part, gr.wfc2, M, C, hid, st));
  // 4. dh2 = du Wfc1
  RETURN_IF_ERROR(data_grad<EPI_NONE>(t.du, hi[1], lo[1], none, t.dh2, M, C, hid, st));
  // 5. dWfc1 = du^T h2, dbfc1 = sum of du
  RETURN_IF_ERROR(weight_grads(t.du, s.h2, t.part, gr.wfc1, M, hid, C, st));
  // 6. LN2: dx1 = dx2 + LN2'(dh2), da = m1 * dx1; dn2s, dn2b
  RETURN_IF_ERROR((ln_backward<float, float, float>(t.dh2, s.x1, s.mean2, s.rstd2, p.n2s,
                                                    t.dx2, m1, L, t.dx1, t.da, t.part,
                                                    gr.n2s, M, C, st)));
  // 7. dO = da Wproj
  RETURN_IF_ERROR(data_grad<EPI_NONE>(t.da, hi[2], lo[2], none, t.dO, M, C, C, st));
  // 8. dWproj = da^T o, dbproj = sum of da
  RETURN_IF_ERROR(weight_grads(t.da, s.o, t.part, gr.wproj, M, C, C, st));
  // 9. attention backward -> dqkv, on the tensor cores
  RETURN_IF_ERROR(
      (cudaError_t)attention_bwd(s.qkv, t.dO, t.dqkv, stats, B, L, C, H, scale, st));
  // 10. dh1 = dqkv Wqkv
  RETURN_IF_ERROR(data_grad<EPI_NONE>(t.dqkv, hi[3], lo[3], none, t.dh1, M, C, 3 * C, st));
  // 11. dWqkv = dqkv^T h1, dbqkv = sum of dqkv
  RETURN_IF_ERROR(
      weight_grads(t.dqkv, s.h1, t.part, gr.wqkv, M, 3 * C, C, st));
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
// D^T X with db (N) = the column sums of D, into dwdb (dW, then db), summed
// in the backward's fixed order through part
// (pafuse_weight_grads_part_floats floats).
extern "C" int pafuse_data_grad(const float* A, const float* W, const float* aux, float* Y,
                                float* ws, long long M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)N * K;
  RETURN_IF_ERROR(sm90::split_weights_t(W, ws, ws + n, K, N, st));
  if (aux != nullptr)
    return (int)data_grad<EPI_GELU_GRAD>(A, ws, ws + n, aux, Y, M, N, K, st);
  return (int)data_grad<EPI_NONE>(A, ws, ws + n, nullptr, Y, M, N, K, st);
}

extern "C" long long pafuse_weight_grads_part_floats(long long M, int N, int K) {
  return wgrad::part_floats(M, N, K);
}

// The rows of a chunk of the weight-gradient partials for (M, N, K): the
// rule the CPU emulation of the tests follows.
extern "C" long long pafuse_weight_grads_chunk_rows(long long M, int N, int K) {
  return wgrad::chunk_rows(M, N, K);
}

extern "C" int pafuse_weight_grads(const float* D, const float* X, float* part, float* dwdb,
                                   long long M, int N, int K, void* stream) {
  return (int)weight_grads(D, X, part, dwdb, M, N, K, static_cast<cudaStream_t>(stream));
}

// The LayerNorm backward alone (for its tests and timings), in the dtypes
// of its three calls in train_bwd: G and X float32, or one of them (g_bf16
// or x_bf16, not both) bfloat16, DX in X's type; R (or NULL) and DXM (or
// NULL; then mask is not read) float32; part takes
// pafuse_ln_backward_part_floats floats, ds_db the 2C of (dscale, dbias).
// pafuse_ln_backward_rows: the rows of a CTA, the rule the CPU emulation of
// the tests follows.
extern "C" long long pafuse_ln_backward_rows(long long M, int C) { return ln_rows(M, C); }

extern "C" long long pafuse_ln_backward_part_floats(long long M, int C) {
  return ln_parts(M, C) * 2 * C;
}

extern "C" int pafuse_ln_backward(int g_bf16, int x_bf16, const void* G, const void* X,
                                  const float* mean, const float* rstd, const float* scale,
                                  const float* R, const float* mask, int L, void* DX,
                                  float* DXM, float* part, float* ds_db, long long M, int C,
                                  void* stream) {
  using B = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16 && x_bf16) return (int)cudaErrorInvalidValue;
  if (g_bf16)
    return (int)ln_backward<B, float, float>(static_cast<const B*>(G),
                                             static_cast<const float*>(X), mean, rstd, scale,
                                             R, mask, L, static_cast<float*>(DX), DXM, part,
                                             ds_db, M, C, st);
  if (x_bf16)
    return (int)ln_backward<float, B, B>(static_cast<const float*>(G), static_cast<const B*>(X),
                                         mean, rstd, scale, R, mask, L, static_cast<B*>(DX),
                                         DXM, part, ds_db, M, C, st);
  return (int)ln_backward<float, float, float>(static_cast<const float*>(G),
                                               static_cast<const float*>(X), mean, rstd, scale,
                                               R, mask, L, static_cast<float*>(DX), DXM, part,
                                               ds_db, M, C, st);
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
