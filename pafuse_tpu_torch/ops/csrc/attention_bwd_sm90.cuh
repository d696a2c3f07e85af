// The attention backward of the training block (kernel #6, step 9 of
// block_train.cu's train_bwd) on the tensor cores, in float32.  Built into
// one library only, attention_core_bwd.cu, whose pafuse_attention_core_bwd
// block_train.cu calls through its address and ops/attention_core.py calls
// alone.
//
// Replaces: the attention part of pafuse_tpu/ops/block_grad.py's
// _train_bwd_kernel (:203-226), which the port ran on a scalar kernel in
// block_train.cu (one CTA per (sequence, head), P and dS of the whole
// sequence in shared memory, which capped L at 135).  Per (sequence, head),
// with JAX's rounding points, all in f32:
//
//   P  = softmax(q k^T * d^-1/2)        recomputed from the saved qkv
//   dP = dO v^T
//   dS = P * (dP - rowsum(dP * P))
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dO
//
// qkv, dqkv: (seqs * L, 3C) with [q | k | v] blocks of C; dO: (seqs * L, C);
// contiguous sequences.
//
// What bounds it on an H100 (data-sheet peaks at 700 W): 10*B*L^2*C
// operations (five products) against 28*B*L*C bytes (qkv and dO read once,
// dqkv written once), L / 2.8 operations a byte: at the training shapes (L
// <= 68; 134 for the monolithic model) far below the ~165 / 3.35 a byte of
// float32 done as three TF32 products, so it is bound by the bytes.  The
// design, after attention_sm90.cuh's forward:
//   - a CTA of 4 warps (8 where its shared memory leaves an SM no room for
//     a second) takes U (sequence, head) units (U | H or H | U), copies their q,
//     k, v and dO rows with cp.async into four padded [token][DP + 4] tiles
//     a unit (a thread keeps one vector position of every few rows), and
//     zeroes the padding: columns d..DP and rows L..LP of every tile, so
//     padded keys and queries add exact zeros to every product;
//   - pass A: a warp takes a (unit, 16-query) tile.  S = Q K^T and dP = dO
//     V^T on mma.sync m16n8k8 as three TF32 products each (x_hi = tf32(x),
//     x_lo = tf32(x - x_hi); hi*lo + lo*hi summed apart and added to hi*hi
//     in one FADD), 16*NKT keys at a time: the row's max m, sum l and
//     t = sum e * dP gathered over the key chunks (rescaled by exp(m_old -
//     m_new) when the max grows), so the row term rowsum(dP * P) = t / l
//     needs no second pass; keys beyond L are masked to -inf.  Then dS =
//     (e / l)(dP - t / l), repacked in registers as the A operand of dS K
//     (the keys of an n8 tile taken as k columns t, t + 4), dq = scale *
//     dS K written from the fragments; with more than one chunk, S and dP
//     are computed again chunk by chunk.  The rows' m, 1 / l and t / l go
//     to shared memory;
//   - pass B: a warp takes a (unit, 16-key) tile, K's and V's rows split
//     into TF32 halves once in registers, and walks the query tiles in
//     order: S^T = K Q^T and dP^T = V dO^T (the same products as pass A),
//     P^T from the stored row statistics, dS^T, then dv += P^T dO and dk +=
//     dS^T Q (P^T and dS^T repacked as A operands as in pass A); dk =
//     scale * dk and dv are written from the fragments.
// No atomics and a fixed order of every sum: a call repeats bit for bit.
// Where one unit's four tiles do not fit a CTA's shared memory (float32: L
// above 256 at d <= 48, above 192 at d = 64) or d is above 64, the
// streamed kernel below takes it, in two passes over chunks that stream
// through shared memory; variant() is the rule.
//
// Everything launches on the caller's stream; nothing allocates.

#pragma once

#include "attention_sm90.cuh"

namespace {

namespace attn_bwd {

using attn_tc::copy_in;
using attn_tc::Group;
using attn_tc::mma_tf32;
using attn_tc::padded_dim;
using attn_tc::quad_max;
using attn_tc::quad_sum;
using attn_tc::row_stride;
using attn_tc::split;

// Threads a CTA: 4 warps, or 8 where one CTA's shared memory leaves room
// for no second one on an SM (one unit of L > ~110 tokens), so that the SM
// still holds the 8 warps its registers allow (~255 a thread).
constexpr int THREADS = 128, MAX_THREADS = 256;
// a CTA's shared memory: two CTAs an SM (their registers allow no more;
// 48, 160 and 227 KB measured slower, PERF.md)
constexpr int SMEM_TARGET = 96 * 1024;
constexpr int SMEM_MAX = attn_tc::SMEM_MAX;
constexpr int MAX_HEAD_DIM = attn_tc::MAX_HEAD_DIM;

// Key tiles (16 keys each) a chunk: all keys in one chunk up to 80, beyond
// that chunks of 48 or 64 keys, whichever pads L less.
__host__ __device__ constexpr int key_tiles(int L) {
  return L <= 32 ? 2
       : L <= 48 ? 3
       : L <= 80 ? 5
       : (L + 47) / 48 * 48 <= (L + 63) / 64 * 64 ? 3 : 4;
}

// Shared memory of one (sequence, head): q, k, v and dO tiles of LP rows (L
// rounded up to the key chunk) and the rows' three statistics; 0 when d is
// above MAX_HEAD_DIM.
inline long long unit_bytes(int L, int d) {
  if (d < 1 || d > MAX_HEAD_DIM || L < 1) return 0;
  const int kc = 16 * key_tiles(L);
  const long long lp = (long long)((L + kc - 1) / kc) * kc;
  return 4LL * (4LL * lp * row_stride(padded_dim(d), 4) + 3LL * lp);
}

// Copy a group's q, k, v (from qkv) and dO rows into its tiles, VB bytes a
// thread and step, as attn_tc::move_rows does for three parts.
template <int VB>
__device__ __forceinline__ void load_rows(const Group& u, const float* qkv, const float* dO,
                                          float* sm, int C, int d, int lp, int stride) {
  constexpr int EPV = VB / 4;
  const int vph = d / EPV, seg = u.HG * vph;      // vectors a head row, a part
  int wbits = 0;
  while ((1 << wbits) < seg) ++wbits;
  const int nt = blockDim.x;
  const bool wide = (1 << wbits) >= nt;
  const int first = wide ? 0 : threadIdx.x >> wbits, step = wide ? 1 : nt >> wbits;
  const long long col0 = (long long)u.h0 * d;
  for (int c = threadIdx.x & ((1 << wbits) - 1); c < seg; c += nt) {
    const int hl = c / vph, e = (c - hl * vph) * EPV;
    for (int rj = first; rj < u.G * u.L; rj += step) {
      const int sl = rj / u.L, l = rj - sl * u.L;
      const long long row = (u.s0 + sl) * u.L + l;
      float* tile = sm + ((long long)((sl * u.HG + hl) * 4) * lp + l) * stride + e;
      const float* src = qkv + row * 3 * C + col0 + hl * d + e;
#pragma unroll
      for (int part = 0; part < 3; ++part)
        copy_in<VB>(tile + (long long)part * lp * stride, src + part * C);
      copy_in<VB>(tile + 3LL * lp * stride, dO + row * C + col0 + hl * d + e);
    }
  }
}

__device__ __forceinline__ void load_rows(int vb, const Group& u, const float* qkv,
                                          const float* dO, float* sm, int C, int d, int lp,
                                          int stride) {
  switch (vb) {
    case 16: load_rows<16>(u, qkv, dO, sm, C, d, lp, stride); break;
    case 8: load_rows<8>(u, qkv, dO, sm, C, d, lp, stride); break;
    default: load_rows<4>(u, qkv, dO, sm, C, d, lp, stride); break;
  }
}

// Zeros the copies do not write in the 4n tiles of n units: columns d..DP
// of the first L rows, and all DP columns of rows L..LP.
template <int DP>
__device__ __forceinline__ void zero_pads(float* sm, int n, int L, int d, int lp) {
  constexpr int STRIDE = row_stride(DP, 4);
  if (d < DP)
    for (int i = threadIdx.x; i < n * 4 * L; i += blockDim.x) {
      const int tl = i / L, r = i - tl * L;
      float* row = sm + ((long long)tl * lp + r) * STRIDE;
      for (int c = d; c < DP; ++c) row[c] = 0.f;
    }
  constexpr int VPR = DP / 4;                     // 16-byte vectors a row
  const int pad = (lp - L) * VPR;
  for (int i = threadIdx.x; i < n * 4 * pad; i += blockDim.x) {
    const int tl = i / pad, r = i - tl * pad;
    reinterpret_cast<float4*>(sm + ((long long)tl * lp + L + r / VPR) * STRIDE)[r % VPR] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Store a 16-row fragment tile acc (n8 column tiles, rows g and g + 8 of
// each) times `scale` into rows row0.. (< L) of a head's d columns at out
// (row stride ld floats).
template <int KS>
__device__ __forceinline__ void store_rows(float* out, long long ld, const float (&acc)[KS][4],
                                           float scale, int row0, int L, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    float* o = out + (long long)row * ld;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int col = 8 * n + 2 * t;
      const float a = acc[n][2 * r] * scale, b = acc[n][2 * r + 1] * scale;
      if ((d & 1) == 0) {
        if (col < d) *reinterpret_cast<float2*>(o + col) = make_float2(a, b);
      } else {
        if (col < d) o[col] = a;
        if (col + 1 < d) o[col + 1] = b;
      }
    }
  }
}

// One 16 x 8 block of x y^T into acc (three TF32 products, the two small
// ones summed apart and added after the last): a_h, a_l the A fragments of
// x's 16 rows (KS k-steps), y the first of the block's 8 rows in shared
// memory (each row's dims 8 kk + t and 8 kk + t + 4 as the B fragment).
template <int KS, int STRIDE>
__device__ __forceinline__ void row_products(float (&acc)[4], const uint32_t (&a_h)[KS][4],
                                             const uint32_t (&a_l)[KS][4], const float* y) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* yr = y + g * STRIDE + 8 * kk + t;
    uint32_t bh0, bl0, bh1, bl1;
    split(yr[0], bh0, bl0);
    split(yr[4], bh1, bl1);
    mma_tf32(small, a_l[kk], bh0, bh1);
    mma_tf32(small, a_h[kk], bl0, bl1);
    mma_tf32(acc, a_h[kk], bh0, bh1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += small[e];
}

// acc (16 x DP fragments) += a z, a the 16 x 8 block of an accumulator
// fragment f (columns 2t, 2t + 1 taken as k columns t, t + 4), z the block's
// 8 rows in shared memory read in that order (rows 2t and 2t + 1 at z).
template <int KS, int STRIDE>
__device__ __forceinline__ void fragment_times_rows(float (&acc)[KS][4], const float (&f)[4],
                                                    const float* z) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  split(f[0], ah[0], al[0]);
  split(f[2], ah[1], al[1]);
  split(f[1], ah[2], al[2]);
  split(f[3], ah[3], al[3]);
  const float* zr = z + 2 * t * STRIDE + g;
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
    uint32_t bh0, bl0, bh1, bl1;
    split(zr[8 * nd], bh0, bl0);
    split(zr[8 * nd + STRIDE], bh1, bl1);
    mma_tf32(acc[nd], al, bh0, bh1);
    mma_tf32(acc[nd], ah, bl0, bl1);
    mma_tf32(acc[nd], ah, bh0, bh1);
  }
}

// The A fragments (hi, lo) of a tile's 16 rows: (row g, col t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) of each 8-column step.
template <int KS, int STRIDE>
__device__ __forceinline__ void a_fragments(uint32_t (&h)[KS][4], uint32_t (&l)[KS][4],
                                            const float* x) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split(x[(g + 8 * (i & 1)) * STRIDE + 8 * kk + t + 4 * (i >> 1)], h[kk][i], l[kk][i]);
}

// Pass A: one warp's (unit, 16-query) tile.  q, g: the tile's first rows of
// Q and dO; k, v: the unit's K and V tiles; st: the unit's statistics (m,
// 1 / l, row term; LP each) from the tile's first row; dq: global row 0 of
// the head's q columns in dqkv.
template <int DP, int NKT>
__device__ __forceinline__ void query_tile(const float* q, const float* g, const float* k,
                                           const float* v, float* st, int lp, float* dq,
                                           long long ld, int row0, int L, int d, int nc,
                                           float scale) {
  constexpr int STRIDE = row_stride(DP, 4), KC = 16 * NKT, KS = DP / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  uint32_t qh[KS][4], ql[KS][4], gh[KS][4], gl[KS][4];
  a_fragments<KS, STRIDE>(qh, ql, q);
  a_fragments<KS, STRIDE>(gh, gl, g);

  float s[NKT][2][4], dp[NKT][2][4];       // logits then e, and dP: key tile, n8 half
  auto products = [&](int c) {
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int key0 = c * KC + 16 * j + 8 * n;
        row_products<KS, STRIDE>(s[j][n], qh, ql, k + key0 * STRIDE);
        row_products<KS, STRIDE>(dp[j][n], gh, gl, v + key0 * STRIDE);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][n][e] = key0 + 2 * t + (e & 1) < L ? s[j][n][e] * scale : -INFINITY;
      }
  };

  // the row's max, sum of e and sum of e * dP over the chunks (rows gr, gr + 8)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, tot[2] = {0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    products(c);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(cm[r]));
      const float alpha = expf(mx[r] - m);     // 0 on the first chunk
      sum[r] *= alpha;
      tot[r] *= alpha;
      mx[r] = m;
    }
    float cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
          cs[e >> 1] += s[j][n][e];
          ct[e >> 1] += s[j][n][e] * dp[j][n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += quad_sum(cs[r]);
      tot[r] += quad_sum(ct[r]);
    }
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  const float rt[2] = {tot[0] * inv[0], tot[1] * inv[1]};
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st[gr + 8 * r] = mx[r];
      st[lp + gr + 8 * r] = inv[r];
      st[2 * lp + gr + 8 * r] = rt[r];
    }

  // dq = scale * dS K
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    if (nc > 1) {
      products(c);
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = (s[j][n][e] * inv[e >> 1]) * (dp[j][n][e] - rt[e >> 1]);
        fragment_times_rows<KS, STRIDE>(acc, ds, k + (c * KC + 16 * j + 8 * n) * STRIDE);
      }
  }
  store_rows<KS>(dq, ld, acc, scale, row0, L, d);
}

// Pass B: one warp's (unit, 16-key) tile.  k, v: the tile's first rows of
// K and V; q, g: the unit's Q and dO tiles; st: the unit's statistics;
// dk: global row 0 of the head's k columns in dqkv (v's C further on).
template <int DP>
__device__ __forceinline__ void key_tile(const float* k, const float* v, const float* q,
                                         const float* g, const float* st, int lp, float* dk,
                                         long long ld, int C, int row0, int L, int d,
                                         float scale) {
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8;
  const int lane = threadIdx.x & 31, t = lane & 3;
  uint32_t kh[KS][4], kl[KS][4], vh[KS][4], vl[KS][4];
  a_fragments<KS, STRIDE>(kh, kl, k);
  a_fragments<KS, STRIDE>(vh, vl, v);
  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int qbs = (L + 15) / 16;
  for (int qb = 0; qb < qbs; ++qb) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int q0 = 16 * qb + 8 * n;
      float s[4], dp[4], p[4], ds[4];
      row_products<KS, STRIDE>(s, kh, kl, q + q0 * STRIDE);
      row_products<KS, STRIDE>(dp, vh, vl, g + q0 * STRIDE);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = q0 + 2 * t + (e & 1);
        p[e] = query < L ? expf(s[e] * scale - st[query]) * st[lp + query] : 0.f;
        ds[e] = p[e] * (dp[e] - st[2 * lp + query]);
      }
      fragment_times_rows<KS, STRIDE>(dva, p, g + q0 * STRIDE);
      fragment_times_rows<KS, STRIDE>(dka, ds, q + q0 * STRIDE);
    }
  }
  store_rows<KS>(dk, ld, dka, scale, row0, L, d);
  store_rows<KS>(dk + C, ld, dva, 1.f, row0, L, d);
}

// One CTA: the group of U units from unit blockIdx.x * U on.  nc key chunks
// of 16 * NKT keys; vb the copy width in bytes.
template <int DP, int NKT>
__global__ void __launch_bounds__(MAX_THREADS)
attention_bwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                        float* __restrict__ dqkv, long long seqs, int L, int C, int H, int d,
                        float scale, int U, int nc, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  constexpr int STRIDE = row_stride(DP, 4);
  const int lp = nc * 16 * NKT, tiles = (L + 15) / 16;
  const Group u((long long)blockIdx.x * U, U, seqs * H, H, L, 1);
  const int n = u.G * u.HG;
  const long long tile = (long long)lp * STRIDE;
  float* stats = sm + (long long)U * 4 * tile;

  load_rows(vb, u, qkv, dO, sm, C, d, lp, STRIDE);
  zero_pads<DP>(sm, n, L, d, lp);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // a unit's first row in dqkv: its sequence's token 0, its head's q columns
  auto out_of = [&](int ul) {
    const int sl = ul / u.HG, hl = ul - sl * u.HG;
    return dqkv + (u.s0 + sl) * L * 3LL * C + (long long)(u.h0 + hl) * d;
  };
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int w = warp; w < n * tiles; w += warps) {
    const int ul = w / tiles, qb = w - ul * tiles;
    const float* ut = sm + (long long)ul * 4 * tile;
    query_tile<DP, NKT>(ut + qb * 16 * STRIDE, ut + 3 * tile + qb * 16 * STRIDE, ut + tile,
                        ut + 2 * tile, stats + (long long)ul * 3 * lp + qb * 16, lp, out_of(ul),
                        3LL * C, 16 * qb, L, d, nc, scale);
  }
  __syncthreads();
  for (int w = warp; w < n * tiles; w += warps) {
    const int ul = w / tiles, kb = w - ul * tiles;
    const float* ut = sm + (long long)ul * 4 * tile;
    key_tile<DP>(ut + tile + kb * 16 * STRIDE, ut + 2 * tile + kb * 16 * STRIDE, ut,
                 ut + 3 * tile, stats + (long long)ul * 3 * lp, lp, out_of(ul) + C, 3LL * C, C,
                 16 * kb, L, d, scale);
  }
}

template <int DP, int NKT>
cudaError_t launch(const float* qkv, const float* dO, float* dqkv, long long seqs, int L, int C,
                   int H, int d, float scale, int U, int nc, int vb, size_t smem,
                   cudaStream_t stream) {
  const auto kernel = attention_bwd_tc_kernel<DP, NKT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long grid = (seqs * H + U - 1) / U;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = 2 * smem > (size_t)SMEM_MAX ? MAX_THREADS : THREADS;
  kernel<<<(unsigned)grid, threads, smem, stream>>>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U,
                                                    nc, vb);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dp(int nkt, const float* qkv, const float* dO, float* dqkv, long long seqs,
                      int L, int C, int H, int d, float scale, int U, int nc, int vb,
                      size_t smem, cudaStream_t stream) {
  switch (nkt) {
    case 2: return launch<DP, 2>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb, smem, stream);
    case 3: return launch<DP, 3>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb, smem, stream);
    case 4: return launch<DP, 4>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb, smem, stream);
    default:
      return launch<DP, 5>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb, smem, stream);
  }
}

// ---------------------------------------------------------------------------
// The streamed backward, for the units the resident kernel above does not
// take (d above 64, up to attn_tc::MAX_STREAM_DIM, or one unit's q, k, v
// and dO beyond a CTA's shared memory).  Two launches, each CTA
// STREAM_WARPS 16-row tiles of one (sequence, head), one a warp, d padded
// to 64 or 128:
//   - pass A, per query tile: Q's and dO's A fragments split once into
//     TF32 halves in shared memory (fragment order: one 16-byte read a
//     lane, a k-step and a half); K and V stream through a two-stage
//     cp.async ring in chunks of STREAM_KC keys, twice: the row's max, sum
//     and sum of e * dP over the chunks (rescaled as the resident pass A
//     rescales), then dS and dq = scale * dS K.  Each row's m, 1 / l and
//     t / l go to the caller's scratch in global memory (3 L floats a unit);
//   - pass B, per key tile: K's and V's halves split once into shared
//     memory the same way; Q, dO and the rows' statistics stream through the
//     ring in chunks of STREAM_KC queries, walked in order as the resident
//     pass B walks its query tiles (a tile wholly past L skipped as there),
//     so dk and dv sum in the same fixed order.
// The statistics go through global memory, not shared, because the two
// passes cut a unit differently (query tiles, key tiles) and so run as two
// launches; at 3 floats a row they are a 1/40 of the unit's bytes at d =
// 64.  Chunks of 32 keys (the resident kernel's are 32-80) keep the ring
// and four warps' halves within ~100 KB at d <= 64 (two CTAs an SM) and
// ~200 KB at d = 128.  The products are the resident kernel's (row_products,
// fragment_times_rows), with the A fragments read from shared memory.
// No atomics: a call repeats bit for bit.
// ---------------------------------------------------------------------------

constexpr int STREAM_WARPS = THREADS / 32;
constexpr int STREAM_KC = 32;

using attn_tc::stream_dim;
using attn_tc::stream_rows;
using attn_tc::zero_smem;

// 1: the resident kernel takes (L, d); 2: the streamed one; 0: neither.
inline int variant(int L, int d) {
  if (L < 1 || d < 1 || d > attn_tc::MAX_STREAM_DIM) return 0;
  const long long ub = unit_bytes(L, d);
  return ub != 0 && ub <= SMEM_MAX ? 1 : 2;
}

// Floats of one ring stage (pass A: a K and a V chunk; pass B: a Q and a
// dO chunk and their rows' three statistics) and bytes of a CTA's shared
// memory (two stages, and each warp's two 16-row tiles in TF32 halves).
__host__ __device__ constexpr int stream_stage(int dp, bool b) {
  return 2 * STREAM_KC * row_stride(dp, 4) + (b ? 3 * STREAM_KC : 0);
}
__host__ __device__ constexpr int stream_smem(int dp, bool b) {
  return 2 * stream_stage(dp, b) * 4 + STREAM_WARPS * 2 * (dp / 8) * 2 * 32 * 16;
}

// A 16-row tile's A fragments (rows row0.. of x, row stride ld; zeros past
// L and d) split into TF32 halves, into f: [k-step][hi, lo][lane].
template <int KS>
__device__ __forceinline__ void split_rows(uint4* f, const float* x, long long ld, int row0,
                                           int L, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      split(row < L && col < d ? x[(long long)row * ld + col] : 0.f, h[i], l[i]);
    }
    f[2 * kk * 32 + lane] = make_uint4(h[0], h[1], h[2], h[3]);
    f[(2 * kk + 1) * 32 + lane] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// row_products with x's fragments read from shared memory (split_rows).
template <int KS, int STRIDE>
__device__ __forceinline__ void row_products(float (&acc)[4], const uint4* f, const float* y) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint4 h = f[2 * kk * 32 + lane], l = f[(2 * kk + 1) * 32 + lane];
    const uint32_t a_h[4] = {h.x, h.y, h.z, h.w}, a_l[4] = {l.x, l.y, l.z, l.w};
    const float* yr = y + g * STRIDE + 8 * kk + t;
    uint32_t bh0, bl0, bh1, bl1;
    split(yr[0], bh0, bl0);
    split(yr[4], bh1, bl1);
    mma_tf32(small, a_l, bh0, bh1);
    mma_tf32(small, a_h, bl0, bl1);
    mma_tf32(acc, a_h, bh0, bh1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += small[e];
}

// Pass A.  One CTA: query tiles (blockIdx.x % blocks) * STREAM_WARPS.. of
// unit blockIdx.x / blocks; stats: 3 L floats a unit (m, 1 / l, t / l).
template <int DP>
__global__ void __launch_bounds__(THREADS)
attention_bwd_stream_a_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                              float* __restrict__ dqkv, float* __restrict__ stats, int L, int C,
                              int H, int d, float scale, int blocks, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8, NKT = STREAM_KC / 16;
  constexpr int STAGE = stream_stage(DP, false);
  float* ring = reinterpret_cast<float*>(smem_raw);
  const long long unit = blockIdx.x / blocks, seq = unit / H;
  const int blk = (int)(blockIdx.x - unit * blocks), h = (int)(unit - seq * H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int q0 = (blk * STREAM_WARPS + warp) * 16;
  const int C3 = 3 * C, nc = (L + STREAM_KC - 1) / STREAM_KC;
  const float* src = qkv + seq * L * C3 + (long long)h * d;    // the unit's q at token 0
  uint4* qf = reinterpret_cast<uint4*>(ring + 2 * STAGE) + warp * 2 * KS * 64;
  uint4* gf = qf + KS * 64;

  zero_smem(smem_raw, 2 * STAGE * 4 / 16);
  __syncthreads();
  // step i < nc: chunk i of K and V for the statistics; step nc + i: again
  // for dq
  auto issue = [&](int step) {
    const int k0 = (step < nc ? step : step - nc) * STREAM_KC;
    const int rows = L - k0 < STREAM_KC ? L - k0 : STREAM_KC;
    float* stage = ring + (step & 1) * STAGE;
    stream_rows(vb, stage, src + C, 0, 1, C3, k0, rows, d, STRIDE);
    stream_rows(vb, stage + STREAM_KC * STRIDE, src + 2 * C, 0, 1, C3, k0, rows, d, STRIDE);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);
  split_rows<KS>(qf, src, C3, q0, L, d);
  split_rows<KS>(gf, dO + seq * L * C + (long long)h * d, C, q0, L, d);
  __syncwarp();

  float s[NKT][2][4], dp[NKT][2][4];
  auto products = [&](const float* k, const float* v, int k0) {
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int key0 = 16 * j + 8 * n;
        row_products<KS, STRIDE>(s[j][n], qf, k + key0 * STRIDE);
        row_products<KS, STRIDE>(dp[j][n], gf, v + key0 * STRIDE);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][n][e] = k0 + key0 + 2 * t + (e & 1) < L ? s[j][n][e] * scale : -INFINITY;
      }
  };
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, tot[2] = {0.f, 0.f};
  float inv[2], rt[2], acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int step = 0; step < 2 * nc; ++step) {
    if (step + 1 < 2 * nc) {
      issue(step + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const float* k = ring + (step & 1) * STAGE;
    const float* v = k + STREAM_KC * STRIDE;
    if (q0 < L && step < nc) {
      products(k, v, step * STREAM_KC);
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(mx[r], quad_max(cm[r]));
        const float alpha = expf(mx[r] - m);     // 0 on the first chunk
        sum[r] *= alpha;
        tot[r] *= alpha;
        mx[r] = m;
      }
      float cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
            cs[e >> 1] += s[j][n][e];
            ct[e >> 1] += s[j][n][e] * dp[j][n][e];
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += quad_sum(cs[r]);
        tot[r] += quad_sum(ct[r]);
      }
    } else if (q0 < L) {
      if (step == nc) {
        float* st = stats + unit * 3 * L;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv[r] = 1.f / sum[r];
          rt[r] = tot[r] * inv[r];
          const int row = q0 + gr + 8 * r;
          if (t == 0 && row < L) {
            st[row] = mx[r];
            st[L + row] = inv[r];
            st[2 * L + row] = rt[r];
          }
        }
      }
      products(k, v, (step - nc) * STREAM_KC);
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = (expf(s[j][n][e] - mx[e >> 1]) * inv[e >> 1]) * (dp[j][n][e] - rt[e >> 1]);
          fragment_times_rows<KS, STRIDE>(acc, ds, k + (16 * j + 8 * n) * STRIDE);
        }
    }
    __syncthreads();       // every warp is done with this stage before it refills
  }
  if (q0 < L) store_rows<KS>(dqkv + seq * L * C3 + (long long)h * d, C3, acc, scale, q0, L, d);
}

// Pass B.  One CTA: key tiles (blockIdx.x % blocks) * STREAM_WARPS.. of
// unit blockIdx.x / blocks, with pass A's statistics.
template <int DP>
__global__ void __launch_bounds__(THREADS)
attention_bwd_stream_b_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                              const float* __restrict__ stats, float* __restrict__ dqkv, int L,
                              int C, int H, int d, float scale, int blocks, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8;
  constexpr int STAGE = stream_stage(DP, true);
  float* ring = reinterpret_cast<float*>(smem_raw);
  const long long unit = blockIdx.x / blocks, seq = unit / H;
  const int blk = (int)(blockIdx.x - unit * blocks), h = (int)(unit - seq * H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int k0 = (blk * STREAM_WARPS + warp) * 16;
  const int C3 = 3 * C, nc = (L + STREAM_KC - 1) / STREAM_KC;
  const float* src = qkv + seq * L * C3 + (long long)h * d;
  const float* gsrc = dO + seq * L * C + (long long)h * d;
  const float* st = stats + unit * 3 * L;
  uint4* kf = reinterpret_cast<uint4*>(ring + 2 * STAGE) + warp * 2 * KS * 64;
  uint4* vf = kf + KS * 64;

  zero_smem(smem_raw, 2 * STAGE * 4 / 16);
  __syncthreads();
  // step c: chunk c of Q, dO and the statistics
  auto issue = [&](int c) {
    const int r0 = c * STREAM_KC, rows = L - r0 < STREAM_KC ? L - r0 : STREAM_KC;
    float* stage = ring + (c & 1) * STAGE;
    stream_rows(vb, stage, src, 0, 1, C3, r0, rows, d, STRIDE);
    stream_rows(vb, stage + STREAM_KC * STRIDE, gsrc, 0, 1, C, r0, rows, d, STRIDE);
    float* sst = stage + 2 * STREAM_KC * STRIDE;
    for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x) {
      const int part = i / rows, r = i - part * rows;
      copy_in<4>(sst + part * STREAM_KC + r, st + part * L + r0 + r);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);
  split_rows<KS>(kf, src + C, C3, k0, L, d);
  split_rows<KS>(vf, src + 2 * C, C3, k0, L, d);
  __syncwarp();

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      issue(c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const float* q = ring + (c & 1) * STAGE;
    const float* g = q + STREAM_KC * STRIDE;
    const float* sm = g + STREAM_KC * STRIDE;          // m, 1 / l, t / l
    if (k0 < L)
#pragma unroll
      for (int qt = 0; qt < STREAM_KC / 16; ++qt) {
        if (c * STREAM_KC + 16 * qt >= L) break;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int q0 = 16 * qt + 8 * n;
          float s[4], dp[4], p[4], ds[4];
          row_products<KS, STRIDE>(s, kf, q + q0 * STRIDE);
          row_products<KS, STRIDE>(dp, vf, g + q0 * STRIDE);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = q0 + 2 * t + (e & 1);
            p[e] = c * STREAM_KC + r < L ? expf(s[e] * scale - sm[r]) * sm[STREAM_KC + r] : 0.f;
            ds[e] = p[e] * (dp[e] - sm[2 * STREAM_KC + r]);
          }
          fragment_times_rows<KS, STRIDE>(dva, p, g + q0 * STRIDE);
          fragment_times_rows<KS, STRIDE>(dka, ds, q + q0 * STRIDE);
        }
      }
    __syncthreads();
  }
  if (k0 < L) {
    float* dk = dqkv + seq * L * C3 + C + (long long)h * d;
    store_rows<KS>(dk, C3, dka, scale, k0, L, d);
    store_rows<KS>(dk + C, C3, dva, 1.f, k0, L, d);
  }
}

// Launches of attention_bwd_stream_a_kernel (pass A) and _b_kernel (pass
// B) in this library, counted on the host where they happen
// (pafuse_attention_core_bwd_stream_launches reads them).
std::atomic<long long> stream_a_launches{0}, stream_b_launches{0};

template <int DP>
cudaError_t launch_stream(const float* qkv, const float* dO, float* dqkv, float* stats,
                          long long seqs, int L, int C, int H, int d, float scale, int vb,
                          cudaStream_t stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  const auto ka = attention_bwd_stream_a_kernel<DP>;
  const auto kb = attention_bwd_stream_b_kernel<DP>;
  constexpr int smem_a = stream_smem(DP, false), smem_b = stream_smem(DP, true);
  cudaError_t err;
  if (smem_a > 48 * 1024 && (err = cudaFuncSetAttribute(
                                 ka, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a)) !=
                                cudaSuccess)
    return err;
  if (smem_b > 48 * 1024 && (err = cudaFuncSetAttribute(
                                 kb, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b)) !=
                                cudaSuccess)
    return err;
  const int blocks = ((L + 15) / 16 + STREAM_WARPS - 1) / STREAM_WARPS;
  const long long grid = seqs * H * blocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ka<<<(unsigned)grid, THREADS, smem_a, stream>>>(qkv, dO, dqkv, stats, L, C, H, d, scale,
                                                   blocks, vb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  stream_a_launches.fetch_add(1, std::memory_order_relaxed);
  kb<<<(unsigned)grid, THREADS, smem_b, stream>>>(qkv, dO, stats, dqkv, L, C, H, d, scale,
                                                   blocks, vb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  stream_b_launches.fetch_add(1, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace attn_bwd

// seqs contiguous sequences of L tokens: the resident kernel where it
// takes (L, d = C / H), else the streamed one, which keeps the rows'
// statistics in stats (3 * seqs * H * L floats; the resident kernel takes
// NULL); cudaErrorInvalidValue for a shape neither takes (d above
// attn_tc::MAX_STREAM_DIM), or for a streamed shape without stats.
inline cudaError_t launch_attention_bwd_tc(const float* qkv, const float* dO, float* dqkv,
                                           float* stats, long long seqs, int L, int C, int H,
                                           float scale, cudaStream_t stream) {
  using namespace attn_bwd;
  if (seqs == 0) return cudaSuccess;
  if (seqs < 0 || H < 1 || C % H) return cudaErrorInvalidValue;
  const int d = C / H;
  const int route = variant(L, d);
  if (route == 0) return cudaErrorInvalidValue;
  // the copy width: the largest of 16, 8, 4 bytes that divides a head row,
  // the row strides and both input pointers
  const unsigned long long bits = (unsigned long long)(d * 4) | (unsigned long long)(C * 4) |
                                  reinterpret_cast<uintptr_t>(qkv) |
                                  reinterpret_cast<uintptr_t>(dO);
  const unsigned long long low = bits & (~bits + 1);
  const int vb = (int)(low < 16 ? low : 16);
  if (route == 2)
    return stream_dim(d) == 64
               ? launch_stream<64>(qkv, dO, dqkv, stats, seqs, L, C, H, d, scale, vb, stream)
               : launch_stream<128>(qkv, dO, dqkv, stats, seqs, L, C, H, d, scale, vb, stream);
  const long long ub = unit_bytes(L, d);
  // U: the most units (U | H or H | U) in SMEM_TARGET
  int U = 1;
  for (int u = 2; u * ub <= SMEM_TARGET; ++u)
    if (H % u == 0 || u % H == 0) U = u;
  const int nkt = key_tiles(L), kc = 16 * nkt, nc = (L + kc - 1) / kc;
  const size_t smem = (size_t)(U * ub);
  const int dp = padded_dim(d);
  return dp == 32   ? launch_dp<32>(nkt, qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb,
                                    smem, stream)
         : dp == 48 ? launch_dp<48>(nkt, qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb,
                                    smem, stream)
                    : launch_dp<64>(nkt, qkv, dO, dqkv, seqs, L, C, H, d, scale, U, nc, vb,
                                    smem, stream);
}

}  // namespace
