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
//     in one FADD) over the unit's 16*NKT keys (up to 80, one chunk): the
//     row's max m, sum l and t = sum e * dP, so the row term rowsum(dP *
//     P) = t / l needs no second pass; keys beyond L are masked to -inf.
//     Then dS = (e / l)(dP - t / l), repacked in registers as the A operand
//     of dS K (the keys of an n8 tile taken as k columns t, t + 4), dq =
//     scale * dS K written from the fragments.  The rows' m, 1 / l and t / l
//     go to shared memory;
//   - pass B: a warp takes a (unit, 16-key) tile, K's and V's rows split
//     into TF32 halves once in registers, and walks the query tiles in
//     order: S^T = K Q^T and dP^T = V dO^T (the same products as pass A),
//     P^T from the stored row statistics, dS^T, then dv += P^T dO and dk +=
//     dS^T Q (P^T and dS^T repacked as A operands as in pass A); dk =
//     scale * dk and dv are written from the fragments.
// That kernel (attention_bwd_tc_kernel, mma.sync) takes units of up to 80
// keys (one key chunk).  Past 80 keys at d <= 48 (the monolithic model's
// 134 joints at d = 36) the wgmma kernel (attention_bwd_wg_kernel) takes
// the unit where its rows fit a CTA (there the mma.sync kernel computed S
// and dP in three chunks a query tile, at 6% of its bound):
//   - a CTA is one unit and two warpgroups; the unit's q, k, v and dO rows
//     are copied once (cp.async, 16 bytes where aligned) into shared memory
//     as they are, and every operand is split into TF32 hi and lo from
//     there, once a product, into K-major tiles wgmma reads (a rows set:
//     64 rows by d; a cols set: 64 rows transposed) that both warpgroups
//     share; A operands are register fragments split from the raw rows;
//   - pass A, a 64-query block a warpgroup: over the unit's 64-key chunks
//     the rows' max m, sum l and t = sum e * dP (rescaled as the max
//     grows), then S and dP again with dq += dS K; pass B, a 64-key block a
//     warpgroup: S^T, dP^T, P^T and dS^T from the statistics, dv += P^T dO,
//     dk += dS^T Q.  So S and dP are computed three times (pass A twice,
//     pass B once): the statistics need a whole row before any dS, and a
//     warpgroup's registers hold one 64-key chunk of S and dP (all of a
//     134-token row would take 2 x 68 more a thread);
//   - each B set is filled while the other's products run (two sets);
//     S, dP, S^T and dP^T are three TF32 products a k-step (lo*hi and hi*lo
//     summed apart, added to hi*hi in one FADD), over d rounded up to 8
//     (5 k-steps at d = 36), dq, dk and dv three a k-step into a fresh
//     accumulator a 64-row chunk, added in f32 in order;
//   - e = 2^((s - m) log2 e) on ex2.approx (MUFU) instead of expf.
// Its bound at the monolithic (999, 134, 288): 0.32 ms of bytes; it runs
// there at 4.58 ms on an H100 80GB HBM3 at 700 W, the mma.sync kernel at
// 5.22; at 243 frames, d = 28 and 32, 0.40 ms against 0.53 (chip_ab.py,
// PERF.md).  At every shape up to 80 keys it measured 1.7-5.1x slower than
// the mma.sync kernel (chip_ab.py's "wg" tree), and at d = 49..64 slower
// than the streamed kernels, which keep those shapes (variant()).
// A third design, attention_bwd_pack_kernel, takes units of up to 64 keys
// at d <= 48 the way the wgmma kernel takes a 64-row block: one warpgroup
// a CTA and 64 // (L rounded up to 8) units packed into its rows (each
// unit's keys meet the k-steps of 8 as alone, so a unit's bits do not
// depend on its slot), a product across two units masked to -inf, the
// four operands copied once and split into K-major sets from there, S and
// dP once (a row's whole softmax in registers), two or three CTAs an SM.
// It measured 1.1-2.3x slower than the mma.sync kernel at H3WB's, 3DHP's
// and the monolithic 27-frame shapes (each CTA's copies, splits, barriers
// and softmax run between its products, and two or three CTAs an SM do
// not hide them as the mma.sync kernel's 8 independent warps do), so no
// shape routes to it (PACK_SHORT_UNITS; chip_ab.py's "pack" tree times it).
// No atomics and a fixed order of every sum: a call repeats bit for bit.
// Past one key chunk where the wgmma kernel does not take the unit (d <= 48
// past its shared memory: 243 frames at d = 36 and 48, faster there than
// the mma.sync kernel's chunks were; d = 49..64) and at d above 64, the
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

// Key tiles (16 keys each) of a unit of up to 80 keys, all in one chunk.
__host__ __device__ constexpr int key_tiles(int L) { return L <= 32 ? 2 : L <= 48 ? 3 : 5; }

// Shared memory of one (sequence, head) of up to 80 keys: q, k, v and dO
// tiles of LP rows (L rounded up to the key chunk) and the rows' three
// statistics.
inline long long unit_bytes(int L, int d) {
  const long long lp = 16 * key_tiles(L);
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
// Q and dO; k, v: the unit's K and V tiles (its NKT key tiles, one chunk);
// st: the unit's statistics (m, 1 / l, row term; LP each) from the tile's
// first row; dq: global row 0 of the head's q columns in dqkv.
template <int DP, int NKT>
__device__ __forceinline__ void query_tile(const float* q, const float* g, const float* k,
                                           const float* v, float* st, int lp, float* dq,
                                           long long ld, int row0, int L, int d, float scale) {
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  uint32_t qh[KS][4], ql[KS][4], gh[KS][4], gl[KS][4];
  a_fragments<KS, STRIDE>(qh, ql, q);
  a_fragments<KS, STRIDE>(gh, gl, g);

  float s[NKT][2][4], dp[NKT][2][4];       // logits then e, and dP: key tile, n8 half
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int key0 = 16 * j + 8 * n;
      row_products<KS, STRIDE>(s[j][n], qh, ql, k + key0 * STRIDE);
      row_products<KS, STRIDE>(dp[j][n], gh, gl, v + key0 * STRIDE);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][n][e] = key0 + 2 * t + (e & 1) < L ? s[j][n][e] * scale : -INFINITY;
    }

  // the row's max, sum of e and sum of e * dP (rows gr, gr + 8)
  float mx[2] = {-INFINITY, -INFINITY}, cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][n][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
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
  const float inv[2] = {1.f / quad_sum(cs[0]), 1.f / quad_sum(cs[1])};
  const float rt[2] = {quad_sum(ct[0]) * inv[0], quad_sum(ct[1]) * inv[1]};
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
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = (s[j][n][e] * inv[e >> 1]) * (dp[j][n][e] - rt[e >> 1]);
      fragment_times_rows<KS, STRIDE>(acc, ds, k + (16 * j + 8 * n) * STRIDE);
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

// One CTA: the group of U units from unit blockIdx.x * U on, each in one key
// chunk of 16 * NKT keys; vb the copy width in bytes.
template <int DP, int NKT>
__global__ void __launch_bounds__(MAX_THREADS)
attention_bwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                        float* __restrict__ dqkv, long long seqs, int L, int C, int H, int d,
                        float scale, int U, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  constexpr int STRIDE = row_stride(DP, 4);
  const int lp = 16 * NKT, tiles = (L + 15) / 16;
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
                        3LL * C, 16 * qb, L, d, scale);
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
                   int H, int d, float scale, int U, int vb, size_t smem, cudaStream_t stream) {
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
                                                    vb);
  return counted(LAUNCH_ATTENTION_BWD_TC, cudaGetLastError());
}

template <int DP>
cudaError_t launch_dp(int nkt, const float* qkv, const float* dO, float* dqkv, long long seqs,
                      int L, int C, int H, int d, float scale, int U, int vb, size_t smem,
                      cudaStream_t stream) {
  switch (nkt) {
    case 2: return launch<DP, 2>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, vb, smem, stream);
    case 3: return launch<DP, 3>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, vb, smem, stream);
    default: return launch<DP, 5>(qkv, dO, dqkv, seqs, L, C, H, d, scale, U, vb, smem, stream);
  }
}

// ---------------------------------------------------------------------------
// The resident backward on wgmma, for units of 81-256 tokens at d <= 48
// whose raw rows fit one CTA (see the note at the top)
// ---------------------------------------------------------------------------

using attn_tc::acc_fragment;
using attn_tc::async_proxy_fence;
using attn_tc::chunk_fragments;
using attn_tc::cols_from;
using attn_tc::half_fragments;
using attn_tc::reg_products;
using attn_tc::rows_from;
using attn_tc::set_ready;
using attn_tc::set_times;
using attn_tc::store_set;
using attn_tc::wg_ksteps;
using attn_tc::wg_wait0;
using attn_tc::WG_ROWS;
using attn_tc::WgSet;

// the most rows of a unit: L up to 256, four 64-row blocks
constexpr int MAX_ROWS = 256;
// the longest unit the mma.sync kernel takes in one key chunk (key_tiles 5)
constexpr int ONE_CHUNK = 80;

// A CTA is one (sequence, head) unit: two warpgroups share the unit's raw
// rows (the last block's only as many as it holds, rounded up to 8) and two
// sets the B operands take in turn, each filled once for both while the
// other's products run; in pass A warpgroup w takes query blocks w, w + 2,
// ..., in pass B key blocks w, w + 2, ... (a warpgroup without a block of
// its own computes on the last block's rows and stores nothing: a branch
// around its wgmmas would serialise them).
template <int KS> struct BwdWg {
  static constexpr int RW = attn_tc::RawChunk<KS>::RW;
  // two B sets, the rows' statistics and 1 KB to align the tiles
  static constexpr int FIXED = 2 * WgSet<KS>::BIG + 3 * MAX_ROWS * 4 + 1024;
  __host__ __device__ static constexpr int last_rows(int L) {
    return (L - WG_ROWS * ((L - 1) / WG_ROWS) + 7) / 8 * 8;
  }
  __host__ __device__ static constexpr int smem(int L) {
    return 4 * (((L - 1) / WG_ROWS) * WG_ROWS + last_rows(L)) * RW * 4 + FIXED;
  }
};

// e^x as 2^(x log2 e) on the MUFU (ex2.approx: ~2 ulp, 0 at -inf; the
// product's rounding adds ~|x| 2^-24 relative)
__device__ __forceinline__ float exp_mufu(float x) { return attn_tc::ex2(x * 1.4426950408889634f); }

template <int KS>
__global__ void __launch_bounds__(256, 1)
attention_bwd_wg_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                         float* __restrict__ dqkv, int L, int C, int H, int d, float scale,
                         int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using W = WgSet<KS>;
  constexpr int NO = 4 * KS, NT = 256, RW = attn_tc::RawChunk<KS>::RW;
  constexpr int CH = attn_tc::RawChunk<KS>::FLOATS;
  uint8_t* sm = smem_raw + ((1024 - (attn_tc::saddr(smem_raw) & 1023)) & 1023);
  uint8_t *g0 = sm, *g1 = sm + W::BIG;
  float* st = reinterpret_cast<float*>(sm + 2 * W::BIG);
  float* raw = st + 3 * MAX_ROWS;
  const long long seq = blockIdx.x / H;
  const int h = (int)(blockIdx.x - seq * H), R = L, nb = (L + WG_ROWS - 1) / WG_ROWS;
  const int lr = BwdWg<KS>::last_rows(L);
  const int C3 = 3 * C, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const float* q = qkv + seq * L * C3 + (long long)h * d;
  const float* g = dO + seq * L * C + (long long)h * d;
  float* out = dqkv + seq * L * C3 + (long long)h * d;
  // chunk of operand p (0 q, 1 dO, 2 k, 3 v) of block blk, and its rows
  auto chunk = [&](int p, int blk) -> float* {
    return raw + (blk < nb - 1 ? (4 * blk + p) * CH : 4 * (nb - 1) * CH + p * lr * RW);
  };
  auto rows = [&](int blk) { return blk < nb - 1 ? WG_ROWS : lr; };
  for (int blk = 0; blk < nb; ++blk) {
    const int r0 = WG_ROWS * blk, n = rows(blk);
    attn_tc::fetch_rows<KS, NT>(chunk(0, blk), q, C3, r0, R, d, vec, n);
    attn_tc::fetch_rows<KS, NT>(chunk(1, blk), g, C, r0, R, d, vec, n);
    attn_tc::fetch_rows<KS, NT>(chunk(2, blk), q + C, C3, r0, R, d, vec, n);
    attn_tc::fetch_rows<KS, NT>(chunk(3, blk), q + 2 * C, C3, r0, R, d, vec, n);
  }
  attn_tc::copies_commit();
  attn_tc::copies_wait0();
  __syncthreads();
  const int rounds = (nb + 1) / 2;
  const float one[2] = {1.f, 1.f};

  // pass A: the rows' statistics over the 64-key chunks, then S and dP
  // again for dq
  for (int rd = 0; rd < rounds; ++rd) {
    const int b = 2 * rd + wg, bb = min(b, nb - 1), q0 = WG_ROWS * b;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, tot[2] = {0.f, 0.f};
    float inv[2] = {0.f, 0.f}, rt[2] = {0.f, 0.f}, dq[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) dq[e] = 0.f;
    for (int sweep = 0; sweep < 2; ++sweep)
      for (int c = 0; c < nb; ++c) {
        const int k0 = WG_ROWS * c;
        // S = Q K^T (K's rows in g0) while V's rows fill g1, then dP = dO
        // V^T while K^T fills g0 (the dq sweep); keys past L at -inf
        float s[32], dp[32];
        {
          float small[32];
          uint32_t xh[KS][4], xl[KS][4];
          __syncthreads();             // every wgmma that read g0 and g1 is waited for
          rows_from<KS, NT>(g0, chunk(2, c), rows(c));
          chunk_fragments<KS>(xh, xl, chunk(0, bb), rows(bb));
          set_ready();
          reg_products<KS>(s, small, xh, xl, g0);
          rows_from<KS, NT>(g1, chunk(3, c), rows(c));
          set_ready();
          wg_wait0();
#pragma unroll
          for (int e = 0; e < 32; ++e) s[e] += small[e];
          chunk_fragments<KS>(xh, xl, chunk(1, bb), rows(bb));
          reg_products<KS>(dp, small, xh, xl, g1);
          if (sweep == 1) {
            __syncthreads();           // both warpgroups' S is done with g0
            cols_from<KS, NT>(g0, chunk(2, c), rows(c));
            set_ready();
          }
          wg_wait0();
#pragma unroll
          for (int e = 0; e < 32; ++e) dp[e] += small[e];
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          s[e] = key < R ? s[e] * scale : -INFINITY;
        }
        if (sweep == 0) {
          // the rows' max, sum of e and sum of e * dP over one more chunk
          float cm[2] = {-INFINITY, -INFINITY}, cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 32; ++e) cm[(e >> 1) & 1] = fmaxf(cm[(e >> 1) & 1], s[e]);
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const float m = fmaxf(mx[qq], quad_max(cm[qq]));
            const float alpha = exp_mufu(mx[qq] - m);     // 0 on the first chunk
            sum[qq] *= alpha;
            tot[qq] *= alpha;
            mx[qq] = m;
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const float x = exp_mufu(s[e] - mx[(e >> 1) & 1]);
            cs[(e >> 1) & 1] += x;
            ct[(e >> 1) & 1] += x * dp[e];
          }
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            sum[qq] += quad_sum(cs[qq]);
            tot[qq] += quad_sum(ct[qq]);
          }
          continue;
        }
        if (c == 0) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            inv[qq] = 1.f / sum[qq];
            rt[qq] = tot[qq] * inv[qq];
            const int row = q0 + 16 * warp + gr + 8 * qq;
            if (t == 0 && row < R) {
              st[row] = mx[qq];
              st[MAX_ROWS + row] = inv[qq];
              st[2 * MAX_ROWS + row] = rt[qq];
            }
          }
        }
        // dS = P (dP - t / l) (into dp), then dq += dS K over the chunk in a
        // fresh accumulator (part), added in f32
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qq = (e >> 1) & 1;
          dp[e] = (exp_mufu(s[e] - mx[qq]) * inv[qq]) * (dp[e] - rt[qq]);
        }
        float part[NO];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (hh == 1 && k0 + 32 >= R) break;
          uint32_t ah[4][4], al[4][4];
          half_fragments(dp, hh, one, ah, al);
          set_times<KS, 4>(part, ah, al, g0 + hh * 2 * W::CB, hh);
          wg_wait0();
        }
#pragma unroll
        for (int e = 0; e < NO; ++e) dq[e] += part[e];
      }
    store_set<KS>(out, C3, dq, scale, q0, R, d, (d & 1) == 0);
  }
  __syncthreads();                   // the statistics are whole

  // pass B: S^T = K Q^T while dO's rows fill g1, dP^T = V dO^T while dO^T
  // fills g0, dv += P^T dO while Q^T fills g1, then dk += dS^T Q; each
  // chunk's products in a fresh accumulator added in f32
  for (int rd = 0; rd < rounds; ++rd) {
    const int c = 2 * rd + wg, cc = min(c, nb - 1), k0 = WG_ROWS * c;
    float dk[NO], dv[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) dk[e] = dv[e] = 0.f;
    for (int b = 0; b < nb; ++b) {
      const int q0 = WG_ROWS * b;
      float s[32], dp[32];
      {
        float small[32];
        uint32_t xh[KS][4], xl[KS][4];
        __syncthreads();
        rows_from<KS, NT>(g0, chunk(0, b), rows(b));
        chunk_fragments<KS>(xh, xl, chunk(2, cc), rows(cc));
        set_ready();
        reg_products<KS>(s, small, xh, xl, g0);
        rows_from<KS, NT>(g1, chunk(1, b), rows(b));
        set_ready();
        wg_wait0();
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] += small[e];
        chunk_fragments<KS>(xh, xl, chunk(3, cc), rows(cc));
        reg_products<KS>(dp, small, xh, xl, g1);
        __syncthreads();               // both warpgroups' S^T is done with g0
        cols_from<KS, NT>(g0, chunk(1, b), rows(b));
        set_ready();
        wg_wait0();
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] += small[e];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int query = q0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const bool in = query < R;
        const float p = in ? exp_mufu(s[e] * scale - st[query]) * st[MAX_ROWS + query] : 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - (in ? st[2 * MAX_ROWS + query] : 0.f));
      }
      const bool both = q0 + 32 < R;
      float part[NO];
      {
        uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) half_fragments(s, hh, one, ah[hh], al[hh]);
        set_times<KS, 4>(part, ah[0], al[0], g0, 0);
        if (both) set_times<KS, 4>(part, ah[1], al[1], g0 + 2 * W::CB, 1);
        __syncthreads();               // both warpgroups' dP^T is done with g1
        cols_from<KS, NT>(g1, chunk(0, b), rows(b));
        set_ready();
        wg_wait0();
      }
#pragma unroll
      for (int e = 0; e < NO; ++e) dv[e] += part[e];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh == 1 && !both) break;
        uint32_t ah[4][4], al[4][4];
        half_fragments(dp, hh, one, ah, al);
        set_times<KS, 4>(part, ah, al, g1 + hh * 2 * W::CB, hh);
        wg_wait0();
      }
#pragma unroll
      for (int e = 0; e < NO; ++e) dk[e] += part[e];
    }
    store_set<KS>(out + C, C3, dk, scale, k0, R, d, (d & 1) == 0);
    store_set<KS>(out + 2 * C, C3, dv, 1.f, k0, R, d, (d & 1) == 0);
  }
}

// The wgmma kernel's launch: one CTA a (sequence, head) unit.
template <int KS>
cudaError_t launch_wg(const float* qkv, const float* dO, float* dqkv, long long seqs, int L,
                      int C, int H, int d, float scale, int vec, cudaStream_t stream) {
  const auto kernel = attention_bwd_wg_kernel<KS>;
  const int smem = BwdWg<KS>::smem(L);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = seqs * H;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, 256, smem, stream>>>(qkv, dO, dqkv, L, C, H, d, scale, vec);
  return counted(LAUNCH_ATTENTION_BWD_WG, cudaGetLastError());
}

// Whether the wgmma kernel takes (L, d): past one key chunk of the mma.sync
// kernel, d <= 48, the unit's raw rows in one CTA.  Measured against the
// mma.sync kernel's chunks at the monolithic (999, 134, 288), 4.58 ms
// against 5.22, and at 243 frames, (64, 243, 224) and (64, 243, 256) at d =
// 28 and 32, 0.40 against 0.53; past the fit (243 frames at d = 36 and 48)
// the streamed kernels, 0.72 and 0.74 against 0.85 and 0.90 (H100 80GB
// HBM3 at 700 W, chip_ab.py --only stages, PERF.md).
inline bool wg_takes(int L, int d) {
  if (L <= ONE_CHUNK || L > MAX_ROWS || d < 1 || d > 48) return false;
  switch (wg_ksteps(d)) {
    case 4: return BwdWg<4>::smem(L) <= SMEM_MAX;
    case 5: return BwdWg<5>::smem(L) <= SMEM_MAX;
    default: return BwdWg<6>::smem(L) <= SMEM_MAX;
  }
}

// ---------------------------------------------------------------------------
// The resident backward on wgmma for short units (L <= 64 at d <= 48: H3WB's,
// 3DHP's and the monolithic model's 27-frame shapes), units packed into one
// warpgroup's 64 rows (see the note at the top)
// ---------------------------------------------------------------------------

// A unit's slot in a packed block: L rounded up to 8, so each unit's keys
// meet the k-steps of 8 as they do alone; the units a block.
__host__ __device__ constexpr int pack_slot(int L) { return (L + 7) / 8 * 8; }
__host__ __device__ constexpr int pack_units(int L) { return WG_ROWS / pack_slot(L); }

template <int KS> struct BwdPack {
  // two sets, the rows' statistics, the four raw operands of the block's
  // rows and 1 KB to align the sets
  __host__ __device__ static constexpr int smem(int L) {
    return 2 * WgSet<KS>::BIG + 3 * WG_ROWS * 4 +
           4 * pack_units(L) * pack_slot(L) * attn_tc::RawChunk<KS>::RW * 4 + 1024;
  }
};

// The first element of slot row `row`'s token in qkv (its q columns) and in
// dO, or false where the row holds no unit's token: slot s row j is unit u0
// + s's token j; (seq0, h0) is unit u0's (sequence, head).
__device__ __forceinline__ bool slot_row(int row, int SL, int nu, int L, long long seq0, int h0,
                                         int C, int H, int d, long long& oq, long long& og) {
  const int s = row / SL, j = row - s * SL;
  if (s >= nu || j >= L) return false;
  const int h = h0 + s, ds = h / H;
  const long long tok = (seq0 + ds) * L + j, col = (long long)(h - ds * H) * d;
  oq = tok * 3 * C + col;
  og = tok * C + col;
  return true;
}

// The block's rows of q, dO, k and v (raw chunks of `rows` rows, in that
// order) by the CTA's cp.async, zeros past the units' tokens and from column
// d on; vec: 16 bytes a copy (see fetch_rows).
template <int KS>
__device__ __forceinline__ void fetch_packed(float* raw, const float* qkv, const float* dO,
                                             int SL, int nu, int L, long long seq0, int h0,
                                             int rows, int C, int H, int d, int vec) {
  constexpr int RW = attn_tc::RawChunk<KS>::RW;
  const int n = rows * RW, step = vec ? 4 : 1;
  for (int i = step * threadIdx.x; i < n; i += step * 128) {
    const int row = i / RW, c = i - row * RW;
    long long oq = 0, og = 0;
    const bool in = slot_row(row, SL, nu, L, seq0, h0, C, H, d, oq, og) && c < d;
    if (vec) {
      const int bytes = in ? 16 : 0;
      attn_tc::copy16_zfill(raw + i, qkv + oq + c, bytes);
      attn_tc::copy16_zfill(raw + n + i, dO + og + c, bytes);
      attn_tc::copy16_zfill(raw + 2 * n + i, qkv + oq + C + c, bytes);
      attn_tc::copy16_zfill(raw + 3 * n + i, qkv + oq + 2 * C + c, bytes);
    } else {
      const int bytes = in ? 4 : 0;
      attn_tc::copy4_zfill(raw + i, qkv + oq + c, bytes);
      attn_tc::copy4_zfill(raw + n + i, dO + og + c, bytes);
      attn_tc::copy4_zfill(raw + 2 * n + i, qkv + oq + C + c, bytes);
      attn_tc::copy4_zfill(raw + 3 * n + i, qkv + oq + 2 * C + c, bytes);
    }
  }
}

// Rows 16 warp + g (+ 8) of a packed 64 x 8 KS accumulator times scale into
// out (dqkv's q columns; + C: k's, + 2C: v's), the units' tokens only.
template <int KS>
__device__ __forceinline__ void store_packed(float* out, const float (&acc)[4 * KS], float scale,
                                             int SL, int nu, int L, long long seq0, int h0,
                                             int C, int H, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    long long oq, og;
    if (!slot_row(16 * warp + g + 8 * q, SL, nu, L, seq0, h0, C, H, d, oq, og)) continue;
    float* o = out + oq;
#pragma unroll
    for (int m = 0; m < KS; ++m) {
      const int col = 8 * m + 2 * t;
      const float a = acc[4 * m + 2 * q] * scale, b = acc[4 * m + 2 * q + 1] * scale;
      if ((d & 1) == 0) {
        if (col < d) *reinterpret_cast<float2*>(o + col) = make_float2(a, b);
      } else {
        if (col < d) o[col] = a;
        if (col + 1 < d) o[col + 1] = b;
      }
    }
  }
}

// A CTA is one warpgroup and one block of pack_units(L) units.  Pass A: S =
// Q K^T and dP = dO V^T over the block (A fragments from the raw rows, K's
// and V's rows sets), a key outside the row's own unit at -inf; the row's
// whole softmax in registers; dq = dS K (K's cols set).  Pass B: S^T = K
// Q^T and dP^T = V dO^T (Q's and dO's rows sets), P^T and dS^T from the
// rows' statistics, dv = P^T dO and dk = dS^T Q (dO's and Q's cols sets).
// Each set is filled while the products on the other run.
template <int KS, int MINB>
__global__ void __launch_bounds__(128, MINB)
attention_bwd_pack_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                          float* __restrict__ dqkv, long long units, int L, int C, int H, int d,
                          float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using W = WgSet<KS>;
  constexpr int NO = 4 * KS, RW = attn_tc::RawChunk<KS>::RW;
  uint8_t* sm = smem_raw + ((1024 - (attn_tc::saddr(smem_raw) & 1023)) & 1023);
  uint8_t *g0 = sm, *g1 = sm + W::BIG;
  float* st = reinterpret_cast<float*>(sm + 2 * W::BIG);
  float* raw = st + 3 * WG_ROWS;
  const int SL = pack_slot(L), P = WG_ROWS / SL, rows = P * SL;
  const long long u0 = (long long)blockIdx.x * P, seq0 = u0 / H;
  const int nu = (int)min((long long)P, units - u0), h0 = (int)(u0 - seq0 * H);
  float *rq = raw, *rg = raw + rows * RW, *rk = raw + 2 * rows * RW, *rv = raw + 3 * rows * RW;
  fetch_packed<KS>(raw, qkv, dO, SL, nu, L, seq0, h0, rows, C, H, d, vec);
  attn_tc::copies_commit();
  attn_tc::copies_wait0();
  __syncthreads();

  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  // this thread's two rows and the keys of each one's unit: [lo, lo + L)
  int lo[2];
#pragma unroll
  for (int qq = 0; qq < 2; ++qq) {
    const int row = 16 * warp + gr + 8 * qq;
    lo[qq] = row / SL * SL;
  }
  auto in = [&](int e) {
    const int c = 8 * (e >> 2) + 2 * t + (e & 1), b = lo[(e >> 1) & 1];
    return c >= b && c < b + L;
  };
  const float one[2] = {1.f, 1.f};
  float s[32], dp[32], small[32];
  uint32_t xh[KS][4], xl[KS][4];

  // pass A
  rows_from<KS>(g0, rk, rows);
  set_ready();
  chunk_fragments<KS>(xh, xl, rq, rows);
  reg_products<KS>(s, small, xh, xl, g0);
  rows_from<KS>(g1, rv, rows);
  set_ready();
  wg_wait0();
  attn_tc::fence_regs(s);
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] += small[e];
  chunk_fragments<KS>(xh, xl, rg, rows);
  reg_products<KS>(dp, small, xh, xl, g1);
  // the rows' softmax while dP runs: m, e = 2^((s - m) log2 e), l
  float mx[2] = {-INFINITY, -INFINITY}, inv[2], rt[2];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = in(e) ? s[e] * scale : -INFINITY;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  }
  {
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) mx[qq] = quad_max(mx[qq]);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = exp_mufu(s[e] - mx[(e >> 1) & 1]);
      cs[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) inv[qq] = 1.f / quad_sum(cs[qq]);
  }
  __syncthreads();                   // every warp's S is done with g0
  cols_from<KS>(g0, rk, rows);
  set_ready();
  wg_wait0();
  attn_tc::fence_regs(dp);
  {
    float ct[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dp[e] += small[e];
      ct[(e >> 1) & 1] += s[e] * dp[e];
    }
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      rt[qq] = quad_sum(ct[qq]) * inv[qq];
      const int row = 16 * warp + gr + 8 * qq;
      if (t == 0) {
        st[row] = mx[qq];
        st[WG_ROWS + row] = inv[qq];
        st[2 * WG_ROWS + row] = rt[qq];
      }
    }
  }
  // dS = P (dP - t / l), then dq = dS K over the block's 64 keys
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int qq = (e >> 1) & 1;
    dp[e] = (s[e] * inv[qq]) * (dp[e] - rt[qq]);
  }
  {
    float dq[NO];
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) half_fragments(dp, hh, one, ah[hh], al[hh]);
    set_times<KS, 4>(dq, ah[0], al[0], g0, 0);
    if (rows > 32) set_times<KS, 4>(dq, ah[1], al[1], g0 + 2 * W::CB, 1);
    __syncthreads();                 // every warp's dP is done with g1
    rows_from<KS>(g1, rq, rows);
    set_ready();                     // and the statistics are whole
    wg_wait0();
    attn_tc::fence_regs(dq);
    store_packed<KS>(dqkv, dq, scale, SL, nu, L, seq0, h0, C, H, d);
  }

  // pass B: this thread's two rows are keys now, the columns queries
  chunk_fragments<KS>(xh, xl, rk, rows);
  reg_products<KS>(s, small, xh, xl, g1);
  __syncthreads();                   // every warp's dq is done with g0
  rows_from<KS>(g0, rg, rows);
  set_ready();
  wg_wait0();
  attn_tc::fence_regs(s);
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] += small[e];
  chunk_fragments<KS>(xh, xl, rv, rows);
  reg_products<KS>(dp, small, xh, xl, g0);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int query = 8 * (e >> 2) + 2 * t + (e & 1);
    s[e] = in(e) ? exp_mufu(s[e] * scale - st[query]) * st[WG_ROWS + query] : 0.f;
  }
  __syncthreads();                   // every warp's S^T is done with g1
  cols_from<KS>(g1, rg, rows);
  set_ready();
  wg_wait0();
  attn_tc::fence_regs(dp);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int query = 8 * (e >> 2) + 2 * t + (e & 1);
    dp[e] = s[e] * (dp[e] + small[e] - (in(e) ? st[2 * WG_ROWS + query] : 0.f));
  }
  float dk[NO], dv[NO];
  {
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) half_fragments(s, hh, one, ah[hh], al[hh]);
    set_times<KS, 4>(dv, ah[0], al[0], g1, 0);
    if (rows > 32) set_times<KS, 4>(dv, ah[1], al[1], g1 + 2 * W::CB, 1);
    __syncthreads();                 // every warp's dP^T is done with g0
    cols_from<KS>(g0, rq, rows);
    set_ready();
    wg_wait0();
  }
  {
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) half_fragments(dp, hh, one, ah[hh], al[hh]);
    set_times<KS, 4>(dk, ah[0], al[0], g0, 0);
    if (rows > 32) set_times<KS, 4>(dk, ah[1], al[1], g0 + 2 * W::CB, 1);
    wg_wait0();
  }
  attn_tc::fence_regs(dv);
  attn_tc::fence_regs(dk);
  store_packed<KS>(dqkv + C, dk, scale, SL, nu, L, seq0, h0, C, H, d);
  store_packed<KS>(dqkv + 2 * C, dv, 1.f, SL, nu, L, seq0, h0, C, H, d);
}

// The packed kernel's launch: one CTA a block of pack_units(L) units.
template <int KS, int MINB>
cudaError_t launch_pack(const float* qkv, const float* dO, float* dqkv, long long seqs, int L,
                        int C, int H, int d, float scale, int vec, cudaStream_t stream) {
  const auto kernel = attention_bwd_pack_kernel<KS, MINB>;
  const int smem = BwdPack<KS>::smem(L);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long units = seqs * H, grid = (units + pack_units(L) - 1) / pack_units(L);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, 128, smem, stream>>>(qkv, dO, dqkv, units, L, C, H, d, scale, vec);
  return counted(LAUNCH_ATTENTION_BWD_PACK, cudaGetLastError());
}

// Whether the packed kernel takes (L, d): a unit in one block of 64 rows at
// d <= 48, while PACK_SHORT_UNITS.  It does not: on an H100 80GB HBM3 at
// 700 W it measured 1.1-2.3x slower than the mma.sync kernel at every such
// main-path shape (chip_ab.py --route-tree pack, PERF.md), so those stay on
// mma.sync; chip_ab.py's "pack" tree sets it to time the kernel again.
constexpr bool PACK_SHORT_UNITS = false;
inline bool pack_takes(int L, int d) {
  return PACK_SHORT_UNITS && L >= 1 && L <= WG_ROWS && d >= 1 && d <= 48;
}

// ---------------------------------------------------------------------------
// The streamed backward, for the units the resident kernel above does not
// take (d above 64, up to attn_tc::MAX_STREAM_DIM, or one unit's q, k, v
// and dO beyond a CTA's shared memory).  Two launches, each CTA 128 rows of
// one (sequence, head), d padded to 64 or 128:
//   - pass A, per query: K and V stream through shared memory in ring
//     chunks, twice: the row's max, sum and sum of e * dP over chunks of
//     STREAM_KC keys (rescaled as the resident pass A rescales), then dS
//     and dq = scale * dS K.  Each row's m, 1 / l and t / l go to the
//     caller's scratch in global memory (3 L floats a unit);
//   - pass B, per key: Q, dO and the rows' statistics stream through the
//     ring in chunks of queries, walked in order as the resident pass B
//     walks its query tiles (a 16-query tile wholly past L skipped as
//     there).
// The statistics go through global memory, not shared, because the two
// passes cut a unit differently (queries, keys) and so run as two
// launches; at 3 floats a row they are a 1/40 of the unit's bytes at d =
// 64.  S, dP and the statistics are the resident kernel's (row_products)
// product for product.  The three sums over L (dq over keys, dk and dv
// over queries) are not held in one tensor-core accumulator: its
// accumulation truncates, and over 1000 terms it drifts past the 1e-5
// bound (1.2e-5 against float64 on an H100, where float32 sums err by
// 1.9e-6).  Each chunk's products go into a fresh accumulator (the first
// wgmma's scale-d is 0, or mma.sync's C is zero) that is added to the
// f32 total with FADDs, chunk by chunk in a fixed order: on wgmma (d = 64)
// a ring chunk (pass A 64 keys, pass B 32 queries), on mma.sync (d = 128)
// each 8-row k-step.  So the streamed kernel's bits differ from the
// resident one's where both would take a shape.
//
// What bounds it on an H100 (data-sheet peaks at 700 W): 10*B*L^2*C
// operations (five products) at 165 TFLOP/s, float32 done as three TF32
// products, against qkv and dO read once and dqkv written once: at L >= 134
// the operations.  S and dP are computed three times (pass A twice, pass B
// once), so the kernels do 9 products where 5 would do: the row statistics
// need the whole row before dS exists, and pass B's key blocks would need
// another CTA's rows to reuse pass A's.  What the design does about the
// rest:
//   - each ring chunk, once it lands (cp.async, one stage), is split once
//     per CTA into TF32 halves in shared memory, in the layout its
//     products read (no warp splits a B operand);
//   - d = 64 runs on wgmma, the tensor cores' full-rate path: a warpgroup
//     takes 64 rows, its A operands' hi halves as register fragments and
//     their lo halves in tiles; the ring chunk is 32 rows, as wgmma tiles
//     by rows and transposed;
//   - d = 128 runs on mma.sync (the warpgroups' A operands would not fit):
//     a warp takes 16 rows, its A operands unsplit in shared memory, each
//     k-step's A fragment split once for the n8 tiles of a 16-row ring
//     chunk, whose planes hold each lane's B fragment as one 16-byte load.
// No atomics: a call repeats bit for bit.
// ---------------------------------------------------------------------------

constexpr int STREAM_WARPS = 8;                   // 16-row tiles a CTA: two warpgroups
constexpr int STREAM_THREADS = 32 * STREAM_WARPS;
constexpr int STREAM_KC = 32;                     // keys of pass A's statistics chunk

using attn_tc::load_operand;
using attn_tc::split_col_tile;
using attn_tc::split_row_tiles;
using attn_tc::stream_dim;
using attn_tc::stream_rows;
using attn_tc::swz16;
using attn_tc::tile_desc;
using attn_tc::wg_commit;
using attn_tc::wg_fence;
using attn_tc::WgTf32;
using attn_tc::zero_smem;

// 1: a resident kernel takes (L, d): the packed wgmma one where
// pack_takes(L, d), the wgmma one where wg_takes(L, d), else the mma.sync
// one up to one key chunk (80 keys); 2: the streamed one; 0: neither.
// Past one key chunk at d = 49..64 the streamed kernels are the faster
// (MixSTE's spatial (972, 134, 512) on an H100 80GB HBM3 at 700 W,
// chip_ab.py: 7.36 ms against the mma.sync kernel's 9.47; the wgmma
// kernel measured slower there too) (PERF.md).
inline int variant(int L, int d) {
  if (L < 1 || d < 1 || d > attn_tc::MAX_STREAM_DIM) return 0;
  if (d > MAX_HEAD_DIM) return 2;
  return pack_takes(L, d) || wg_takes(L, d) || L <= ONE_CHUNK ? 1 : 2;
}

// ---------------------------------------------------------------------------
// d = 64 on wgmma (attention_sm90.cuh's float32 tiles and fragments): a
// warpgroup takes 64 rows, its two A operands' hi halves as register
// fragments and their lo halves in tiles; each ring chunk of 32 rows is
// split once per CTA into K-major tiles by rows (the B of S and dP) and
// transposed (the B of dq, dk, dv).  Pass A's ring chunk is one chunk of
// the statistics.
// ---------------------------------------------------------------------------

// The tiles of a CTA (B: pass B; ring chunks of RK rows: pass A 64 keys,
// two chunks of the statistics; pass B 32 queries, where K's and V's hi
// fragments, dk and dv leave no registers for more): the operands' lo
// tiles [operand][warpgroup][slice of d]; the ring chunk's rows tiles
// [part][slice of d][hi, lo] (pass A K and V, pass B Q and dO) and
// transposed tiles [part][32 rows][hi, lo] (pass A K, pass B Q and dO); the
// chunk as copied ([2][RK][DP] floats; pass B its rows' statistics [3][RK]
// and their copy [3][RK]); 1 KB to align the tiles.
template <int DP, bool B> struct WgTiles {
  static constexpr int NSL = DP / 32, RK = B ? 32 : 64, NKS = RK / 32;
  static constexpr int OT = WG_ROWS * 128, RB = RK * 128, CB = DP * 128;
  static constexpr int O_OFF = 0;
  static constexpr int R_OFF = O_OFF + 2 * 2 * NSL * OT;
  static constexpr int C_OFF = R_OFF + 2 * NSL * 2 * RB;
  // pass A: dO's hi halves in tiles too [warpgroup][slice of d] (in
  // registers beside Q's they would spill)
  static constexpr int H_OFF = C_OFF + (B ? 2 : 1) * NKS * 2 * CB;
  static constexpr int RAW_OFF = H_OFF + (B ? 0 : 2 * NSL * OT);
  static constexpr int SMEM = RAW_OFF + (2 * RK * DP + (B ? 6 * RK : 0)) * 4 + 1024;
};

// A warpgroup's operand with both halves in tiles (one a slice of d; hi at
// hi_tiles, lo at lo_tiles): load_operand's values and layout.
template <int DP>
__device__ __forceinline__ void load_operand_tiles(uint8_t* hi_tiles, uint8_t* lo_tiles, int tb,
                                                   const float* x, long long ld, int row0, int L,
                                                   int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e & 1), row = row0 + r, col = 8 * kk + t + 4 * (e >> 1);
      uint32_t hi, lo;
      split(row < L && col < d ? x[(long long)row * ld + col] : 0.f, hi, lo);
      const int off = (col / 32) * tb + swz16(r, (col % 32) / 4) + (col % 4) * 4;
      *reinterpret_cast<uint32_t*>(hi_tiles + off) = hi;
      *reinterpret_cast<uint32_t*>(lo_tiles + off) = lo;
    }
}

// wg_products with both of X's halves in tiles (xhi, xlo).
template <int DP, bool B>
__device__ __forceinline__ void wg_products_tiles(float (&acc)[WgTiles<DP, B>::RK / 2],
                                                  const uint8_t* xhi, const uint8_t* xlo,
                                                  const uint8_t* rows) {
  using Lt = WgTiles<DP, B>;
  constexpr int NV = Lt::RK / 2;
  float small[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = small[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int sl = 0; sl < Lt::NSL; ++sl) {
    const uint64_t yh = tile_desc(rows + sl * 2 * Lt::RB), yl = yh + (Lt::RB >> 4);
    const uint64_t xh = tile_desc(xhi + sl * Lt::OT), xl = tile_desc(xlo + sl * Lt::OT);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      WgTf32<Lt::RK>::ss(small, xl + 2 * kk, yh + 2 * kk, 1);
      WgTf32<Lt::RK>::ss(small, xh + 2 * kk, yl + 2 * kk, 1);
      WgTf32<Lt::RK>::ss(acc, xh + 2 * kk, yh + 2 * kk, 1);
    }
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] += small[e];
}

// acc (a warpgroup's 64 x RK, this thread's RK / 2) = X Y^T over a ring
// chunk: X the warpgroup's operand (hi fragments xh, lo tiles at xlo, one
// a slice of d), Y the chunk's rows (hi and lo tiles of slice sl at rows +
// 2 sl RB): row_products' three TF32 products a k-step, lo*hi and hi*lo
// summed apart and added after the last.
// wg_issue issues the products as one commit group, the caller waits and
// adds small to acc.
template <int DP, bool B>
__device__ __forceinline__ void wg_issue(float (&acc)[WgTiles<DP, B>::RK / 2],
                                         float (&small)[WgTiles<DP, B>::RK / 2],
                                         const uint32_t (&xh)[DP / 8][4], const uint8_t* xlo,
                                         const uint8_t* rows) {
  using Lt = WgTiles<DP, B>;
  constexpr int NV = Lt::RK / 2;
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = small[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int sl = 0; sl < Lt::NSL; ++sl) {
    const uint64_t yh = tile_desc(rows + sl * 2 * Lt::RB), yl = yh + (Lt::RB >> 4);
    const uint64_t xl = tile_desc(xlo + sl * Lt::OT);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      WgTf32<Lt::RK>::ss(small, xl + 2 * kk, yh + 2 * kk, 1);
      WgTf32<Lt::RK>::rs(small, xh[4 * sl + kk], yl + 2 * kk, 1);
      WgTf32<Lt::RK>::rs(acc, xh[4 * sl + kk], yh + 2 * kk, 1);
    }
  }
  wg_commit();
}

template <int DP, bool B>
__device__ __forceinline__ void wg_products(float (&acc)[WgTiles<DP, B>::RK / 2],
                                            const uint32_t (&xh)[DP / 8][4], const uint8_t* xlo,
                                            const uint8_t* rows) {
  constexpr int NV = WgTiles<DP, B>::RK / 2;
  float small[NV];
  wg_issue<DP, B>(acc, small, xh, xlo, rows);
  wg_wait0();
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] += small[e];
}

// acc (64 x DP) = A Z over the first NK k-steps of 32 rows of a ring chunk
// (4: all 32 rows; 2: the first 16), plus acc where `keep` is 1 (its first
// wgmma's scale-d; 0: a fresh accumulator): A's fragments (ah, al) repacked
// from an accumulator, Z the rows' transposed tile (hi at z, lo DP * 128
// further): fragment_times_rows' three products, as one commit group.
template <int DP, int NK>
__device__ __forceinline__ void wg_times(float (&acc)[DP / 2], const uint32_t (&ah)[4][4],
                                         const uint32_t (&al)[4][4], const uint8_t* z, int keep) {
  const uint64_t zh = tile_desc(z), zl = zh + ((DP * 128) >> 4);
  wg_fence();
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    WgTf32<DP>::rs(acc, al[j], zh + 2 * j, j == 0 ? keep : 1);
    WgTf32<DP>::rs(acc, ah[j], zl + 2 * j, 1);
    WgTf32<DP>::rs(acc, ah[j], zh + 2 * j, 1);
  }
  wg_commit();
}

// Rows row0 + 16 warp + g (+ 8), columns < d of a wgmma accumulator acc
// (value 4n + 2q + {0, 1}: row + 8q, column 8n + 2t + {0, 1}) times scale
// into out (row r at out + r * ld).
template <int DP>
__device__ __forceinline__ void store_acc(float* out, long long ld, const float (&acc)[DP / 2],
                                          float scale, int row0, int L, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = row0 + 16 * warp + g + 8 * q;
    if (row >= L) continue;
    float* o = out + (long long)row * ld;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float a = acc[4 * n + 2 * q] * scale, b = acc[4 * n + 2 * q + 1] * scale;
      if ((d & 1) == 0) {
        if (col < d) *reinterpret_cast<float2*>(o + col) = make_float2(a, b);
      } else {
        if (col < d) o[col] = a;
        if (col + 1 < d) o[col + 1] = b;
      }
    }
  }
}

// Pass A on wgmma: warpgroup wg of CTA blk takes queries (2 blk + wg) * 64..
// A ring chunk of 64 keys is two chunks of the statistics; a half wholly
// past L is no chunk of them (the chunks end with the one that holds the
// last key).
template <int DP>
__device__ __forceinline__ void stream_a_wg(const float* __restrict__ qkv,
                                            const float* __restrict__ dO, float* __restrict__ dqkv,
                                            float* __restrict__ stats, int L, int C, int H, int d,
                                            float scale, int blocks, int vb,
                                            unsigned char* smem_raw) {
  using Lt = WgTiles<DP, false>;
  constexpr int NSL = Lt::NSL, RK = Lt::RK, KS = DP / 8, NV = RK / 2;
  static_assert(RK == 2 * STREAM_KC, "a ring chunk is two chunks of the statistics");
  uint8_t* sm = smem_raw + ((1024 - (attn_tc::saddr(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(sm + Lt::RAW_OFF);        // K, then V: [RK][DP]
  const long long unit = blockIdx.x / blocks, seq = unit / H;
  const int blk = (int)(blockIdx.x - unit * blocks), h = (int)(unit - seq * H);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = (blk * 2 + wg) * WG_ROWS;
  const int C3 = 3 * C, nr = (L + RK - 1) / RK, steps = 2 * nr;
  const float* src = qkv + seq * L * C3 + (long long)h * d;    // the unit's q at token 0
  uint8_t* qlo = sm + Lt::O_OFF + wg * NSL * Lt::OT;
  uint8_t* glo = qlo + 2 * NSL * Lt::OT;
  uint8_t* ghi = sm + Lt::H_OFF + wg * NSL * Lt::OT;

  zero_smem(raw, 2 * RK * DP * 4 / 16);
  uint32_t qh[KS][4], none[1][4];
  load_operand<DP, false>(qh, none, qlo, Lt::OT, src, 0, 1, C3, q0, L, d);
  load_operand_tiles<DP>(ghi, glo, Lt::OT, dO + seq * L * C + (long long)h * d, C, q0, L, d);
  __syncthreads();
  // step i < nr: ring chunk i of K and V for the statistics; nr + i: again
  // for dq
  auto issue = [&](int step) {
    const int k0 = (step < nr ? step : step - nr) * RK;
    const int rows = L - k0 < RK ? L - k0 : RK;
    stream_rows(vb, raw, src + C, 0, 1, C3, k0, rows, d, DP);
    stream_rows(vb, raw + RK * DP, src + 2 * C, 0, 1, C3, k0, rows, d, DP);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, tot[2] = {0.f, 0.f};
  float inv[2], rt[2], dq[DP / 2];
#pragma unroll
  for (int n = 0; n < DP / 2; ++n) dq[n] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const bool dq_sweep = step >= nr;
    const int r = dq_sweep ? step - nr : step, k0 = r * RK;
    const bool both = k0 + STREAM_KC < L;      // else the second half is past L
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();     // the chunk has landed; no wgmma reads the tiles any more
    split_row_tiles<DP, RK>(sm + Lt::R_OFF, raw);                              // K
    split_row_tiles<DP, RK>(sm + Lt::R_OFF + NSL * 2 * Lt::RB, raw + RK * DP);  // V
    if (dq_sweep)                                                              // K^T
#pragma unroll
      for (int ks = 0; ks < Lt::NKS; ++ks)
        split_col_tile<DP>(sm + Lt::C_OFF + ks * 2 * Lt::CB, raw + 32 * ks * DP);
    async_proxy_fence();
    __syncthreads();     // the tiles are whole; the stage is free
    if (step + 1 < steps) issue(step + 1);
    // (a warpgroup wholly past L computes on zero rows and stores nothing: a
    // branch on it would serialise the wgmmas)
    // S = Q K^T and dP = dO V^T over the chunk, keys past L masked to -inf
    float s[NV], dp[NV];
    wg_products<DP, false>(s, qh, qlo, sm + Lt::R_OFF);
    wg_products_tiles<DP, false>(dp, ghi, glo, sm + Lt::R_OFF + NSL * 2 * Lt::RB);
#pragma unroll
    for (int e = 0; e < NV; ++e)
      s[e] = k0 + 8 * (e >> 2) + 2 * t + (e & 1) < L ? s[e] * scale : -INFINITY;
    if (!dq_sweep) {
      // the rows' max, sum of e and sum of e * dP over each chunk of the
      // statistics (32 keys: values 16 hh..16 hh + 15)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh == 1 && !both) break;
        float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 16 * hh; e < 16 * hh + 16; ++e)
          cm[(e >> 1) & 1] = fmaxf(cm[(e >> 1) & 1], s[e]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float m = fmaxf(mx[q], attn_tc::quad_max(cm[q]));
          const float alpha = expf(mx[q] - m);     // 0 on the first chunk
          sum[q] *= alpha;
          tot[q] *= alpha;
          mx[q] = m;
        }
        float cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 16 * hh; e < 16 * hh + 16; ++e) {
          const float x = expf(s[e] - mx[(e >> 1) & 1]);
          cs[(e >> 1) & 1] += x;
          ct[(e >> 1) & 1] += x * dp[e];
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          sum[q] += quad_sum(cs[q]);
          tot[q] += quad_sum(ct[q]);
        }
      }
      continue;
    }
    if (r == 0) {
      float* st = stats + unit * 3 * L;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        inv[q] = 1.f / sum[q];
        rt[q] = tot[q] * inv[q];
        const int row = q0 + 16 * warp + gr + 8 * q;
        if (t == 0 && row < L) {
          st[row] = mx[q];
          st[L + row] = inv[q];
          st[2 * L + row] = rt[q];
        }
      }
    }
    // dq += dS K, dS = P (dP - t / l) (into dp) repacked as the A operand:
    // the ring chunk's products in a fresh accumulator (part), 32 keys a
    // commit group (the second only where its chunk of the statistics is),
    // then added to dq in f32, chunk by chunk in order
#pragma unroll
    for (int e = 0; e < NV; ++e)
      dp[e] = (expf(s[e] - mx[(e >> 1) & 1]) * inv[(e >> 1) & 1]) * (dp[e] - rt[(e >> 1) & 1]);
    float part[DP / 2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (hh == 1 && !both) break;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ds[4] = {dp[16 * hh + 4 * j], dp[16 * hh + 4 * j + 1],
                             dp[16 * hh + 4 * j + 2], dp[16 * hh + 4 * j + 3]};
        acc_fragment(ds, ah[j], al[j]);
      }
      wg_times<DP, 4>(part, ah, al, sm + Lt::C_OFF + hh * 2 * Lt::CB, hh);
      wg_wait0();
    }
#pragma unroll
    for (int n = 0; n < DP / 2; ++n) dq[n] += part[n];
  }
  store_acc<DP>(dqkv + seq * L * C3 + (long long)h * d, C3, dq, scale, q0, L, d);
}

// Pass B on wgmma: warpgroup wg of CTA blk takes keys (2 blk + wg) * 64..,
// with pass A's statistics; the queries' ring chunks in order, a 16-query
// tile wholly past L skipped as the resident pass B skips it.
template <int DP>
__device__ __forceinline__ void stream_b_wg(const float* __restrict__ qkv,
                                            const float* __restrict__ dO,
                                            const float* __restrict__ stats,
                                            float* __restrict__ dqkv, int L, int C, int H, int d,
                                            float scale, int blocks, int vb,
                                            unsigned char* smem_raw) {
  using Lt = WgTiles<DP, true>;
  constexpr int NSL = Lt::NSL, RK = Lt::RK, KS = DP / 8, NV = RK / 2;
  uint8_t* sm = smem_raw + ((1024 - (attn_tc::saddr(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(sm + Lt::RAW_OFF);   // Q, then dO: [RK][DP]
  float* sst = raw + 2 * RK * DP;                            // the chunk's m, 1 / l, t / l
  float* sp = sst + 3 * RK;                                  // and their copy
  const long long unit = blockIdx.x / blocks, seq = unit / H;
  const int blk = (int)(blockIdx.x - unit * blocks), h = (int)(unit - seq * H);
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 3;
  const int k0 = (blk * 2 + wg) * WG_ROWS;
  const int C3 = 3 * C, nr = (L + RK - 1) / RK;
  const float* src = qkv + seq * L * C3 + (long long)h * d;
  const float* gsrc = dO + seq * L * C + (long long)h * d;
  const float* st = stats + unit * 3 * L;
  uint8_t* klo = sm + Lt::O_OFF + wg * NSL * Lt::OT;
  uint8_t* vlo = klo + 2 * NSL * Lt::OT;

  zero_smem(raw, (2 * RK * DP + 6 * RK) * 4 / 16);
  uint32_t kh[KS][4], vh[KS][4], none[1][4];
  load_operand<DP, false>(kh, none, klo, Lt::OT, src + C, 0, 1, C3, k0, L, d);
  load_operand<DP, false>(vh, none, vlo, Lt::OT, src + 2 * C, 0, 1, C3, k0, L, d);
  __syncthreads();
  auto issue = [&](int c) {
    const int r0 = c * RK, rows = L - r0 < RK ? L - r0 : RK;
    stream_rows(vb, raw, src, 0, 1, C3, r0, rows, d, DP);
    stream_rows(vb, raw + RK * DP, gsrc, 0, 1, C, r0, rows, d, DP);
    for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x) {
      const int part = i / rows, r = i - part * rows;
      attn_tc::copy_in<4>(sst + part * RK + r, st + part * L + r0 + r);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int n = 0; n < DP / 2; ++n) dk[n] = dv[n] = 0.f;
  for (int c = 0; c < nr; ++c) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();       // the chunk has landed; no wgmma reads the tiles any more
    split_row_tiles<DP, RK>(sm + Lt::R_OFF, raw);                              // Q
    split_row_tiles<DP, RK>(sm + Lt::R_OFF + NSL * 2 * Lt::RB, raw + RK * DP);  // dO
    split_col_tile<DP>(sm + Lt::C_OFF, raw);                                    // Q^T
    split_col_tile<DP>(sm + Lt::C_OFF + 2 * Lt::CB, raw + RK * DP);             // dO^T
    for (int i = threadIdx.x; i < 3 * RK; i += blockDim.x) sp[i] = sst[i];
    async_proxy_fence();
    __syncthreads();       // the tiles and statistics are whole; the stage is free
    if (c + 1 < nr) issue(c + 1);
    // S^T = K Q^T and dP^T = V dO^T over the chunk's queries (a warpgroup
    // wholly past L computes on zero rows and stores nothing)
    // (both groups in flight at once: S^T's is waited for first)
    float s[NV], dp[NV], s2[NV], dp2[NV];
    wg_issue<DP, true>(s, s2, kh, klo, sm + Lt::R_OFF);
    wg_issue<DP, true>(dp, dp2, vh, vlo, sm + Lt::R_OFF + NSL * 2 * Lt::RB);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
#pragma unroll
    for (int e = 0; e < NV; ++e) s[e] += s2[e];
    wg_wait0();
#pragma unroll
    for (int e = 0; e < NV; ++e) dp[e] += dp2[e];
    const bool all = c * RK + 16 < L;    // else the chunk's second 16 queries are past L
    // dv += P^T dO, P^T from the stored statistics, then dk += dS^T Q
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        p[e] = c * RK + r < L ? expf(s[4 * j + e] * scale - sp[r]) * sp[RK + r] : 0.f;
        s[4 * j + e] = p[e];
      }
      acc_fragment(p, ah[j], al[j]);
    }
    // each product of the chunk in a fresh accumulator (part), added to dv
    // and dk in f32, chunk by chunk in order
    float part[DP / 2];
    if (all)
      wg_times<DP, 4>(part, ah, al, sm + Lt::C_OFF + 2 * Lt::CB, 0);
    else
      wg_times<DP, 2>(part, ah, al, sm + Lt::C_OFF + 2 * Lt::CB, 0);
    wg_wait0();
#pragma unroll
    for (int n = 0; n < DP / 2; ++n) dv[n] += part[n];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        ds[e] = s[4 * j + e] * (dp[4 * j + e] - sp[2 * RK + r]);
      }
      acc_fragment(ds, ah[j], al[j]);
    }
    if (all)
      wg_times<DP, 4>(part, ah, al, sm + Lt::C_OFF, 0);
    else
      wg_times<DP, 2>(part, ah, al, sm + Lt::C_OFF, 0);
    wg_wait0();
#pragma unroll
    for (int n = 0; n < DP / 2; ++n) dk[n] += part[n];
  }
  float* out = dqkv + seq * L * C3 + C + (long long)h * d;
  store_acc<DP>(out, C3, dk, scale, k0, L, d);
  store_acc<DP>(out + C, C3, dv, 1.f, k0, L, d);
}

// ---------------------------------------------------------------------------
// d = 128 on mma.sync (the wgmma path's operands would not fit: a
// warpgroup's Q and dO lo tiles alone take 128 KB): a warp takes 16 rows,
// its two A operands unsplit in shared memory, a k-step's A fragment split
// once for the n8 tiles of a ring chunk of 16 rows (half a chunk of the
// statistics in pass A); each ring chunk is split once per CTA into TF32
// planes of B fragments, each lane's fragment one 16-byte load.
// ---------------------------------------------------------------------------

constexpr int MMA_RING = 16;

// 16-byte entries of one TF32 plane of `rows` rows of a head padded to dp:
// a (hi, hi, lo, lo) fragment for each lane, n8 tile and k-step.
__host__ __device__ constexpr int plane_entries(int rows, int dp) { return rows / 8 * (dp / 8) * 32; }

// Split ROWS rows of x ([row][row_stride(DP, 4)] floats) into a TF32 plane
// of B fragments, by the CTA's threads.  Rows layout (x^T as B, n = row, k
// = dim): entry [tile][k-step][lane] = (hi, hi, lo, lo) of x[8 tile +
// g][8 kk + t] and x[8 tile + g][8 kk + t + 4].  Columns layout (x as B, k
// = row, n = dim): entry [tile][n8 step][lane] of x[8 tile + 2t][8 nd + g]
// and x[8 tile + 2t + 1][8 nd + g] (the rows an accumulator fragment's
// columns 2t, 2t + 1 meet as k columns t, t + 4).  split() is tile_f32's,
// so a plane holds the bits the warps split before.
template <int DP, int ROWS, bool COLS>
__device__ __forceinline__ void split_plane(uint4* plane, const float* x) {
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8;
  for (int i = threadIdx.x; i < plane_entries(ROWS, DP); i += blockDim.x) {
    const int lane = i & 31, g = lane >> 2, t = lane & 3, f = i >> 5;
    const int ks = f % KS, tile = f / KS;
    const float* r = COLS ? x + (8 * tile + 2 * t) * STRIDE + 8 * ks + g
                          : x + (8 * tile + g) * STRIDE + 8 * ks + t;
    uint32_t h0, l0, h1, l1;
    split(r[0], h0, l0);
    split(r[COLS ? STRIDE : 4], h1, l1);
    plane[i] = make_uint4(h0, h1, l0, l1);
  }
}

// acc[I0 + i] = x y_i^T for N n8 tiles y_i of a rows plane, x a warp's
// 16-row tile in shared memory (unsplit): tile_f32's three TF32 products a
// k-step, hi*lo and lo*hi summed apart from hi*hi and added after the last
// k-step.  The k-step is the outer loop: x's A fragment ((g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4)) is split once for the N tiles.
template <int DP, int N, int I0, int M>
__device__ __forceinline__ void tile_products(float (&acc)[M][4], const float* x,
                                              const uint4* plane) {
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float small[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[I0 + i][e] = small[i][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk % 4 == 0) asm volatile("" ::: "memory");     // as fragment_times_plane's
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(x[(g + 8 * (e & 1)) * STRIDE + 8 * kk + t + 4 * (e >> 1)], ah[e], al[e]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint4 b = plane[(i * KS + kk) * 32 + lane];
      mma_tf32(small[i], al, b.x, b.y);
      mma_tf32(small[i], ah, b.z, b.w);
      mma_tf32(acc[I0 + i], ah, b.x, b.y);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[I0 + i][e] += small[i][e];
}

// acc (16 x DP fragments) += f z, f the 16 x 8 block of an accumulator
// fragment (its columns 2t, 2t + 1 as k columns t, t + 4, split as tile_f32
// splits p) and z one n8 tile of a columns plane: three TF32 products,
// lo*hi, hi*lo, hi*hi, into a fresh accumulator, then added to acc in f32
// (the tensor cores' accumulation truncates: summed over L rows in one
// accumulator it drifts past the bound at L = 1000).
template <int KS>
__device__ __forceinline__ void fragment_times_plane(float (&acc)[KS][4], const float (&f)[4],
                                                     const uint4* tile) {
  const int lane = threadIdx.x & 31;
  uint32_t ah[4], al[4];
  split(f[0], ah[0], al[0]);
  split(f[2], ah[1], al[1]);
  split(f[1], ah[2], al[2]);
  split(f[3], ah[3], al[3]);
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
    // a compiler barrier every 8 n8 steps: the loads of all 16 at d = 128
    // hoisted together would take 64 registers and spill
    if (nd % 8 == 0) asm volatile("" ::: "memory");
    const uint4 b = tile[nd * 32 + lane];
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(part, al, b.x, b.y);
    mma_tf32(part, ah, b.z, b.w);
    mma_tf32(part, ah, b.x, b.y);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] += part[e];
  }
}

// This warp's A operands, unsplit: rows row0.. of x0 and of x1 (row strides
// ld0, ld1; zeros past L and d) into ops ([32][row_stride(DP, 4)]: x0's 16
// rows, then x1's).
template <int DP>
__device__ __forceinline__ void load_operands(float* ops, const float* x0, long long ld0,
                                              const float* x1, long long ld1, int row0, int L,
                                              int d) {
  constexpr int STRIDE = row_stride(DP, 4);
  for (int i = threadIdx.x & 31; i < 16 * DP; i += 32) {
    const int r = i / DP, c = i - r * DP, row = row0 + r;
    const bool in = row < L && c < d;
    ops[r * STRIDE + c] = in ? x0[(long long)row * ld0 + c] : 0.f;
    ops[(16 + r) * STRIDE + c] = in ? x1[(long long)row * ld1 + c] : 0.f;
  }
  __syncwarp();
}

// Pass A on mma.sync: warp w of CTA blk takes queries (8 blk + w) * 16..
// Steps 0..nr - 1 sweep the ring chunks for the statistics, nr..2 nr - 1
// again for dq.
template <int DP>
__device__ __forceinline__ void stream_a_mma(const float* __restrict__ qkv,
                                             const float* __restrict__ dO,
                                             float* __restrict__ dqkv, float* __restrict__ stats,
                                             int L, int C, int H, int d, float scale, int blocks,
                                             int vb, unsigned char* smem_raw) {
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8, R = MMA_RING, RT = R / 8;
  constexpr int SPC = STREAM_KC / R;            // ring chunks a statistics chunk
  constexpr int PLANE = plane_entries(R, DP);
  uint4* krp = reinterpret_cast<uint4*>(smem_raw);    // K by rows,
  uint4* vrp = krp + PLANE;                           // V by rows,
  uint4* kcp = vrp + PLANE;                           // K by columns
  float* stage = reinterpret_cast<float*>(kcp + PLANE);   // K, V: [R][STRIDE] each
  const float* ops = stage + 2 * R * STRIDE + (threadIdx.x >> 5) * 2 * 16 * STRIDE;   // Q, dO
  const long long unit = blockIdx.x / blocks, seq = unit / H;
  const int blk = (int)(blockIdx.x - unit * blocks), h = (int)(unit - seq * H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row0 = blk * STREAM_WARPS * 16, q0 = row0 + warp * 16;
  const int C3 = 3 * C, nr = (L + STREAM_KC - 1) / STREAM_KC * SPC, steps = 2 * nr;
  const float* src = qkv + seq * L * C3 + (long long)h * d;    // the unit's q at token 0

  zero_smem(stage, 2 * R * STRIDE * 4 / 16);
  load_operands<DP>(const_cast<float*>(ops), src, C3, dO + seq * L * C + (long long)h * d, C, q0,
                    L, d);
  __syncthreads();
  auto issue = [&](int step) {
    const int k0 = (step < nr ? step : step - nr) * R;
    const int rows = L - k0 < R ? L - k0 : R;     // none past L
    stream_rows(vb, stage, src + C, 0, 1, C3, k0, rows, d, STRIDE);
    stream_rows(vb, stage + R * STRIDE, src + 2 * C, 0, 1, C3, k0, rows, d, STRIDE);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);

  float s[4][4], dp[4][4];     // the statistics chunk's four n8 key tiles: logits then e, dP
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, tot[2] = {0.f, 0.f};
  float inv[2], rt[2], acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // S and dP of the ring chunk at key k0 into tiles I0..I0 + RT - 1, keys
  // past L masked to -inf
  auto products = [&](auto i0, int k0) {
    constexpr int I0 = decltype(i0)::value;
    tile_products<DP, RT, I0>(s, ops, krp);
    tile_products<DP, RT, I0>(dp, ops + 16 * STRIDE, vrp);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[I0 + i][e] = k0 + 8 * i + 2 * t + (e & 1) < L ? s[I0 + i][e] * scale : -INFINITY;
  };
  // dq += scale-free dS K over the ring chunk's tiles
  auto dq_products = [&](auto i0) {
    constexpr int I0 = decltype(i0)::value;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = (expf(s[I0 + i][e] - mx[e >> 1]) * inv[e >> 1]) * (dp[I0 + i][e] - rt[e >> 1]);
      fragment_times_plane<KS>(acc, ds, kcp + i * KS * 32);
    }
  };
  using First = std::integral_constant<int, 0>;
  using Second = std::integral_constant<int, (SPC > 1 ? RT : 0)>;

  for (int step = 0; step < steps; ++step) {
    const bool dq_sweep = step >= nr;
    const int r = dq_sweep ? step - nr : step, k0 = r * R;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();       // the chunk has landed; every warp is done with the planes
    split_plane<DP, R, false>(krp, stage);
    split_plane<DP, R, false>(vrp, stage + R * STRIDE);
    if (dq_sweep) split_plane<DP, R, true>(kcp, stage);
    __syncthreads();       // the planes are whole; the stage is free
    if (step + 1 < steps) issue(step + 1);
    if (q0 >= L) continue;
    const bool first = SPC == 1 || r % SPC == 0;
    if (!dq_sweep) {
      if (first)
        products(First{}, k0);
      else
        products(Second{}, k0);
      if (r % SPC != SPC - 1) continue;
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[i][e]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float m = fmaxf(mx[q], quad_max(cm[q]));
        const float alpha = expf(mx[q] - m);     // 0 on the first chunk
        sum[q] *= alpha;
        tot[q] *= alpha;
        mx[q] = m;
      }
      float cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e] - mx[e >> 1]);
          cs[e >> 1] += s[i][e];
          ct[e >> 1] += s[i][e] * dp[i][e];
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        sum[q] += quad_sum(cs[q]);
        tot[q] += quad_sum(ct[q]);
      }
    } else {
      if (r == 0) {
        float* st = stats + unit * 3 * L;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          inv[q] = 1.f / sum[q];
          rt[q] = tot[q] * inv[q];
          const int row = q0 + gr + 8 * q;
          if (t == 0 && row < L) {
            st[row] = mx[q];
            st[L + row] = inv[q];
            st[2 * L + row] = rt[q];
          }
        }
      }
      if (first) {
        products(First{}, k0);
        dq_products(First{});
      } else {
        products(Second{}, k0);
        dq_products(Second{});
      }
    }
  }
  if (q0 < L) store_rows<KS>(dqkv + seq * L * C3 + (long long)h * d, C3, acc, scale, q0, L, d);
}

// Pass B on mma.sync: warp w of CTA blk takes keys (8 blk + w) * 16.., with
// pass A's statistics.
template <int DP>
__device__ __forceinline__ void stream_b_mma(const float* __restrict__ qkv,
                                             const float* __restrict__ dO,
                                             const float* __restrict__ stats,
                                             float* __restrict__ dqkv, int L, int C, int H, int d,
                                             float scale, int blocks, int vb,
                                             unsigned char* smem_raw) {
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8, R = MMA_RING, RT = R / 8;
  constexpr int PLANE = plane_entries(R, DP);
  uint4* qrp = reinterpret_cast<uint4*>(smem_raw);    // Q by rows,
  uint4* grp = qrp + PLANE;                           // dO by rows,
  uint4* qcp = grp + PLANE;                           // Q by columns,
  uint4* gcp = qcp + PLANE;                           // dO by columns
  float* sp = reinterpret_cast<float*>(gcp + PLANE);      // the chunk's m, 1 / l, t / l: [R] each
  float* stage = sp + 3 * R;                              // Q, dO: [R][STRIDE]; statistics: [3][R]
  float* sm = stage + 2 * R * STRIDE;
  const float* ops = sm + 3 * R + (threadIdx.x >> 5) * 2 * 16 * STRIDE;   // K, V
  const long long unit = blockIdx.x / blocks, seq = unit / H;
  const int blk = (int)(blockIdx.x - unit * blocks), h = (int)(unit - seq * H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = blk * STREAM_WARPS * 16, k0 = row0 + warp * 16;
  const int C3 = 3 * C, nr = (L + R - 1) / R;
  const float* src = qkv + seq * L * C3 + (long long)h * d;
  const float* gsrc = dO + seq * L * C + (long long)h * d;
  const float* st = stats + unit * 3 * L;

  zero_smem(sp, (6 * R + 2 * R * STRIDE) * 4 / 16);
  load_operands<DP>(const_cast<float*>(ops), src + C, C3, src + 2 * C, C3, k0, L, d);
  __syncthreads();
  // chunk c of Q, dO and the statistics
  auto issue = [&](int c) {
    const int r0 = c * R, rows = L - r0 < R ? L - r0 : R;
    stream_rows(vb, stage, src, 0, 1, C3, r0, rows, d, STRIDE);
    stream_rows(vb, stage + R * STRIDE, gsrc, 0, 1, C, r0, rows, d, STRIDE);
    for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x) {
      const int part = i / rows, r = i - part * rows;
      copy_in<4>(sm + part * R + r, st + part * L + r0 + r);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  for (int c = 0; c < nr; ++c) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();       // the chunk has landed; every warp is done with the planes
    split_plane<DP, R, false>(qrp, stage);
    split_plane<DP, R, false>(grp, stage + R * STRIDE);
    split_plane<DP, R, true>(qcp, stage);
    split_plane<DP, R, true>(gcp, stage + R * STRIDE);
    for (int i = threadIdx.x; i < 3 * R; i += blockDim.x) sp[i] = sm[i];
    __syncthreads();       // the planes and statistics are whole; the stage is free
    if (c + 1 < nr) issue(c + 1);
    if (k0 >= L) continue;
    // S^T = K Q^T and dP^T = V dO^T over the chunk's n8 query tiles, then
    // dv += P^T dO and dk += dS^T Q tile by tile
    float s[RT][4], dp[RT][4];
    tile_products<DP, RT, 0>(s, ops, qrp);
    tile_products<DP, RT, 0>(dp, ops + 16 * STRIDE, grp);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (c * R + 16 * (i / 2) >= L) break;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * i + 2 * t + (e & 1);
        p[e] = c * R + r < L ? expf(s[i][e] * scale - sp[r]) * sp[R + r] : 0.f;
        ds[e] = p[e] * (dp[i][e] - sp[2 * R + r]);
      }
      fragment_times_plane<KS>(dva, p, gcp + i * KS * 32);
      fragment_times_plane<KS>(dka, ds, qcp + i * KS * 32);
    }
  }
  if (k0 < L) {
    float* dk = dqkv + seq * L * C3 + C + (long long)h * d;
    store_rows<KS>(dk, C3, dka, scale, k0, L, d);
    store_rows<KS>(dk + C, C3, dva, 1.f, k0, L, d);
  }
}

// Bytes of a streamed CTA's shared memory (B: pass B): d = 64 WgTiles; d =
// 128 a ring chunk's TF32 planes (pass A: K by rows, V by rows, K by
// columns; pass B: Q and dO, each by rows and by columns), the ring's one
// stage (pass A: a K and a V chunk; pass B: a Q and a dO chunk, their rows'
// three statistics and a copy of them) and each warp's two A operands.
template <int DP, bool B> constexpr int stream_smem() {
  if constexpr (DP <= 64) {
    return WgTiles<DP, B>::SMEM;
  } else {
    constexpr int STRIDE = row_stride(DP, 4);
    return (B ? 4 : 3) * plane_entries(MMA_RING, DP) * 16 +
           (2 * MMA_RING * STRIDE + (B ? 6 * MMA_RING : 0)) * 4 +
           STREAM_WARPS * 2 * 16 * STRIDE * 4;
  }
}

// Pass A.  One CTA: query tiles (blockIdx.x % blocks) * STREAM_WARPS.. of
// unit blockIdx.x / blocks; stats: 3 L floats a unit (m, 1 / l, t / l).
template <int DP>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
attention_bwd_stream_a_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                              float* __restrict__ dqkv, float* __restrict__ stats, int L, int C,
                              int H, int d, float scale, int blocks, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DP <= 64)
    stream_a_wg<DP>(qkv, dO, dqkv, stats, L, C, H, d, scale, blocks, vb, smem_raw);
  else
    stream_a_mma<DP>(qkv, dO, dqkv, stats, L, C, H, d, scale, blocks, vb, smem_raw);
}

// Pass B.  One CTA: key tiles (blockIdx.x % blocks) * STREAM_WARPS.. of
// unit blockIdx.x / blocks, with pass A's statistics.
template <int DP>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
attention_bwd_stream_b_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                              const float* __restrict__ stats, float* __restrict__ dqkv, int L,
                              int C, int H, int d, float scale, int blocks, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DP <= 64)
    stream_b_wg<DP>(qkv, dO, stats, dqkv, L, C, H, d, scale, blocks, vb, smem_raw);
  else
    stream_b_mma<DP>(qkv, dO, stats, dqkv, L, C, H, d, scale, blocks, vb, smem_raw);
}

template <int DP>
cudaError_t launch_stream(const float* qkv, const float* dO, float* dqkv, float* stats,
                          long long seqs, int L, int C, int H, int d, float scale, int vb,
                          cudaStream_t stream) {
  if (stats == nullptr) return cudaErrorInvalidValue;
  const auto ka = attention_bwd_stream_a_kernel<DP>;
  const auto kb = attention_bwd_stream_b_kernel<DP>;
  constexpr int smem_a = stream_smem<DP, false>(), smem_b = stream_smem<DP, true>();
  static_assert(smem_a <= SMEM_MAX && smem_b <= SMEM_MAX, "a streamed CTA's shared memory");
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b)) !=
          cudaSuccess)
    return err;
  const int blocks = ((L + 15) / 16 + STREAM_WARPS - 1) / STREAM_WARPS;
  const long long grid = seqs * H * blocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ka<<<(unsigned)grid, STREAM_THREADS, smem_a, stream>>>(qkv, dO, dqkv, stats, L, C, H, d,
                                                          scale, blocks, vb);
  if ((err = counted(LAUNCH_ATTENTION_BWD_STREAM_A, cudaGetLastError())) != cudaSuccess)
    return err;
  kb<<<(unsigned)grid, STREAM_THREADS, smem_b, stream>>>(qkv, dO, stats, dqkv, L, C, H, d,
                                                          scale, blocks, vb);
  return counted(LAUNCH_ATTENTION_BWD_STREAM_B, cudaGetLastError());
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
  // 16-byte copies where every row and head start is 16-byte aligned
  const int vec = d % 4 == 0 && C % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dO) % 16 == 0;
  if (pack_takes(L, d)) {
    switch (wg_ksteps(d)) {
      case 4: return launch_pack<4, 3>(qkv, dO, dqkv, seqs, L, C, H, d, scale, vec, stream);
      case 5: return launch_pack<5, 2>(qkv, dO, dqkv, seqs, L, C, H, d, scale, vec, stream);
      default: return launch_pack<6, 2>(qkv, dO, dqkv, seqs, L, C, H, d, scale, vec, stream);
    }
  }
  if (wg_takes(L, d)) {
    switch (wg_ksteps(d)) {
      case 4: return launch_wg<4>(qkv, dO, dqkv, seqs, L, C, H, d, scale, vec, stream);
      case 5: return launch_wg<5>(qkv, dO, dqkv, seqs, L, C, H, d, scale, vec, stream);
      default: return launch_wg<6>(qkv, dO, dqkv, seqs, L, C, H, d, scale, vec, stream);
    }
  }
  const long long ub = unit_bytes(L, d);
  // U: the most units (U | H or H | U) in SMEM_TARGET
  int U = 1;
  for (int u = 2; u * ub <= SMEM_TARGET; ++u)
    if (H % u == 0 || u % H == 0) U = u;
  const int nkt = key_tiles(L), dp = padded_dim(d);
  const size_t smem = (size_t)(U * ub);
  return dp == 32   ? launch_dp<32>(nkt, qkv, dO, dqkv, seqs, L, C, H, d, scale, U, vb, smem,
                                    stream)
         : dp == 48 ? launch_dp<48>(nkt, qkv, dO, dqkv, seqs, L, C, H, d, scale, U, vb, smem,
                                    stream)
                    : launch_dp<64>(nkt, qkv, dO, dqkv, seqs, L, C, H, d, scale, U, vb, smem,
                                    stream);
}

}  // namespace
