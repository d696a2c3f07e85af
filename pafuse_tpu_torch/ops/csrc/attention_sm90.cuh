// The attention forward on the tensor cores: step 2 of block_chain.cuh
// (kernels #1, #3 and both halves of #4), step 2 of attention.cu (#2) and
// step 3 of block_train.cu's forward (#5), the last two in float32.  Built
// into one library only, attention_core.cu, whose pafuse_attention_core the
// other libraries call through its address and ops/attention_core.py calls
// alone.
//
// Replaces: the attention of pafuse_tpu/ops/attention.py::_block_body
// (:300-345, inside _block_kernel, _block_t_kernel and _layer_kernel), of
// _attention_kernel (attention.py:113-152, #2) and of
// pafuse_tpu/ops/block_grad.py::_fwd_core (#5), which the port ran on a
// scalar kernel (one CTA per (sequence, head), scalar FMAs) until the
// chains moved here and then #2 and #5.  Per (sequence, head), with
// _block_body's rounding points (no-ops in float32, the only dtype of #2's
// and #5's attention):
//
//   s = (q . k summed in f32) * d^-1/2    softmax over the whole row in f32
//   p = T(e / sum)                        after the row's full sum
//   o = T(sum_j p_j v_j)                  summed in f32
//
// qkv: (rows, 3C) in T with [q | k | v] blocks of C; out: (rows, C) in T.
// Token l of sequence s lives at row (s / S) * L * S + l * S + s % S (S = 1:
// contiguous sequences; S = N: the frames of each (b, joint) of a (B, F, N,
// C) activation, read in place by kernels #3 and #4).
//
// What bounds it on an H100 (data-sheet peaks at 700 W): 4*B*L^2*C
// operations against 4*B*L*C*sizeof(T) bytes (qkv read once, out written
// once), i.e. L operations a byte in bf16 and L / 2 in f32: at the chain's L
// <= 68 (134 for the monolithic model) far below the ~295 a byte where the
// tensor cores become the limit.  So it is bound by the bytes, and the
// design moves each byte once and keeps the arithmetic short:
//   - a CTA takes a group of U (sequence, head) units, U | H or H | U: U
//     heads of one sequence, or all heads of U / H sequences, so it reads
//     HG*d contiguous values of each token's q, k and v (whole rows when HG
//     = H).  Its threads copy them into shared memory with cp.async in the
//     operand type, 16 bytes a thread where d*sizeof(T) allows it (8, 4 or
//     2 otherwise), into one padded [token][DP + pad] tile a unit and part;
//     a thread keeps one vector position of every few rows, so its index
//     arithmetic is one division a row (64-bit divisions a vector made the
//     stage 2.6x slower).  U is as large as ~48 KB allow, so four CTAs
//     share an SM and one's copies overlap the others' arithmetic (two
//     buffers in a persistent CTA halve U at the same shared memory and
//     measured slower; PERF.md);
//   - a warp takes one (unit, 16-query block) tile at a time.  S = Q K^T on
//     mma.sync: bf16 as m16n8k16 with ldmatrix fragments; f32 as three TF32
//     m16n8k8 products hi*hi + hi*lo + lo*hi (x_hi = tf32(x), x_lo =
//     tf32(x - x_hi), as gemm_sm90.cuh splits them), the two small ones
//     summed apart from hi*hi and added in one FADD, since the tensor
//     cores' accumulation truncates.  A row's logits stay in registers,
//     16*NKT keys at a time: up to L = 144 all of them in one pass, beyond
//     it chunks of 64 keys in two passes (the row's max and sum over the
//     chunks, then the products);
//   - the softmax runs on the accumulator fragments, each row's max and sum
//     across its quad by shuffles; p = T(e * (1 / sum)) is repacked in
//     registers as the A operand of P V (bf16: two n8 tiles of S are one
//     k16 A fragment; f32: the keys of an n8 tile taken in the order
//     2t, 2t + 1 -> k columns t, t + 4, with V's rows read in that order),
//     V by ldmatrix.trans in bf16;
//   - O, rounded to T, goes into the tile's own q rows (only its warp reads
//     them), and the CTA writes its units' output rows with the vector
//     width of the copies.
// Padding: keys beyond L are masked to -inf (their v rows zeroed, so p = 0
// multiplies finite values), d is padded to DP in {32, 48, 64} with zeros in
// q and k, padded query rows are computed and dropped.  p = e * (1 /
// sum) differs from e / sum by at most one f32 ulp.
//
// Where one (sequence, head) does not fit a CTA's shared memory (L above
// 256 at d = 64 in float32, above 320 at d <= 48) or d is above 64, the
// streamed kernel below takes the unit instead, with the same arithmetic on
// key chunks that stream through shared memory; variant() is the rule.
//
// Everything launches on the caller's stream; nothing allocates.

#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

namespace attn_tc {

constexpr int THREADS = 128;
constexpr int SMEM_TARGET = 48 * 1024;    // a CTA's shared memory: 4 CTAs an SM
constexpr int SMEM_MAX = 227 * 1024;      // the most one CTA may have
constexpr int MAX_HEAD_DIM = 64;

// padded head size and key tiles (16 keys each) held in registers
__host__ __device__ constexpr int padded_dim(int d) { return d <= 32 ? 32 : d <= 48 ? 48 : 64; }
constexpr int CHUNK_TILES = 4;      // key tiles of a chunk beyond 144 keys
__host__ __device__ constexpr int key_tiles(int L) {
  return L <= 32 ? 2 : L <= 48 ? 3 : L <= 80 ? 5 : L <= 144 ? 9 : CHUNK_TILES;
}
// shared-memory row stride in elements: 16-byte rows whose 8 rows of an
// ldmatrix (bf16) or the 8 rows x 4 columns of a TF32 fragment (f32) fall in
// distinct banks
__host__ __device__ constexpr int row_stride(int dp, int size) { return dp + (size == 2 ? 8 : 4); }

// Shared memory of one (sequence, head): q, k and v tiles of LPa rows (L
// rounded up to the key chunk); 0 when d is above MAX_HEAD_DIM.
inline long long unit_bytes(int size, int L, int d) {
  if (d < 1 || d > MAX_HEAD_DIM || L < 1) return 0;
  const int kc = 16 * key_tiles(L);
  const long long lpa = (long long)((L + kc - 1) / kc) * kc;
  return 3LL * lpa * row_stride(padded_dim(d), size) * size;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy VB bytes: cp.async into shared memory (in), or shared to global (out).
template <int VB> __device__ __forceinline__ void copy_in(void* dst, const void* src) {
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(dst)), "l"(src)
                 : "memory");
  else if constexpr (VB >= 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(saddr(dst)), "l"(src),
                 "n"(VB)
                 : "memory");
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

template <int VB> __device__ __forceinline__ void copy_out(void* dst, const void* src) {
  if constexpr (VB == 16)
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  else if constexpr (VB == 8)
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  else if constexpr (VB == 4)
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

// One group of U (sequence, head) units from unit u0 on (unit u: sequence
// u / H, head u % H): all heads of G sequences, or HG = U heads of one.
struct Group {
  long long s0, q0;   // first sequence, s0 / S
  int r0, h0;         // s0 % S, first head
  int HG, G, L, S;    // heads a sequence, sequences, tokens, layout
  __device__ __forceinline__ Group(long long u0, int U, long long units, int H, int L_, int S_)
      : L(L_), S(S_) {
    const int n = (int)min((long long)U, units - u0);
    HG = U < H ? U : H;
    G = n / HG;
    s0 = u0 / H;
    h0 = (int)(u0 - s0 * H);
    q0 = s0 / S;
    r0 = (int)(s0 - q0 * S);
  }
  // the (local sequence, token) of row job rj: sequences outermost for S =
  // 1 (a sequence's rows are contiguous), tokens outermost otherwise (the G
  // sequences of a token are neighbouring rows)
  __device__ __forceinline__ void seq_tok(int rj, int& sl, int& l) const {
    if (S == 1) {
      sl = rj / L;
      l = rj - sl * L;
    } else {
      l = rj / G;
      sl = rj - l * G;
    }
  }
  __device__ __forceinline__ long long row(int sl, int l) const {
    if (S == 1) return (s0 + sl) * L + l;
    const int t = r0 + sl;
    return (q0 + t / S) * L * S + (long long)l * S + t % S;
  }
};

// Move a group's q, k, v into its shared-memory tiles (IN), or its output
// rows out of the q tiles (!IN), VB bytes a thread and step.  Each part of a
// token row is seg = HG*d*sizeof(T) / VB contiguous vectors: the threads
// are W x (blockDim / W) (W the power of two >= seg), a thread keeps its
// vector c of every (blockDim / W)-th row, and divides once a row.
template <bool IN, int VB, typename T>
__device__ __forceinline__ void move_rows(const Group& u, const T* qkv, T* out, T* sm, int C,
                                          int d, int lpa, int stride) {
  constexpr int EPV = VB / (int)sizeof(T);
  const int vph = d / EPV, seg = u.HG * vph;      // vectors a head row, a part
  int wbits = 0;
  while ((1 << wbits) < seg) ++wbits;
  const int nt = blockDim.x;
  const bool wide = (1 << wbits) >= nt;            // a row's vectors: all threads
  const int first = wide ? 0 : threadIdx.x >> wbits, step = wide ? 1 : nt >> wbits;
  const long long col0 = (long long)u.h0 * d;
  for (int c = threadIdx.x & ((1 << wbits) - 1); c < seg; c += nt) {
    const int hl = c / vph, e = (c - hl * vph) * EPV;
    for (int rj = first; rj < u.G * u.L; rj += step) {
      int sl, l;
      u.seq_tok(rj, sl, l);
      const long long row = u.row(sl, l);
      T* tile = sm + ((long long)((sl * u.HG + hl) * 3) * lpa + l) * stride + e;
      if constexpr (IN) {
        const T* src = qkv + row * 3 * C + col0 + hl * d + e;
#pragma unroll
        for (int part = 0; part < 3; ++part)
          copy_in<VB>(tile + (long long)part * lpa * stride, src + part * C);
      } else {
        copy_out<VB>(out + row * C + col0 + hl * d + e, tile);
      }
    }
  }
}

template <bool IN, typename T>
__device__ __forceinline__ void move_rows(int vb, const Group& u, const T* qkv, T* out, T* sm,
                                          int C, int d, int lpa, int stride) {
  switch (vb) {
    case 16: move_rows<IN, 16>(u, qkv, out, sm, C, d, lpa, stride); break;
    case 8: move_rows<IN, 8>(u, qkv, out, sm, C, d, lpa, stride); break;
    case 4: move_rows<IN, 4>(u, qkv, out, sm, C, d, lpa, stride); break;
    default: move_rows<IN, sizeof(T) == 2 ? 2 : 4>(u, qkv, out, sm, C, d, lpa, stride); break;
  }
}

// Zeros the copies do not write: columns d..DP of the L rows of the q and k
// tiles of n units (their products with each other must be 0), and v's rows
// L..lpa (p = 0 multiplies them).
template <typename T, int DP>
__device__ __forceinline__ void zero_pads(T* sm, int n, int L, int d, int lpa) {
  constexpr int STRIDE = row_stride(DP, (int)sizeof(T));
  if (d < DP)
    for (int i = threadIdx.x; i < n * 2 * L; i += blockDim.x) {
      const int ul = i / (2 * L), r = i - ul * 2 * L;
      T* row = sm + ((long long)(ul * 3 + r / L) * lpa + r % L) * STRIDE;
      for (int c = d; c < DP; ++c) row[c] = from_f32<T>(0.f);
    }
  constexpr int VPR = DP * (int)sizeof(T) / 16;     // 16-byte vectors a row
  const int pad = (lpa - L) * VPR;
  for (int i = threadIdx.x; i < n * pad; i += blockDim.x) {
    const int ul = i / pad, r = i - ul * pad;
    reinterpret_cast<uint4*>(sm + ((long long)(ul * 3 + 2) * lpa + L + r / VPR) * STRIDE)[r % VPR] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's (unit, 16-query block) tile in bf16: q the block's first row,
// k and v the unit's tiles; O (bf16) replaces the block's q rows.
template <int DP, int NKT>
__device__ __forceinline__ void tile_bf16(__nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, int L, int nc, float scale) {
  constexpr int STRIDE = row_stride(DP, 2), KC = 16 * NKT, KD = DP / 16, ND = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // this lane's row and column of the 8x8 matrices of an ldmatrix.x4: A
  // (and V transposed) as (rows 0-7, 8-15) x (cols 0-7, 8-15), K as (keys
  // 0-7: dims 0-7, 8-15), (keys 8-15: ...)
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = ((lane >> 4) & 1) * 8;
  const int br = (lane & 7) + ((lane >> 4) & 1) * 8, bc = ((lane >> 3) & 1) * 8;

  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) ldsm4(qa[kk], q + ar * STRIDE + kk * 16 + ac);

  float s[NKT][2][4];     // logits, then e: key tile j, n8 half, fragment
  auto logits = [&](int c) {
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][0][e] = s[j][1][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4];
        ldsm4(kb, k + (c * KC + 16 * j + br) * STRIDE + kk * 16 + bc);
        mma_bf16(s[j][0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j][1], qa[kk], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c * KC + 16 * j + 8 * n + 2 * t + (e & 1);
          s[j][n][e] = key < L ? s[j][n][e] * scale : -INFINITY;
        }
  };

  // beyond one chunk: the row's max and sum over the chunks, then the
  // products with the logits computed again
  const int chunks = NKT == CHUNK_TILES ? nc : 1;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};   // rows g, g + 8
  for (int c = 0; c < chunks; ++c) {
    logits(c);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(cm[r]));
      sum[r] *= expf(mx[r] - m);     // 0 on the first chunk
      mx[r] = m;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
          cs[e >> 1] += s[j][n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] += quad_sum(cs[r]);
  }

  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if constexpr (NKT == CHUNK_TILES) {
      logits(c);
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      // p rounded to bf16: the A fragment of keys 16j..16j+15
      const uint32_t pa[4] = {pack_bf16(s[j][0][0] * inv[0], s[j][0][1] * inv[0]),
                              pack_bf16(s[j][0][2] * inv[1], s[j][0][3] * inv[1]),
                              pack_bf16(s[j][1][0] * inv[0], s[j][1][1] * inv[0]),
                              pack_bf16(s[j][1][2] * inv[1], s[j][1][3] * inv[1])};
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t vb[4];
        ldsm4_t(vb, v + (c * KC + 16 * j + ar) * STRIDE + nn * 16 + ac);
        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(q + (g + 8 * r) * STRIDE + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
}

// The same tile in f32, each product as three TF32 products.
template <int DP, int NKT>
__device__ __forceinline__ void tile_f32(float* q, const float* k, const float* v, int L, int nc,
                                         float scale) {
  constexpr int STRIDE = row_stride(DP, 4), KC = 16 * NKT, KS = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // A fragments of Q: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split(q[(g + 8 * (i & 1)) * STRIDE + 8 * kk + t + 4 * (i >> 1)], qh[kk][i], ql[kk][i]);

  float s[NKT][2][4];
  auto logits = [&](int c) {
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int key0 = c * KC + 16 * j + 8 * n;
        float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          // B fragment of K^T: (dim t, key g), (dim t + 4, key g)
          const float* kr = k + (key0 + g) * STRIDE + 8 * kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split(kr[0], bh0, bl0);
          split(kr[4], bh1, bl1);
          mma_tf32(small, ql[kk], bh0, bh1);
          mma_tf32(small, qh[kk], bl0, bl1);
          mma_tf32(s[j][n], qh[kk], bh0, bh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 2 * t + (e & 1);
          s[j][n][e] = key < L ? (s[j][n][e] + small[e]) * scale : -INFINITY;
        }
      }
  };

  const int chunks = NKT == CHUNK_TILES ? nc : 1;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    logits(c);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(cm[r]));
      sum[r] *= expf(mx[r] - m);
      mx[r] = m;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
          cs[e >> 1] += s[j][n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] += quad_sum(cs[r]);
  }

  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if constexpr (NKT == CHUNK_TILES) {
      logits(c);
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
        // keys key0 + 2t and key0 + 2t + 1 as k columns t and t + 4
        const int key0 = c * KC + 16 * j + 8 * n;
        uint32_t ah[4], al[4];
        split(s[j][n][0] * inv[0], ah[0], al[0]);
        split(s[j][n][2] * inv[1], ah[1], al[1]);
        split(s[j][n][1] * inv[0], ah[2], al[2]);
        split(s[j][n][3] * inv[1], ah[3], al[3]);
        const float* vr = v + (key0 + 2 * t) * STRIDE + g;
#pragma unroll
        for (int nd = 0; nd < KS; ++nd) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vr[8 * nd], bh0, bl0);
          split(vr[8 * nd + STRIDE], bh1, bl1);
          mma_tf32(o[nd], al, bh0, bh1);
          mma_tf32(o[nd], ah, bl0, bl1);
          mma_tf32(o[nd], ah, bh0, bh1);
        }
      }
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(q + (g + 8 * r) * STRIDE + 8 * n + 2 * t) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
}

// One CTA: the group of U units from unit blockIdx.x * U on.  nc key chunks
// of 16 * NKT keys; vb the copy width in bytes.
template <typename T, int DP, int NKT>
__global__ void __launch_bounds__(THREADS)
attention_tc_kernel(const T* __restrict__ qkv, T* __restrict__ out, long long seqs, int L,
                    int S, int C, int H, int d, float scale, int U, int nc, int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int STRIDE = row_stride(DP, (int)sizeof(T));
  const int lpa = nc * 16 * NKT, qbs = (L + 15) / 16;
  const Group u((long long)blockIdx.x * U, U, seqs * H, H, L, S);
  const int n = u.G * u.HG;

  move_rows<true>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);
  zero_pads<T, DP>(sm, n, L, d, lpa);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int tile = threadIdx.x >> 5; tile < n * qbs; tile += blockDim.x >> 5) {
    const int ul = tile / qbs, qb = tile - ul * qbs;
    T* qt = sm + (long long)ul * 3 * lpa * STRIDE;
    if constexpr (sizeof(T) == 2)
      tile_bf16<DP, NKT>(qt + qb * 16 * STRIDE, qt + lpa * STRIDE, qt + 2 * lpa * STRIDE, L, nc,
                         scale);
    else
      tile_f32<DP, NKT>(qt + qb * 16 * STRIDE, qt + lpa * STRIDE, qt + 2 * lpa * STRIDE, L, nc,
                        scale);
  }
  __syncthreads();
  move_rows<false>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);
}

// The kernel's arguments and its shared memory.
template <typename T> struct Launch {
  const T* qkv;
  T* out;
  long long seqs;
  int L, S, C, H, d;
  float scale;
  int U, nc, vb;
  size_t smem;
};

template <typename T, int DP, int NKT>
cudaError_t launch(const Launch<T>& a, cudaStream_t stream) {
  const auto kernel = attention_tc_kernel<T, DP, NKT>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  const long long grid = (a.seqs * a.H + a.U - 1) / a.U;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, THREADS, a.smem, stream>>>(a.qkv, a.out, a.seqs, a.L, a.S, a.C,
                                                      a.H, a.d, a.scale, a.U, a.nc, a.vb);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dp(int nkt, const Launch<T>& a, cudaStream_t stream) {
  switch (nkt) {
    case 2: return launch<T, DP, 2>(a, stream);
    case 3: return launch<T, DP, 3>(a, stream);
    case CHUNK_TILES: return launch<T, DP, CHUNK_TILES>(a, stream);
    case 5: return launch<T, DP, 5>(a, stream);
    default: return launch<T, DP, 9>(a, stream);
  }
}

// ---------------------------------------------------------------------------
// The streamed forward, for the units the resident kernel above does not
// take: a head size above 64 (up to MAX_STREAM_DIM), or one unit's q, k and
// v beyond a CTA's shared memory.  Nothing of a unit stays resident: a CTA
// takes STREAM_WARPS 16-query tiles of one (sequence, head), one a warp,
// and streams the unit's keys through shared memory in chunks of STREAM_KC
// (CHUNK_TILES key tiles), K and V in a two-stage cp.async ring: pass 1 over
// K gives each row's max and sum, pass 2 over K and V computes the logits
// again and sums p = T(e * (1 / sum)) times V.  Its arithmetic is the
// resident kernel's chunked path (beyond 144 keys) step for step, so where
// both take a shape they give the same bits; p is rounded only after the
// row's full sum (no online rescaling of the output).
//   - Q's A fragments come from global memory once (zeros past L and d):
//     in registers for bf16 and for float32 up to d = 64; for float32 d >
//     64 their TF32 halves would not fit beside the output fragments, so
//     each warp splits Q once into shared memory in fragment order (one
//     16-byte read a lane, a k-step and a half) and reads them from there;
//   - d is padded to 64 or 128: K's padded columns are zeros (the ring is
//     zeroed once and the copies never write them), keys past L are masked
//     to -inf (V's rows there hold zeros or an earlier chunk's rows, which
//     p = 0 multiplies);
//   - the output goes from the fragments straight to global memory.
// Per unit it reads K twice and V once from L2 for each of its
// ceil(L / 64) CTAs: the bytes bound of the whole call still counts qkv
// once.
// ---------------------------------------------------------------------------

constexpr int MAX_STREAM_DIM = 128;
constexpr int STREAM_WARPS = THREADS / 32;          // 16-query tiles a CTA
constexpr int STREAM_KC = 16 * CHUNK_TILES;         // keys a chunk

__host__ __device__ constexpr int stream_dim(int d) { return d <= 64 ? 64 : 128; }

// 1: the resident kernel takes (L, d); 2: the streamed one; 0: neither (L
// < 1, or d outside 1..MAX_STREAM_DIM).
inline int variant(int size, int L, int d) {
  if (L < 1 || d < 1 || d > MAX_STREAM_DIM) return 0;
  const long long ub = unit_bytes(size, L, d);
  return ub != 0 && ub <= SMEM_MAX ? 1 : 2;
}

// Shared memory of a streamed CTA: the ring's two stages of a K and a V
// chunk, and for float32 d > 64 the warps' Q halves.
__host__ __device__ constexpr int stream_smem(int size, int dp) {
  return 2 * 2 * STREAM_KC * row_stride(dp, size) * size +
         (size == 4 && dp > 64 ? STREAM_WARPS * (dp / 8) * 2 * 32 * 16 : 0);
}

// Copy rows k0.. (rows of them) of one part of a unit into dst ([row][stride]),
// VB bytes a thread and step: row r from src + (base + (k0 + r) * S) * ld,
// its first d values.
template <int VB, typename T>
__device__ __forceinline__ void stream_rows(T* dst, const T* src, long long base, int S,
                                            int ld, int k0, int rows, int d, int stride) {
  constexpr int EPV = VB / (int)sizeof(T);
  const int vph = d / EPV;
  for (int i = threadIdx.x; i < rows * vph; i += blockDim.x) {
    const int r = i / vph, e = (i - r * vph) * EPV;
    copy_in<VB>(dst + r * stride + e, src + (base + (long long)(k0 + r) * S) * ld + e);
  }
}

template <typename T>
__device__ __forceinline__ void stream_rows(int vb, T* dst, const T* src, long long base, int S,
                                            int ld, int k0, int rows, int d, int stride) {
  switch (vb) {
    case 16: stream_rows<16>(dst, src, base, S, ld, k0, rows, d, stride); break;
    case 8: stream_rows<8>(dst, src, base, S, ld, k0, rows, d, stride); break;
    case 4: stream_rows<4>(dst, src, base, S, ld, k0, rows, d, stride); break;
    default:
      stream_rows<sizeof(T) == 2 ? 2 : 4>(dst, src, base, S, ld, k0, rows, d, stride);
      break;
  }
}

// Zero n16 16-byte words of shared memory from p.
__device__ __forceinline__ void zero_smem(void* p, int n16) {
  uint4* z = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
}

// One warp's 16-query tile across the chunks, bf16: tile_bf16's arithmetic
// with K and V in the ring's current stage.
template <int DP> struct StreamBf16 {
  static constexpr int STRIDE = row_stride(DP, 2), KD = DP / 16, ND = DP / 8, NKT = CHUNK_TILES;
  uint32_t qa[KD][4];
  float s[NKT][2][4], o[ND][4], mx[2], sum[2], inv[2];

  // Q's fragments (rows q0.., zeros past L and d) from the unit's q columns
  // at token 0 (row r at q + (base + r * S) * ld).
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, long long base, int S, int ld,
                                         int q0, int L, int d, uint4*) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint16_t* qb = reinterpret_cast<const uint16_t*>(q);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + g + 8 * (i & 1), col = 16 * kk + 2 * t + 8 * (i >> 1);
        const uint16_t* p = qb + (base + (long long)row * S) * ld + col;
        const uint32_t lo = row < L && col < d ? p[0] : 0u;
        const uint32_t hi = row < L && col + 1 < d ? p[1] : 0u;
        qa[kk][i] = lo | hi << 16;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = -INFINITY;
      sum[r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // the logits of keys k0.. (the chunk at k), masked past L
  __device__ __forceinline__ void logits(const __nv_bfloat16* k, int k0, int L, float scale) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int br = (lane & 7) + ((lane >> 4) & 1) * 8, bc = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][0][e] = s[j][1][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4];
        ldsm4(kb, k + (16 * j + br) * STRIDE + kk * 16 + bc);
        mma_bf16(s[j][0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j][1], qa[kk], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 16 * j + 8 * n + 2 * t + (e & 1);
          s[j][n][e] = key < L ? s[j][n][e] * scale : -INFINITY;
        }
  }

  // pass 1: the rows' max and sum over one more chunk
  __device__ __forceinline__ void stats(const __nv_bfloat16* k, int k0, int L, float scale) {
    logits(k, k0, L, scale);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(cm[r]));
      sum[r] *= expf(mx[r] - m);     // 0 on the first chunk
      mx[r] = m;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
          cs[e >> 1] += s[j][n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] += quad_sum(cs[r]);
  }

  // pass 2: O += T(p) V over one chunk (K at k, V at v)
  __device__ __forceinline__ void products(const __nv_bfloat16* k, const __nv_bfloat16* v, int k0,
                                           int L, float scale) {
    const int lane = threadIdx.x & 31;
    const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = ((lane >> 4) & 1) * 8;
    if (k0 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / sum[r];
    logits(k, k0, L, scale);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[j][0][0] * inv[0], s[j][0][1] * inv[0]),
                              pack_bf16(s[j][0][2] * inv[1], s[j][0][3] * inv[1]),
                              pack_bf16(s[j][1][0] * inv[0], s[j][1][1] * inv[0]),
                              pack_bf16(s[j][1][2] * inv[1], s[j][1][3] * inv[1])};
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t vb[4];
        ldsm4_t(vb, v + (16 * j + ar) * STRIDE + nn * 16 + ac);
        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // rows q0.. (< L), columns < d of the unit's output at out (row r at
  // out + (base + r * S) * ld); vo: two values a store
  __device__ __forceinline__ void store(__nv_bfloat16* out, long long base, int S, int ld, int q0,
                                        int L, int d, int vo) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row >= L) continue;
      __nv_bfloat16* y = out + (base + (long long)row * S) * ld;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = 8 * n + 2 * t;
        const __nv_bfloat162 h = __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
        if (vo) {
          if (col < d) *reinterpret_cast<__nv_bfloat162*>(y + col) = h;
        } else {
          if (col < d) y[col] = h.x;
          if (col + 1 < d) y[col + 1] = h.y;
        }
      }
    }
  }
};

// The same in float32: tile_f32's arithmetic, each product as three TF32
// products; Q's halves in registers, or (QS, d > 64) in shared memory.
template <int DP> struct StreamF32 {
  static constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8, NKT = CHUNK_TILES;
  static constexpr bool QS = DP > 64;
  uint32_t qh[QS ? 1 : KS][4], ql[QS ? 1 : KS][4];
  const uint4* qf;          // QS: this warp's halves, [k-step][hi, lo][lane]
  float s[NKT][2][4], o[KS][4], mx[2], sum[2], inv[2];

  __device__ __forceinline__ void load_q(const float* q, long long base, int S, int ld, int q0,
                                         int L, int d, uint4* frag) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + g + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
        split(row < L && col < d ? q[(base + (long long)row * S) * ld + col] : 0.f, h[i], l[i]);
      }
      if constexpr (QS) {
        frag[2 * kk * 32 + lane] = make_uint4(h[0], h[1], h[2], h[3]);
        frag[(2 * kk + 1) * 32 + lane] = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qh[kk][i] = h[i];
          ql[kk][i] = l[i];
        }
      }
    }
    qf = frag;
    if constexpr (QS) __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = -INFINITY;
      sum[r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  __device__ __forceinline__ void logits(const float* k, int k0, int L, float scale) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int key0 = 16 * j + 8 * n;
        float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ah[4], al[4];
          if constexpr (QS) {
            const uint4 h = qf[2 * kk * 32 + lane], l = qf[(2 * kk + 1) * 32 + lane];
            ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
            al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = qh[kk][i];
              al[i] = ql[kk][i];
            }
          }
          const float* kr = k + (key0 + g) * STRIDE + 8 * kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split(kr[0], bh0, bl0);
          split(kr[4], bh1, bl1);
          mma_tf32(small, al, bh0, bh1);
          mma_tf32(small, ah, bl0, bl1);
          mma_tf32(s[j][n], ah, bh0, bh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + key0 + 2 * t + (e & 1);
          s[j][n][e] = key < L ? (s[j][n][e] + small[e]) * scale : -INFINITY;
        }
      }
  }

  __device__ __forceinline__ void stats(const float* k, int k0, int L, float scale) {
    logits(k, k0, L, scale);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
    float cs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(cm[r]));
      sum[r] *= expf(mx[r] - m);
      mx[r] = m;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
          cs[e >> 1] += s[j][n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] += quad_sum(cs[r]);
  }

  __device__ __forceinline__ void products(const float* k, const float* v, int k0, int L,
                                           float scale) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    if (k0 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / sum[r];
    logits(k, k0, L, scale);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        // keys 2t and 2t + 1 of the n8 tile as k columns t and t + 4
        uint32_t ah[4], al[4];
        split(s[j][n][0] * inv[0], ah[0], al[0]);
        split(s[j][n][2] * inv[1], ah[1], al[1]);
        split(s[j][n][1] * inv[0], ah[2], al[2]);
        split(s[j][n][3] * inv[1], ah[3], al[3]);
        const float* vr = v + (16 * j + 8 * n + 2 * t) * STRIDE + g;
#pragma unroll
        for (int nd = 0; nd < KS; ++nd) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vr[8 * nd], bh0, bl0);
          split(vr[8 * nd + STRIDE], bh1, bl1);
          mma_tf32(o[nd], al, bh0, bh1);
          mma_tf32(o[nd], ah, bl0, bl1);
          mma_tf32(o[nd], ah, bh0, bh1);
        }
      }
  }

  __device__ __forceinline__ void store(float* out, long long base, int S, int ld, int q0, int L,
                                        int d, int vo) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row >= L) continue;
      float* y = out + (base + (long long)row * S) * ld;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int col = 8 * n + 2 * t;
        if (vo) {
          if (col < d) *reinterpret_cast<float2*>(y + col) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
        } else {
          if (col < d) y[col] = o[n][2 * r];
          if (col + 1 < d) y[col + 1] = o[n][2 * r + 1];
        }
      }
    }
  }
};

template <typename T, int DP>
using StreamTile = typename std::conditional<sizeof(T) == 2, StreamBf16<DP>, StreamF32<DP>>::type;

// One CTA: query tiles (blockIdx.x % qblocks) * STREAM_WARPS.. of unit
// blockIdx.x / qblocks (sequence u / H, head u % H), rows laid out with S as
// attention_tc_kernel's; vb the copy width in bytes, vo as StreamBf16::store.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attention_stream_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int S, int C,
                        int H, int d, float scale, int qblocks, int vb, int vo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int STRIDE = row_stride(DP, (int)sizeof(T)), STAGE = 2 * STREAM_KC * STRIDE;
  T* ring = reinterpret_cast<T*>(smem_raw);
  const long long unit = blockIdx.x / qblocks, seq = unit / H;
  const int qblock = (int)(blockIdx.x - unit * qblocks), h = (int)(unit - seq * H);
  const int warp = threadIdx.x >> 5, q0 = (qblock * STREAM_WARPS + warp) * 16;
  const int C3 = 3 * C, nc = (L + STREAM_KC - 1) / STREAM_KC;
  const long long base = seq / S * L * S + seq % S;    // token l at row base + l * S
  const T* src = qkv + (long long)h * d;

  zero_smem(smem_raw, stream_smem((int)sizeof(T), DP) / 16);
  __syncthreads();
  // step i < nc: chunk i of K (pass 1); step nc + i: chunk i of K and V
  auto issue = [&](int step) {
    const int k0 = (step < nc ? step : step - nc) * STREAM_KC;
    const int rows = L - k0 < STREAM_KC ? L - k0 : STREAM_KC;
    T* stage = ring + (step & 1) * STAGE;
    stream_rows(vb, stage, src + C, base, S, C3, k0, rows, d, STRIDE);
    if (step >= nc)
      stream_rows(vb, stage + STREAM_KC * STRIDE, src + 2 * C, base, S, C3, k0, rows, d, STRIDE);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  StreamTile<T, DP> tile;
  tile.load_q(src, base, S, C3, q0, L, d,
              reinterpret_cast<uint4*>(smem_raw + 2 * STAGE * sizeof(T)) + warp * (DP / 8) * 64);
  issue(0);
  for (int step = 0; step < 2 * nc; ++step) {
    if (step + 1 < 2 * nc) {
      issue(step + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const T* k = ring + (step & 1) * STAGE;
    if (q0 < L) {
      if (step < nc)
        tile.stats(k, step * STREAM_KC, L, scale);
      else
        tile.products(k, k + STREAM_KC * STRIDE, (step - nc) * STREAM_KC, L, scale);
    }
    __syncthreads();       // every warp is done with this stage before it refills
  }
  if (q0 < L) tile.store(out + (long long)h * d, base, S, C, q0, L, d, vo);
}

// Launches of attention_stream_kernel in this library, counted on the host
// where they happen: pafuse_attention_core_stream_launches reads them, so
// a caller can tell that a path went through the streamed kernel.
std::atomic<long long> stream_launches{0};

template <typename T, int DP>
cudaError_t launch_stream(const T* qkv, T* out, long long seqs, int L, int S, int C, int H,
                          int d, float scale, int vb, cudaStream_t stream) {
  const auto kernel = attention_stream_kernel<T, DP>;
  constexpr int smem = stream_smem((int)sizeof(T), DP);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int qblocks = ((L + 15) / 16 + STREAM_WARPS - 1) / STREAM_WARPS;
  const long long grid = seqs * H * qblocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vo = d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(qkv, out, L, S, C, H, d, scale, qblocks,
                                                     vb, vo);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) stream_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace attn_tc

// seqs sequences of L tokens, laid out with S as above (S = 1: contiguous):
// the resident kernel where it takes (L, d = C / H), else the streamed one;
// cudaErrorInvalidValue for a shape neither takes (d above MAX_STREAM_DIM).
template <typename T>
cudaError_t launch_attention_tc(const T* qkv, T* out, long long seqs, int L, int C, int H,
                                float scale, cudaStream_t stream, int S = 1) {
  using namespace attn_tc;
  if (seqs == 0) return cudaSuccess;
  if (seqs < 0 || H < 1 || C % H || S < 1) return cudaErrorInvalidValue;
  const int d = C / H, size = (int)sizeof(T);
  const int route = variant(size, L, d);
  if (route == 0) return cudaErrorInvalidValue;
  // the copy width: the largest of 16, 8, 4, 2 bytes that divides a head
  // row, the row strides and both pointers
  const unsigned long long bits = (unsigned long long)(d * size) |
                                  (unsigned long long)(C * size) |
                                  reinterpret_cast<uintptr_t>(qkv) |
                                  reinterpret_cast<uintptr_t>(out);
  const unsigned long long low = bits & (~bits + 1);
  const int vb = (int)(low < 16 ? low : 16);
  if (route == 2)
    return stream_dim(d) == 64 ? launch_stream<T, 64>(qkv, out, seqs, L, S, C, H, d, scale, vb,
                                                      stream)
                               : launch_stream<T, 128>(qkv, out, seqs, L, S, C, H, d, scale,
                                                       vb, stream);
  const long long ub = unit_bytes(size, L, d);
  // U: the most units (U | H or H | U) in SMEM_TARGET
  int U = 1;
  for (int u = 2; u * ub <= SMEM_TARGET; ++u)
    if (H % u == 0 || u % H == 0) U = u;
  const int nkt = key_tiles(L), kc = 16 * nkt;
  const Launch<T> a{qkv, out, seqs, L, S, C, H, d, scale, U, (L + kc - 1) / kc, vb,
                    (size_t)(U * ub)};
  switch (padded_dim(d)) {
    case 32: return launch_dp<T, 32>(nkt, a, stream);
    case 48: return launch_dp<T, 48>(nkt, a, stream);
    default: return launch_dp<T, 64>(nkt, a, stream);
  }
}

}  // namespace
