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
// <= 68 below the ~49 a byte (165 TFLOP/s for float32 as three TF32
// products, 3.35 TB/s) and the ~295 (bf16) where the tensor cores become the
// limit, so the bound is the bytes.  On the card, though, float32 meets
// mma.sync's TF32 rate first: ~112 TFLOP/s, 23% of the 495 of wgmma
// (experiments/attention_fwd/run.py's `nomma` tree on an H100 80GB HBM3 at
// 700 W: taking the 9.6 M m16n8k8 products out of H3WB's face stage saves
// 0.176 of its 0.271 ms), so at 68 keys the products alone take twice the
// bytes' time (the face's stage at serve bucket 16: ~1.37 ms of products
// against a 0.63 ms bound), at 24-42 keys 60-90% of it.  The design moves
// each byte once and keeps the products' issue dense:
//   - a CTA takes a group of U (sequence, head) units, U | H or H | U: U
//     heads of one sequence, or all heads of U / H sequences, so it reads
//     HG*d contiguous values of each token's q, k and v (whole rows when HG
//     = H).  Its threads copy them into shared memory with cp.async in the
//     operand type, 16 bytes a thread where d*sizeof(T) allows it (8, 4 or
//     2 otherwise), into one padded [token][DP + pad] tile a unit and part;
//     a thread keeps one vector position of every few rows, so its index
//     arithmetic is one division a row (64-bit divisions a vector made the
//     stage 2.6x slower).  U is as large as ~48 KB allow, so several CTAs
//     share an SM and one's copies overlap the others' arithmetic;
//   - a warp takes one (unit, 16-query block) tile at a time (float32: a
//     CTA of as many warps as its group has tiles, at most f32_warps).  S =
//     Q K^T on mma.sync: bf16 as m16n8k16 with ldmatrix fragments; f32 as
//     three TF32 m16n8k8 products hi*hi + hi*lo + lo*hi (x_hi = tf32(x),
//     x_lo = tf32(x - x_hi), as gemm_sm90.cuh splits them), the two small
//     ones summed apart from hi*hi and added in one FADD, since the tensor
//     cores' accumulation truncates.  A row's logits stay in registers,
//     16*NKT keys at a time: up to L = 144 all of them in one pass, beyond
//     it chunks of 64 keys in two passes (the row's max and sum over the
//     chunks, then the products).  Float32 skips the last n8 tile of keys
//     where it lies wholly past L (the kernel's DEAD argument: 24 of 32
//     keys, 17 of 32, 68 of 80), whose logits would be -inf and whose p
//     exact zeros, so the bits are those of the tile computed;
//   - the softmax runs on the accumulator fragments, each row's max and sum
//     across its quad by shuffles; p = T(e * (1 / sum)) is repacked in
//     registers as the A operand of P V (bf16: two n8 tiles of S are one
//     k16 A fragment; f32: the keys of an n8 tile taken in the order
//     2t, 2t + 1 -> k columns t, t + 4, with V's rows read in that order),
//     V by ldmatrix.trans in bf16;
//   - bf16: O, rounded to T, goes into the tile's own q rows (only its warp
//     reads them), and the CTA writes its units' output rows with the
//     vector width of the copies after a second barrier; float32: each lane
//     stores its output fragments straight to global memory (two values a
//     store where d is even), with no pass through shared memory and no
//     second barrier.
// Float32, the stage of kernels #1-#5 (experiments/attention_fwd/run.py,
// H100 80GB HBM3 at 700 W).  What the former design (the same products,
// every warp of a 4-warp CTA, the output through the q tiles) spent at #1's
// six bucket-16 stages: its products 44% of 5.99 ms, K and V's TF32 splits
// 20% (each warp split them again for its tile), the copies in 16%, the
// output pass 15%, expf 6%, Q's splits 5% (each taken out in a tree of its
// own; the shares overlap).  Measured against it and dropped: persistent
// CTAs with a producer warp filling a ring of groups completed on
// mbarriers (cp.async by one warp: the copies' issue bound it, 1.6-2x
// slower at 24-27 keys; by four: as fast as the former design, its
// consumer warps alone 4.8 ms; cp.async.bulk a (token, part, head) row:
// ~70 cycles a copy an SM, 3x slower); two query tiles a warp (spills, or
// too few warps to hide mma.sync's latency); 5-8 warps a CTA at 68 keys;
// launch bounds of one CTA an SM (no spills, more registers: 12% slower).
// This design: 5.26-5.30 ms against 5.95-5.98 (-12%), 1.84 ms at the face.
// Padding: keys beyond L are masked to -inf (their v rows zeroed, so p = 0
// multiplies finite values), d is padded to DP in {32, 48, 64} with zeros in
// q and k, padded query rows are computed and dropped.  p = e * (1 /
// sum) differs from e / sum by at most one f32 ulp.
//
// Where one (sequence, head) does not fit a CTA's shared memory (float32 L
// above 512 at d <= 32) or d is above 64, in float32 past 144 keys at d =
// 33..64 and in bf16 past 144 keys at any d, the streamed kernel below
// takes the unit instead, with the same rounding points on key chunks that
// stream through shared memory; variant() is the rule.  (The chunked path
// here, past 144 keys, is left to float32 at d <= 32, where the streamed
// kernel pads d to 64.)
//
// Everything launches on the caller's stream; nothing allocates.

#pragma once

#include <cuda.h>
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

// One CTA of the bf16 kernel: the group of U units from unit blockIdx.x * U
// on.  nc key chunks of 16 * NKT keys; vb the copy width in bytes.
template <typename T, int DP, int NKT>
__global__ void __launch_bounds__(THREADS)
attention_tc_kernel(const T* __restrict__ qkv, T* __restrict__ out, long long seqs, int L,
                    int S, int C, int H, int d, float scale, int U, int nc, int vb) {
  static_assert(sizeof(T) == 2, "float32 runs on the overload below");
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
    tile_bf16<DP, NKT>(qt + qb * 16 * STRIDE, qt + lpa * STRIDE, qt + 2 * lpa * STRIDE, L, nc,
                       scale);
  }
  __syncthreads();
  move_rows<false>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);
}

// The bf16 kernel's arguments and its shared memory.
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
  using Fn = void (*)(const T*, T*, long long, int, int, int, int, int, float, int, int, int);
  const Fn kernel = attention_tc_kernel<T, DP, NKT>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  const long long grid = (a.seqs * a.H + a.U - 1) / a.U;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, THREADS, a.smem, stream>>>(a.qkv, a.out, a.seqs, a.L, a.S, a.C,
                                                      a.H, a.d, a.scale, a.U, a.nc, a.vb);
  return counted(LAUNCH_ATTENTION_TC, cudaGetLastError());
}

template <typename T, int DP>
cudaError_t launch_dp(int nkt, const Launch<T>& a, cudaStream_t stream) {
  switch (nkt) {
    case 2: return launch<T, DP, 2>(a, stream);
    case 3: return launch<T, DP, 3>(a, stream);
    case 5: return launch<T, DP, 5>(a, stream);
    case 9: return launch<T, DP, 9>(a, stream);
    default: return cudaErrorInvalidValue;    // past 144 keys bf16 streams (variant())
  }
}

// The float32 kernel's most warps a CTA: 4 (a CTA's tiles beyond them
// wait a round; 5 or 8 warps, fewer CTAs an SM, measured slower at 68
// keys), 8 on the chunked path (16 tiles a 243-token unit: 0.184 against
// 0.207 ms at 4 warps, (64, 243, 224)).
__host__ __device__ constexpr int f32_warps(int nkt) { return nkt == CHUNK_TILES ? 8 : 4; }

// ---------------------------------------------------------------------------
// The streamed forward, for the units the resident kernel above does not
// take: a head size above 64 (up to MAX_STREAM_DIM), or one unit's q, k and
// v beyond a CTA's shared memory.  Nothing of a unit stays resident: a CTA
// takes a block of queries of one (sequence, head) and streams the unit's
// keys through shared memory in ring chunks: pass 1 over K gives each row's
// max and sum over chunks of STREAM_KC keys, pass 2 over K and V computes
// the logits again and sums p = T(e * (1 / sum)) times V.  p is rounded
// only after the row's full sum (no online rescaling of the output), the
// TPU kernel's rounding point, which is why the logits are computed twice.
// Its arithmetic is the resident kernel's chunked path (beyond 144 keys)
// product for product, so where both take a shape they give the same bits.
//
// What bounds it on an H100 (data-sheet peaks at 700 W): 4*B*L^2*C
// operations, at 165 TFLOP/s for float32 done as three TF32 products and
// 989 TFLOP/s for bf16, against qkv read once and the output written once:
// at L >= 134 the operations.  Float32 (stream_f32) runs on wgmma, the
// only way to the tensor cores' full rate (mma.sync is not):
//   - a CTA is two warpgroups of 64 queries; Q's A fragments sit in
//     registers split into TF32 halves (at d = 128 the lo halves in shared
//     tiles: all of them would not fit beside O);
//   - each ring chunk of 64 keys (32 at d = 128, where shared memory
//     allows no more), once it lands (cp.async), is split once per CTA
//     into K-major TF32 tiles in wgmma's 128-byte-swizzled layout: K by
//     rows (the B of S = Q K^T) and V transposed (the B of P V, its keys
//     in the order the repacked p meets them).  No warp splits K or V;
//   - S's three products (m64nNk8, N the ring chunk's keys: lo*hi and
//     hi*lo into one accumulator,
//     hi*hi into another, added after the last k-step, as tile_f32 adds
//     them) and P V's three (m64nDk8, p repacked from S's accumulator as
//     register A fragments) are the mma.sync kernels' products with the
//     same operands in the same order: the bits are the same;
//   - a chunk wholly past L is neither split nor multiplied (its keys are
//     -inf, their e exact zeros).
// bf16 (stream_bf16) runs on wgmma too, bound on the card by the two
// passes' exponentials (MUFU, 2 an element of the padded L x L) and the
// products beside them, neither of which a CTA in lock step overlaps:
//   - a CTA is a producer warp and 1-3 consumer warpgroups of 64 queries
//     (stream_wgs), persistent: as many CTAs as the SMs hold, each walking
//     its (unit, query block) items, so one item's first loads overlap the
//     last steps of the one before;
//   - the producer loads by TMA (one thread; 64-key boxes of a map over
//     qkv that follows the frames-first layout) into a ring of 4 stages,
//     128-byte-swizzled as wgmma reads them: K K-major (the B of S = Q
//     K^T, m64n64k16, Q a swizzled tile too), V MN-major through the
//     instruction's transpose for 16-bit types (the B of P V, m64nDk16, p
//     repacked from S's accumulator as register A fragments, two n8 tiles
//     a k16 fragment), so nothing is split or transposed; full and empty
//     mbarriers a stage let each warpgroup run ahead of the others instead
//     of a CTA barrier a chunk (the copies by cp.async, and a CTA barrier
//     a chunk, cost 1.2-1.8 thousand cycles of each chunk's ~3.8 thousand
//     on an H100);
//   - e = 2^(s c - mx), c = d^-1/2 log2(e) folded into one FFMA before
//     ex2.approx (expf's ~9 instructions an element bound the softmax);
//     the rows' max and sum, p = T(e / sum) and O as above, so the
//     rounding points are the resident kernel's but the bits are not.
// d is padded to 64 or 128, keys past L are masked to -inf (their rows hold
// the next sequence's finite rows, zeros or an earlier chunk's rows, which
// p = 0 multiplies).  The output goes from the accumulators straight to
// global memory.
// ---------------------------------------------------------------------------

constexpr int MAX_STREAM_DIM = 128;
constexpr int STREAM_KC = 16 * CHUNK_TILES;         // keys of a chunk of the row statistics

__host__ __device__ constexpr int stream_dim(int d) { return d <= 64 ? 64 : 128; }

// The most threads a streamed CTA has, for an element of `size` bytes:
// float32 two warpgroups (128 queries), bf16 up to two consumer
// warpgroups (three at dp = 128) and a producer warp.
__host__ __device__ constexpr int stream_threads(int size, int dp) {
  return size == 4 ? 256 : 128 * (dp > 64 ? 3 : 2) + 32;
}

// Consumer warpgroups of a bf16 streamed CTA at L tokens: of 1..2 at dp =
// 64 (two CTAs share an SM; their registers allow it), 1..3 at dp = 128
// (one CTA fills an SM), the most that cut the unit's ceil(L / 64)
// 64-query blocks into CTAs with the fewest blocks in all (134 tokens at
// dp = 128: one CTA of three, not two of two).
inline int stream_wgs(int dp, int L) {
  const int blocks = (L + 63) / 64, most = dp > 64 ? 3 : 2;
  int w = 1;
  for (int u = 2; u <= most; ++u)
    if ((blocks + u - 1) / u * u <= (blocks + w - 1) / w * w) w = u;
  return w;
}

// 1: the resident kernel takes (L, d); 2: the streamed one; 0: neither (L
// < 1, or d outside 1..MAX_STREAM_DIM).
inline int variant(int size, int L, int d) {
  if (L < 1 || d < 1 || d > MAX_STREAM_DIM) return 0;
  const long long ub = unit_bytes(size, L, d);      // 0 past d = 64
  if (ub == 0) return 2;
  if (key_tiles(L) != CHUNK_TILES) return 1;          // float32 81-144 keys on wgmma
  // past 144 keys: bf16 at any d and float32 at d = 33..64 stream (both
  // kernels take 64-key chunks with the same rounding points; in float32
  // the same products, the same bits), as does a float32 unit whose ring
  // of two stages would not fit.  On an H100 80GB HBM3 at 700 W the
  // streamed kernel on wgmma is the faster there: MixSTE's temporal (536,
  // 243, 512) float32 2.28 against 3.74 ms, bf16 0.373 against 0.682
  // (chip_ab.py); (64, 243, 384) 0.267 against the resident 0.396, (64,
  // 243, 288) 0.253 against 0.390; it loses at d = 28, 32 (0.252 against
  // 0.202: d pads to 64 there; experiments/attention_fwd/run.py)
  return size == 4 && d <= 32 && ub <= SMEM_MAX ? 1 : 2;
}

// Shared memory of a streamed CTA: bf16 (Bf16Ring, at the most consumer
// warpgroups) 4 stages of a K and a V chunk and two Q buffers of a tile a
// warpgroup, 64 128-byte rows a 64-value slice of dp each, and 12
// mbarriers; float32 (FwdTiles, ring chunks of rk keys) at d = 128 Q's lo
// tiles of 128 rows, a ring chunk's K and V tiles, hi and lo, the chunk as
// copied; both 1 KB to align the tiles.
__host__ __device__ constexpr int stream_smem(int size, int dp) {
  return size == 2 ? (4 * 2 + 2 * (dp > 64 ? 3 : 2)) * (dp / 64) * STREAM_KC * 128 + 12 * 8 +
                         1024
                   : (dp > 64 ? 2 * (dp / 32) * 64 * 128 : 0) +
                         (dp / 32) * 2 * (dp > 64 ? 32 : 64) * 128 +
                         (dp > 64 ? 1 : 2) * 2 * dp * 128 + 2 * (dp > 64 ? 32 : 64) * dp * 4 +
                         1024;
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

// ---------------------------------------------------------------------------
// Float32 on wgmma.  A warpgroup (4 warps) takes 64 rows; an operand in
// shared memory is a K-major TF32 tile in the layout wgmma reads (rows of
// 128 bytes, 32 values, the 16-byte chunk c of row r at chunk c ^ (r % 8),
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned), one tile for
// the hi halves and one for the lo halves.  wgmma's accumulator and
// register A fragments lay each warp's 16 rows out as mma.sync's m16n8
// fragments do, so the softmax, the repacking of p and the row statistics
// are the mma.sync kernels' step for step.
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;         // rows of a warpgroup's tile

// The descriptor of such a tile; a k-step of 8 values (32 bytes) adds 2.
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return (uint64_t)((saddr(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Byte offset of 16-byte chunk c (values 4c..4c + 3) of row r in a tile.
__device__ __forceinline__ int swz16(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma (the async
// proxy); a barrier follows.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d (64 x N) += A (64 x 8) B (8 x N) in TF32 with f32 accumulation (m64nNk8):
// ss, A and B from shared-memory tiles (descriptors); rs, A from registers
// (this thread's a0..a3, mma.sync m16n8k8's A layout on its warp's 16
// rows).  `one` is 1: d accumulates.
template <int N> struct WgTf32;

template <> struct WgTf32<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one));
  }
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(one));
  }
};

template <> struct WgTf32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(one));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one));
  }
};

template <> struct WgTf32<40> {
  static __device__ __forceinline__ void rs(float (&d)[20], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one));
  }
};

template <> struct WgTf32<48> {
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t a, uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(one));
  }
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one));
  }
};

template <> struct WgTf32<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one));
  }
};

// Split four values into their TF32 halves (split(), as every kernel here):
// the hi bits and the lo bits, each as one 16-byte word.
__device__ __forceinline__ void split4(const float4& v, uint4& hi, uint4& lo) {
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
}

// This thread's A fragments of a warpgroup's 64-row operand, split: rows
// row0.. of x (row r at x + (base + r * S) * ld), zeros past L and d; this
// warp's 16 rows, (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each
// k-step.  The hi halves go into xh, the lo halves into xl (LO_REGS) or
// into the warpgroup's lo tiles, one a 32-value slice of d (lo_tiles +
// slice * tb); the warpgroup's threads write every value of its tiles.
template <int DP, bool LO_REGS>
__device__ __forceinline__ void load_operand(uint32_t (&xh)[DP / 8][4],
                                             uint32_t (&xl)[LO_REGS ? DP / 8 : 1][4],
                                             uint8_t* lo_tiles, int tb, const float* x,
                                             long long base, int S, long long ld, int row0,
                                             int L, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e & 1), row = row0 + r, col = 8 * kk + t + 4 * (e >> 1);
      uint32_t lo;
      split(row < L && col < d ? x[(base + (long long)row * S) * ld + col] : 0.f, xh[kk][e], lo);
      if constexpr (LO_REGS)
        xl[kk][e] = lo;
      else
        *reinterpret_cast<uint32_t*>(lo_tiles + (col / 32) * tb + swz16(r, (col % 32) / 4) +
                                     (col % 4) * 4) = lo;
    }
}

// A ring chunk's rows as K-major tiles: raw ([ROWS][DP] floats as copied)
// split into a hi and a lo tile a 32-value slice of d (slice sl's hi at
// tiles + 2 sl tb, its lo tb further; tb = ROWS * 128), by the CTA's
// threads, a 16-byte chunk a thread and step.
template <int DP, int ROWS>
__device__ __forceinline__ void split_row_tiles(uint8_t* tiles, const float* raw) {
  constexpr int TB = ROWS * 128;
  for (int i = threadIdx.x; i < ROWS * DP / 4; i += blockDim.x) {
    const int row = i / (DP / 4), cc = i % (DP / 4);
    uint4 hi, lo;
    split4(reinterpret_cast<const float4*>(raw)[i], hi, lo);
    uint8_t* tile = tiles + (cc / 8) * 2 * TB + swz16(row, cc % 8);
    *reinterpret_cast<uint4*>(tile) = hi;
    *reinterpret_cast<uint4*>(tile + TB) = lo;
  }
}

// A 32-row ring chunk transposed: raw ([32][DP] floats) split into a hi
// tile (at tile) and a lo tile (DP * 128 further) of a row per dim, the
// chunk's rows in the order a repacked accumulator fragment meets them
// (rows 2t, 2t + 1 of each 8 at k columns t, t + 4: chunk c of dim n holds
// rows 8 (c / 2) + c % 2 + 2u).
template <int DP>
__device__ __forceinline__ void split_col_tile(uint8_t* tile, const float* raw) {
  for (int i = threadIdx.x; i < DP * 8; i += blockDim.x) {
    const int n = i % DP, c = i / DP, k = 8 * (c >> 1) + (c & 1);
    const float* v = raw + k * DP + n;
    uint4 hi, lo;
    split4(make_float4(v[0], v[2 * DP], v[4 * DP], v[6 * DP]), hi, lo);
    *reinterpret_cast<uint4*>(tile + swz16(n, c)) = hi;
    *reinterpret_cast<uint4*>(tile + DP * 128 + swz16(n, c)) = lo;
  }
}

// The A fragment (hi, lo) of the 16 x 8 block of an accumulator whose four
// values are f (rows g, g + 8; columns 2t, 2t + 1 taken as k columns t, t +
// 4), split as tile_f32 splits p.
__device__ __forceinline__ void acc_fragment(const float (&f)[4], uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) {
  split(f[0], ah[0], al[0]);
  split(f[2], ah[1], al[1]);
  split(f[1], ah[2], al[2]);
  split(f[3], ah[3], al[3]);
}

// The tiles of a float32 streamed forward CTA (two warpgroups, 128
// queries; ring chunks of RK keys: 64 at d = 64, 32 at d = 128): at d = 128
// Q's lo halves, a tile per warpgroup and 32-value slice of d (Q's other
// halves are A fragments in registers); K's chunk by rows, hi and lo, a
// tile per slice of d; V's chunk by columns, hi and lo, a tile per 32 keys
// (V^T: a row per dim, the keys in the order the repacked p meets them:
// keys 2t, 2t + 1 of each 8 at k columns t, t + 4); the ring's one stage of
// K and V rows as copied.
template <int DP> struct FwdTiles {
  static constexpr int NSL = DP / 32, RK = DP > 64 ? 32 : 64, NKS = RK / 32;
  static constexpr bool Q_LO_TILES = DP > 64;
  static constexpr int QT = WG_ROWS * 128, KT = RK * 128, VT = DP * 128;
  static constexpr int Q_OFF = 0;                          // [warpgroup][slice] (lo)
  static constexpr int K_OFF = Q_OFF + (Q_LO_TILES ? 2 * NSL * QT : 0);   // [slice][hi, lo]
  static constexpr int V_OFF = K_OFF + NSL * 2 * KT;       // [key slice][hi, lo]
  static constexpr int RAW_OFF = V_OFF + NKS * 2 * VT;     // K, then V: [RK][DP] floats
  static constexpr int SMEM = RAW_OFF + 2 * RK * DP * 4 + 1024;    // + the alignment
};

// The float32 streamed forward of one CTA: the body of
// attention_stream_kernel<float, DP>.  Pass 1 over K's ring chunks, pass 2
// over K's and V's.  At d = 128 a chunk of STREAM_KC keys is two ring
// chunks; pass 1 keeps the first's logits (s0) for the second's
// statistics.
template <int DP>
__device__ __forceinline__ void stream_f32(const float* __restrict__ qkv, float* __restrict__ out,
                                           int L, int S, int C, int H, int d, float scale,
                                           int qblocks, int vb, int vo,
                                           unsigned char* smem_raw) {
  using Lt = FwdTiles<DP>;
  constexpr int NSL = Lt::NSL, RK = Lt::RK, KS = DP / 8, NV = RK / 2, JK = RK / 8;
  constexpr int SPC = STREAM_KC / RK;      // ring chunks a chunk of the statistics
  uint8_t* sm = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  float* raw = reinterpret_cast<float*>(sm + Lt::RAW_OFF);
  const long long unit = blockIdx.x / qblocks, seq = unit / H;
  const int qblock = (int)(blockIdx.x - unit * qblocks), h = (int)(unit - seq * H);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (qblock * 2 + wg) * WG_ROWS;          // the warpgroup's first query
  const int C3 = 3 * C, nr = (L + STREAM_KC - 1) / STREAM_KC * SPC, steps = 2 * nr;
  const long long base = seq / S * L * S + seq % S;    // token l at row base + l * S
  const float* src = qkv + (long long)h * d;

  zero_smem(raw, 2 * RK * DP * 4 / 16);
  // Q's A fragments, split: the hi halves in registers, the lo halves in
  // registers at d = 64 and in the warpgroup's tiles at d = 128
  uint32_t qh[KS][4], ql[Lt::Q_LO_TILES ? 1 : KS][4];
  load_operand<DP, !Lt::Q_LO_TILES>(qh, ql, sm + Lt::Q_OFF + wg * NSL * Lt::QT, Lt::QT, src, base,
                                    S, C3, q0, L, d);
  __syncthreads();
  auto issue = [&](int step) {
    const int k0 = (step < nr ? step : step - nr) * RK;
    const int rows = L - k0 < RK ? L - k0 : RK;     // none past L
    stream_rows(vb, raw, src + C, base, S, C3, k0, rows, d, DP);
    if (step >= nr) stream_rows(vb, raw + RK * DP, src + 2 * C, base, S, C3, k0, rows, d, DP);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  issue(0);

  // s0: at d = 128 the logits of a chunk's first ring chunk, kept for pass
  // 1's statistics; sc: the current ring chunk's
  float s0[SPC > 1 ? NV : 1], o[DP / 2], mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float inv[2];
  for (int step = 0; step < steps; ++step) {
    const bool pass2 = step >= nr;
    const int r = pass2 ? step - nr : step, k0 = r * RK;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();     // the chunk has landed; no wgmma reads the tiles any more
    // a chunk's second ring chunk wholly past L: its keys are -inf, nothing
    // of it is split or multiplied
    const bool past = k0 >= L;
    if (!past) {
      split_row_tiles<DP, RK>(sm + Lt::K_OFF, raw);
      if (pass2)
#pragma unroll
        for (int ks = 0; ks < Lt::NKS; ++ks)
          split_col_tile<DP>(sm + Lt::V_OFF + ks * 2 * Lt::VT, raw + (RK + 32 * ks) * DP);
      async_proxy_fence();
    }
    __syncthreads();     // the tiles are whole; the stage is free
    if (step + 1 < steps) issue(step + 1);
    // (a warpgroup wholly past L computes on zero rows and stores nothing: a
    // branch on it would serialise the wgmmas)
    if (past && pass2) continue;
    float sc[NV], small[NV];
    if (past) {
#pragma unroll
      for (int e = 0; e < NV; ++e) sc[e] = -INFINITY;
    } else {
      // the logits S = Q K^T of the ring chunk: three TF32 products a
      // k-step, lo*hi and hi*lo summed apart (small) and added after the
      // last
#pragma unroll
      for (int e = 0; e < NV; ++e) sc[e] = small[e] = 0.f;
      wg_fence();
#pragma unroll
      for (int sl = 0; sl < NSL; ++sl) {
        const uint8_t* kt = sm + Lt::K_OFF + sl * 2 * Lt::KT;
        const uint64_t kh = tile_desc(kt), kl = tile_desc(kt + Lt::KT);
        const uint64_t qlo = tile_desc(sm + Lt::Q_OFF + (wg * NSL + sl) * Lt::QT);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (Lt::Q_LO_TILES)
            WgTf32<RK>::ss(small, qlo + 2 * kk, kh + 2 * kk, 1);
          else
            WgTf32<RK>::rs(small, ql[4 * sl + kk], kh + 2 * kk, 1);
          WgTf32<RK>::rs(small, qh[4 * sl + kk], kl + 2 * kk, 1);
          WgTf32<RK>::rs(sc, qh[4 * sl + kk], kh + 2 * kk, 1);
        }
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        sc[e] = key < L ? (sc[e] + small[e]) * scale : -INFINITY;
      }
    }
    if (!pass2) {
      if constexpr (SPC > 1) {
        if (!(r & 1)) {
#pragma unroll
          for (int e = 0; e < NV; ++e) s0[e] = sc[e];
          continue;
        }
      }
      // the rows' max and sum over the chunk's 64 keys (its n8 tiles in
      // order: at d = 128 s0's four, then sc's)
      float cm[2] = {-INFINITY, -INFINITY};
      if constexpr (SPC > 1)
#pragma unroll
        for (int e = 0; e < NV; ++e) cm[(e >> 1) & 1] = fmaxf(cm[(e >> 1) & 1], s0[e]);
#pragma unroll
      for (int e = 0; e < NV; ++e) cm[(e >> 1) & 1] = fmaxf(cm[(e >> 1) & 1], sc[e]);
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float m = fmaxf(mx[q], quad_max(cm[q]));
        sum[q] *= expf(mx[q] - m);     // 0 on the first chunk
        mx[q] = m;
      }
      if constexpr (SPC > 1)
#pragma unroll
        for (int e = 0; e < NV; ++e) cs[(e >> 1) & 1] += expf(s0[e] - mx[(e >> 1) & 1]);
#pragma unroll
      for (int e = 0; e < NV; ++e) cs[(e >> 1) & 1] += expf(sc[e] - mx[(e >> 1) & 1]);
#pragma unroll
      for (int q = 0; q < 2; ++q) sum[q] += quad_sum(cs[q]);
      continue;
    }
    if (r == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) inv[q] = 1.f / sum[q];
#pragma unroll
      for (int n = 0; n < DP / 2; ++n) o[n] = 0.f;
    }
    // O += T(p) V over the ring chunk: p = e * (1 / sum) repacked as the A
    // operand (keys 2t, 2t + 1 of n8 tile j as k columns t, t + 4 of k-step
    // j), V^T's hi and lo tiles as B
    uint32_t ah[JK][4], al[JK][4];
#pragma unroll
    for (int j = 0; j < JK; ++j) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) e4[e] = expf(sc[4 * j + e] - mx[e >> 1]) * inv[e >> 1];
      acc_fragment(e4, ah[j], al[j]);
    }
    wg_fence();
#pragma unroll
    for (int j = 0; j < JK; ++j) {
      const uint64_t vh = tile_desc(sm + Lt::V_OFF + (j / 4) * 2 * Lt::VT) + 2 * (j % 4);
      const uint64_t vl = vh + (Lt::VT >> 4);
      WgTf32<DP>::rs(o, al[j], vh, 1);
      WgTf32<DP>::rs(o, ah[j], vl, 1);
      WgTf32<DP>::rs(o, ah[j], vh, 1);
    }
    wg_commit();
    wg_wait0();
  }
  if (q0 >= L) return;
  // rows q0 + 16 warp + g (+ 8), columns < d: accumulator 4n + 2q + {0, 1}
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = q0 + 16 * warp + g + 8 * q;
    if (row >= L) continue;
    float* y = out + (long long)h * d + (base + (long long)row * S) * C;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int col = 8 * n + 2 * t;
      if (vo) {
        if (col < d) *reinterpret_cast<float2*>(y + col) = make_float2(o[4 * n + 2 * q], o[4 * n + 2 * q + 1]);
      } else {
        if (col < d) y[col] = o[4 * n + 2 * q];
        if (col + 1 < d) y[col + 1] = o[4 * n + 2 * q + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Float32 units on wgmma (the forward at 81-144 keys below and
// attention_bwd_sm90.cuh's resident backward past 80 keys).  Each operand
// is split into K-major TF32 tiles of 64 rows, hi and lo, in the layouts
// the streamed kernels use: a rows set (64 rows by d, the B of X Y^T or the
// A of an SS product) or a cols set (64 rows transposed into two tiles of
// 32, a row per value of d, the B of an RS product whose A is a repacked
// accumulator); the forward reads the rows from global memory (the unit
// stays in L2 across its CTAs), the backward from a raw copy of the unit in
// shared memory.  KS: k-steps of 8 over d (d padded with zeros to 8 KS); no
// product runs over the padding beyond it.
// ---------------------------------------------------------------------------

template <int KS> struct WgSet {
  static constexpr int NSL = (KS + 3) / 4;              // 32-value slices of d
  static constexpr int TB = WG_ROWS * 128;              // a rows tile
  static constexpr int ROWS = 2 * NSL * TB;             // a rows set, hi and lo
  static constexpr int CB = 8 * KS * 128;               // a cols tile (32 rows)
  static constexpr int COLS = 2 * 2 * CB;               // a cols set: two tiles, hi and lo
  static constexpr int BIG = ROWS > COLS ? ROWS : COLS;
};

// Four values from columns c..c + 3 of a row at p (zeros from d on); vec:
// p 16-byte aligned and d a multiple of 4, so one 16-byte load.
__device__ __forceinline__ float4 load4(const float* p, int c, int d, int vec) {
  if (vec) return c < d ? __ldg(reinterpret_cast<const float4*>(p + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < d ? __ldg(p + c) : 0.f, c + 1 < d ? __ldg(p + c + 1) : 0.f,
                     c + 2 < d ? __ldg(p + c + 2) : 0.f, c + 3 < d ? __ldg(p + c + 3) : 0.f);
}

// Rows r0..r0 + 63 of x (row r at x + r * rs; zeros from row n on and past
// d) split into a rows set at tiles (slice sl's hi tile at tiles + 2 sl TB,
// its lo tile TB further; split_row_tiles' layout), by the warpgroup's 128
// threads.
template <int KS>
__device__ __forceinline__ void rows_set(uint8_t* tiles, const float* x, long long rs, int r0,
                                         int n, int d, int vec) {
  using W = WgSet<KS>;
  // 16-byte chunks a row, a thread; loads in batches of 4 at d > 48, else
  // all at once
  constexpr int CPR = 2 * KS, IT = WG_ROWS * CPR / 128, BT = IT > 6 ? 4 : IT;
#pragma unroll
  for (int j0 = 0; j0 < IT; j0 += BT) {
    float4 v[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      const int i = threadIdx.x + 128 * (j0 + j), row = i / CPR, cc = i - row * CPR;
      v[j] = j0 + j < IT && r0 + row < n ? load4(x + (long long)(r0 + row) * rs, 4 * cc, d, vec)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j0 + j >= IT) break;
      const int i = threadIdx.x + 128 * (j0 + j), row = i / CPR, cc = i - row * CPR;
      uint4 hi, lo;
      split4(v[j], hi, lo);
      uint8_t* tile = tiles + (cc / 8) * 2 * W::TB + swz16(row, cc % 8);
      *reinterpret_cast<uint4*>(tile) = hi;
      *reinterpret_cast<uint4*>(tile + W::TB) = lo;
    }
  }
}

// The same rows transposed into a cols set at tiles: tile ks (rows 32 ks..)
// hi at tiles + 2 ks CB, lo CB further, a row per value of d, the rows in
// the order a repacked accumulator fragment meets them (split_col_tile's
// layout: chunk c of dim m holds rows 8 (c / 2) + c % 2 + 2u).
template <int KS>
__device__ __forceinline__ void cols_set(uint8_t* tiles, const float* x, long long rs, int r0,
                                         int n, int d) {
  using W = WgSet<KS>;
  // loads in batches of 4 a thread at d > 48 (8 float4s in flight beside a
  // CTA's 3 chunks of logits would spill), else all at once
  constexpr int ND = 8 * KS, IT = 2 * ND * 8 / 128, BT = IT > 6 ? 4 : IT;
#pragma unroll
  for (int j0 = 0; j0 < IT; j0 += BT) {
    float4 v[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      const int i = threadIdx.x + 128 * (j0 + j), ks = i / (ND * 8), w = i - ks * ND * 8;
      const int m = w % ND, c = w / ND, k = r0 + 32 * ks + 8 * (c >> 1) + (c & 1);
      const float* p = x + m + (long long)k * rs;
      const bool in = m < d && j0 + j < IT;
      v[j] = make_float4(in && k < n ? __ldg(p) : 0.f, in && k + 2 < n ? __ldg(p + 2 * rs) : 0.f,
                         in && k + 4 < n ? __ldg(p + 4 * rs) : 0.f,
                         in && k + 6 < n ? __ldg(p + 6 * rs) : 0.f);
    }
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j0 + j >= IT) break;
      const int i = threadIdx.x + 128 * (j0 + j), ks = i / (ND * 8), w = i - ks * ND * 8;
      const int m = w % ND, c = w / ND;
      uint4 hi, lo;
      split4(v[j], hi, lo);
      uint8_t* tile = tiles + ks * 2 * W::CB + swz16(m, c);
      *reinterpret_cast<uint4*>(tile) = hi;
      *reinterpret_cast<uint4*>(tile + W::CB) = lo;
    }
  }
}

// A 64-row chunk of one operand as copied: [64][8 KS + 4] floats (the 4
// spread a warp's fragment reads over the banks), zeros past the rows and
// columns it holds.
template <int KS> struct RawChunk {
  static constexpr int RW = 8 * KS + 4, FLOATS = WG_ROWS * RW;
};

// cp.async of `bytes` (16 or 4 at most) of src into dst, zeros for the rest
// of the 16 (or 4) bytes; bytes = 0 reads nothing.
__device__ __forceinline__ void copy16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(saddr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy4_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(saddr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// Rows r0..r0 + rows - 1 of x (row r at x + r * ld) into a raw chunk by
// the CTA's cp.async (one commit group is the caller's), zeros from row n
// on and from column d on; vec: 16 bytes a copy (x 16-byte aligned, d and
// ld multiples of 4), else 4.
template <int KS, int NT = 128>
__device__ __forceinline__ void fetch_rows(float* chunk, const float* x, long long ld, int r0,
                                           int n, int d, int vec, int rows = WG_ROWS) {
  constexpr int RW = RawChunk<KS>::RW;
  if (vec) {
    constexpr int CPR = RW / 4;
    for (int i = threadIdx.x; i < rows * CPR; i += NT) {
      const int row = i / CPR, c = 4 * (i - row * CPR);
      const bool in = r0 + row < n && c < d;
      copy16_zfill(chunk + 4 * i, in ? x + (long long)(r0 + row) * ld + c : x, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * RW; i += NT) {
      const int row = i / RW, c = i - row * RW;
      const bool in = r0 + row < n && c < d;
      copy4_zfill(chunk + i, in ? x + (long long)(r0 + row) * ld + c : x, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void copies_wait0() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// This thread's A fragments of its warp's 16 rows of a raw chunk (zeros
// from row `rows` on), split: rows 16 warp + g (+ 8), columns 8 kk + t (+
// 4) of each k-step (mma.sync m16n8k8's A layout, which wgmma's register A
// takes a warp at a time).
template <int KS>
__device__ __forceinline__ void chunk_fragments(uint32_t (&h)[KS][4], uint32_t (&l)[KS][4],
                                                const float* chunk, int rows = WG_ROWS) {
  constexpr int RW = RawChunk<KS>::RW;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = (threadIdx.x >> 5) & 3;
  const int r = 16 * warp + g;
  const float* x = chunk + r * RW + t;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(r + 8 * (e & 1) < rows ? x[8 * (e & 1) * RW + 8 * kk + 4 * (e >> 1)] : 0.f, h[kk][e],
            l[kk][e]);
}

// acc = X Y^T over d (64 x 64 a warpgroup, 32 values a thread): X from
// registers (h, l: chunk_fragments), Y a rows set at y; row_products'
// three TF32 products a k-step (lo*hi and hi*lo into small, hi*hi into
// acc), one commit group; the caller waits and adds small to acc.
template <int KS>
__device__ __forceinline__ void reg_products(float (&acc)[32], float (&small)[32],
                                             const uint32_t (&h)[KS][4],
                                             const uint32_t (&l)[KS][4], const uint8_t* y) {
  using W = WgSet<KS>;
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = small[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int sl = 0; sl < W::NSL; ++sl) {
    const uint64_t yh = tile_desc(y + 2 * sl * W::TB), yl = yh + (W::TB >> 4);
#pragma unroll
    for (int kk = 0; kk < 4 && 4 * sl + kk < KS; ++kk) {
      WgTf32<64>::rs(small, l[4 * sl + kk], yh + 2 * kk, 1);
      WgTf32<64>::rs(small, h[4 * sl + kk], yl + 2 * kk, 1);
      WgTf32<64>::rs(acc, h[4 * sl + kk], yh + 2 * kk, 1);
    }
  }
  wg_commit();
}

// A raw chunk (zeros from row `rows` on) split into a rows set (rows_set's
// layout), from shared memory.
template <int KS, int NT = 128>
__device__ __forceinline__ void rows_from(uint8_t* tiles, const float* chunk,
                                          int rows = WG_ROWS) {
  using W = WgSet<KS>;
  constexpr int CPR = 2 * KS;
#pragma unroll
  for (int j = 0; j < (WG_ROWS * CPR + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + NT * j, row = i / CPR, cc = i - row * CPR;
    if ((WG_ROWS * CPR) % NT && i >= WG_ROWS * CPR) break;
    uint4 hi, lo;
    split4(row < rows ? *reinterpret_cast<const float4*>(chunk + row * RawChunk<KS>::RW + 4 * cc)
                      : make_float4(0.f, 0.f, 0.f, 0.f),
           hi, lo);
    uint8_t* tile = tiles + (cc / 8) * 2 * W::TB + swz16(row, cc % 8);
    *reinterpret_cast<uint4*>(tile) = hi;
    *reinterpret_cast<uint4*>(tile + W::TB) = lo;
  }
}

// A raw chunk (zeros from row `rows` on) split into a cols set (cols_set's
// layout), from shared memory.
template <int KS, int NT = 128>
__device__ __forceinline__ void cols_from(uint8_t* tiles, const float* chunk,
                                          int rows = WG_ROWS) {
  using W = WgSet<KS>;
  constexpr int ND = 8 * KS, RW = RawChunk<KS>::RW;
#pragma unroll
  for (int j = 0; j < (2 * ND * 8 + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + NT * j, ks = i / (ND * 8), w = i - ks * ND * 8;
    if ((2 * ND * 8) % NT && i >= 2 * ND * 8) break;
    const int m = w % ND, c = w / ND, k = 32 * ks + 8 * (c >> 1) + (c & 1);
    const float* v = chunk + k * RW + m;
    uint4 hi, lo;
    split4(make_float4(k < rows ? v[0] : 0.f, k + 2 < rows ? v[2 * RW] : 0.f,
                       k + 4 < rows ? v[4 * RW] : 0.f, k + 6 < rows ? v[6 * RW] : 0.f),
           hi, lo);
    uint8_t* tile = tiles + ks * 2 * W::CB + swz16(m, c);
    *reinterpret_cast<uint4*>(tile) = hi;
    *reinterpret_cast<uint4*>(tile + W::CB) = lo;
  }
}

// The CTA's generic-proxy writes to a set made visible to its wgmmas (a
// barrier follows the fence).
__device__ __forceinline__ void set_ready() {
  async_proxy_fence();
  __syncthreads();
}

// acc = X Y^T over d (64 x 64 a warpgroup, 32 values a thread), X and Y
// rows sets at x and y: row_products' three TF32 products a k-step (lo*hi
// and hi*lo into small, hi*hi into acc; the k-steps of d only), one commit
// group; the caller waits and adds small to acc.
template <int KS, int N = 64>
__device__ __forceinline__ void set_products(float (&acc)[N / 2], float (&small)[N / 2],
                                             const uint8_t* x, const uint8_t* y) {
  using W = WgSet<KS>;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = small[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int sl = 0; sl < W::NSL; ++sl) {
    const uint64_t xh = tile_desc(x + 2 * sl * W::TB), xl = xh + (W::TB >> 4);
    const uint64_t yh = tile_desc(y + 2 * sl * W::TB), yl = yh + (W::TB >> 4);
#pragma unroll
    for (int kk = 0; kk < 4 && 4 * sl + kk < KS; ++kk) {
      WgTf32<N>::ss(small, xl + 2 * kk, yh + 2 * kk, 1);
      WgTf32<N>::ss(small, xh + 2 * kk, yl + 2 * kk, 1);
      WgTf32<N>::ss(acc, xh + 2 * kk, yh + 2 * kk, 1);
    }
  }
  wg_commit();
}

// acc = X Y^T over N of Y's rows (N / 2 values a thread), waited for, the
// small products added.
template <int KS, int N = 64>
__device__ __forceinline__ void set_products_wait(float (&acc)[N / 2], const uint8_t* x,
                                                  const uint8_t* y) {
  float small[N / 2];
  set_products<KS, N>(acc, small, x, y);
  wg_wait0();
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] += small[e];
}

// acc (64 x 8 KS) = A Z over the first NK k-steps (of 4) of one 32-row tile
// of a cols set (z its hi tile, the lo tile CB further), plus acc where
// `keep` is 1 (the first wgmma's scale-d; 0: a fresh accumulator): A's
// fragments (ah, al) repacked from an accumulator; lo*hi, hi*lo, hi*hi a
// k-step, one commit group.
template <int KS, int NK>
__device__ __forceinline__ void set_times(float (&acc)[4 * KS], const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4], const uint8_t* z,
                                          int keep) {
  const uint64_t zh = tile_desc(z), zl = zh + (WgSet<KS>::CB >> 4);
  wg_fence();
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    WgTf32<8 * KS>::rs(acc, al[j], zh + 2 * j, j == 0 ? keep : 1);
    WgTf32<8 * KS>::rs(acc, ah[j], zl + 2 * j, 1);
    WgTf32<8 * KS>::rs(acc, ah[j], zh + 2 * j, 1);
  }
  wg_commit();
}

// The A fragments of up to 32 keys (half hh of an accumulator f of NV / 4
// n8 tiles, each value times mul[its row]), split as tile_f32 splits p;
// hh a constant where it is inlined.
template <int NV>
__device__ __forceinline__ void half_fragments(const float (&f)[NV], int hh, const float (&mul)[2],
                                               uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 16 * hh + 4 * j;
    if (e + 3 >= NV) break;
    const float v[4] = {f[e] * mul[0], f[e + 1] * mul[0], f[e + 2] * mul[1], f[e + 3] * mul[1]};
    acc_fragment(v, ah[j], al[j]);
  }
}

// Rows row0 + 16 warp + g (+ 8), columns < d, of a 64 x 8 KS accumulator
// (value 4n + 2q + {0, 1}: row + 8q, column 8n + 2t + {0, 1}) times scale
// into out (row r at out + r * rs), rows below n only; vo: two values a
// store.
template <int KS>
__device__ __forceinline__ void store_set(float* out, long long rs, const float (&acc)[4 * KS],
                                          float scale, int row0, int n, int d, int vo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = row0 + 16 * warp + g + 8 * q;
    if (row >= n) continue;
    float* o = out + (long long)row * rs;
#pragma unroll
    for (int m = 0; m < KS; ++m) {
      const int col = 8 * m + 2 * t;
      const float a = acc[4 * m + 2 * q] * scale, b = acc[4 * m + 2 * q + 1] * scale;
      if (vo) {
        if (col < d) *reinterpret_cast<float2*>(o + col) = make_float2(a, b);
      } else {
        if (col < d) o[col] = a;
        if (col + 1 < d) o[col + 1] = b;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The float32 forward at 81-144 keys (key_tiles(L) == 9, where tile_f32's
// one pass kept 9 key tiles of logits a warp) on wgmma: a CTA is one
// warpgroup and one 64-query block of one (sequence, head) unit, NB = 2 or
// 3 blocks a unit.  Q's rows set is split once; each chunk of K (64 keys,
// 48 where three are needed at d = 49..64) is split into the CTA's one further
// set, and S = Q K^T (three TF32 products, the small two summed apart)
// kept: all NB chunks' logits stay in registers (32 or 24 a chunk), so the
// row's max and sum come from one pass over the keys, in tile_f32's order
// (keys ascending in each thread, then the quad); p = e * (1 / sum) after
// the full sum, repacked as register A fragments, and O += p V over each
// chunk of V's cols set, O in one f32 accumulator (the rounding points of
// _block_body and tile_f32).  What bounds it on an H100 at these shapes is
// the bytes (4*B*L^2*C operations against 16*B*L*C bytes: L / 4 a byte,
// far below the ~50 of float32 as three TF32 products; 0.32 ms at MixSTE's
// spatial (972, 134, 512), 0.18 at the monolithic (999, 134, 288)); the
// design reads each unit from L2 once a block and keeps three CTAs an SM
// (shared memory 2 sets), so one CTA's loads and splits overlap the
// others' products.
// ---------------------------------------------------------------------------

template <int KS> struct FwdWg {
  static constexpr int A = 0, R = WgSet<KS>::BIG, SMEM = 2 * WgSet<KS>::BIG + 1024;
};

template <int KS, int NB>
__global__ void __launch_bounds__(128, 2)
attention_wg_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L, int S, int C,
                    int H, int d, float scale, int vec, int vo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using W = WgSet<KS>;
  // keys a chunk: 64, or 48 for three chunks at d = 49..64 (up to 144
  // keys: three chunks of 64 logits a thread beside O's 32 do not fit the
  // registers); NV logits a thread
  constexpr int KC = NB == 3 && KS == 8 ? 48 : 64, NV = KC / 2;
  uint8_t* sm = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm + FwdWg<KS>::A;
  uint8_t* rg = sm + FwdWg<KS>::R;
  const long long unit = blockIdx.x / NB, seq = unit / H;
  const int b = (int)(blockIdx.x - unit * NB), h = (int)(unit - seq * H);
  const int lane = threadIdx.x & 31, t = lane & 3, C3 = 3 * C;
  const long long base = seq / S * L * S + seq % S, rs = (long long)S * C3;
  const float* src = qkv + base * C3 + (long long)h * d;      // q of token 0
  const int q0 = WG_ROWS * b;

  rows_set<KS>(qs, src, rs, q0, L, d, vec);
  // the logits of every chunk, keys past L at -inf
  float s[NB][NV];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c > 0) __syncthreads();       // the last chunk's products have been waited for
    rows_set<KS>(rg, src + C, rs, KC * c, L, d, vec);
    set_ready();
    set_products_wait<KS, KC>(s[c], qs, rg);
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int key = KC * c + 8 * (e >> 2) + 2 * t + (e & 1);
      s[c][e] = key < L ? s[c][e] * scale : -INFINITY;
    }
  }
  // the row's max and sum over all keys (rows g and g + 8: values (e >> 1) & 1)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < NV; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[c][e]);
#pragma unroll
  for (int q = 0; q < 2; ++q) mx[q] = quad_max(mx[q]);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      s[c][e] = expf(s[c][e] - mx[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += s[c][e];
    }
#pragma unroll
  for (int q = 0; q < 2; ++q) inv[q] = 1.f / quad_sum(sum[q]);
  // O += T(p) V, chunk by chunk (a 32-key half wholly past L skipped)
  float o[4 * KS];
#pragma unroll
  for (int e = 0; e < 4 * KS; ++e) o[e] = 0.f;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    __syncthreads();                   // every wgmma that read the set is waited for
    cols_set<KS>(rg, src + 2 * C, rs, KC * c, L, d);
    set_ready();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (hh == 1 && KC * c + 32 >= L) break;
      uint32_t ah[4][4], al[4][4];
      half_fragments(s[c], hh, inv, ah, al);
      if (KC == 48 && hh == 1)
        set_times<KS, 2>(o, ah, al, rg + 2 * W::CB, 1);     // keys 32..47 of the chunk
      else
        set_times<KS, 4>(o, ah, al, rg + hh * 2 * W::CB, 1);
      wg_wait0();
    }
  }
  store_set<KS>(out + base * C + (long long)h * d, (long long)S * C, o, 1.f, q0, L, d, vo);
}

template <int KS, int NB>
cudaError_t launch_wg(const float* qkv, float* out, long long seqs, int L, int S, int C, int H,
                      int d, float scale, int vec, int vo, cudaStream_t stream) {
  const auto kernel = attention_wg_kernel<KS, NB>;
  constexpr int smem = FwdWg<KS>::SMEM;
  static_assert(smem <= SMEM_MAX, "a CTA's shared memory");
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = seqs * H * NB;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, 128, smem, stream>>>(qkv, out, L, S, C, H, d, scale, vec, vo);
  return counted(LAUNCH_ATTENTION_WG, cudaGetLastError());
}

// The head size's k-steps a set takes: 4 (d <= 32), 5, 6 or 8 (d = 49..64,
// padded).
__host__ __device__ constexpr int wg_ksteps(int d) { return d <= 32 ? 4 : d <= 40 ? 5 : d <= 48 ? 6 : 8; }

template <int NB>
cudaError_t launch_wg_nb(const float* qkv, float* out, long long seqs, int L, int S, int C,
                         int H, int d, float scale, int vec, int vo, cudaStream_t stream) {
  switch (wg_ksteps(d)) {
    case 4: return launch_wg<4, NB>(qkv, out, seqs, L, S, C, H, d, scale, vec, vo, stream);
    case 5: return launch_wg<5, NB>(qkv, out, seqs, L, S, C, H, d, scale, vec, vo, stream);
    case 6: return launch_wg<6, NB>(qkv, out, seqs, L, S, C, H, d, scale, vec, vo, stream);
    default: return launch_wg<8, NB>(qkv, out, seqs, L, S, C, H, d, scale, vec, vo, stream);
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma.  A warpgroup takes 64 queries; Q (the A of S), K and V
// sit in 128-byte-swizzled tiles, one a 64-value slice of d, [row][d] as
// qkv stores them: K's tile is the K-major B of S = Q K^T, V's the
// MN-major B of P V (the instruction's transpose, which exists for 16-bit
// types), so nothing is split or transposed in shared memory.  (Q's A
// fragments in registers made ptxas place P's fragments in the same
// registers, the next chunk's S then reading P as Q.)
// ---------------------------------------------------------------------------

// d (64 x N) += A (64 x 16) B (16 x N) in bf16 with f32 accumulation
// (m64nNk16): A from registers (this thread's a0..a3), B a 128-byte-
// swizzled shared tile, K-major (TRANS 0) or MN-major (TRANS 1).  `one` is
// 1: d accumulates.
template <int N, int TRANS> struct WgBf16;

template <int TRANS> struct WgBf16<64, TRANS> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(one), "n"(TRANS));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one), "n"(TRANS));
  }
};

template <int TRANS> struct WgBf16<128, TRANS> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int one) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(one), "n"(TRANS));
  }
};

// 2^x (ex2.approx: ~2 ulp; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving a use of an accumulator above the wait
// for the wgmmas that write it.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The tiles of a bf16 streamed forward CTA of 1..WGS consumer warpgroups
// (stream_wgs) and a producer warp: a ring of STAGES stages of a K and a V
// chunk (STREAM_KC keys), then each warpgroup's Q (64 rows), each part a
// tile of 64 rows of 128 bytes a 64-value slice of d; then the stages'
// mbarriers, full and empty.  The descriptor of an MN-major tile (V: its
// 8-key groups 1024 bytes apart, its slices of d TILE bytes apart).
template <int DP> struct Bf16Ring {
  static constexpr int NSL = DP / 64, TILE = STREAM_KC * 128, PART = NSL * TILE;
  static constexpr int STAGES = 4, WGS = DP > 64 ? 3 : 2;
  static constexpr int Q_OFF = STAGES * 2 * PART;
  // nq Q buffers: 2 where a CTA walks several items, else 1
  __host__ __device__ static constexpr int bar_off(int wgs, int nq) {
    return Q_OFF + nq * wgs * PART;
  }
  // shared memory of a CTA of wgs warpgroups, 1 KB to align the tiles
  __host__ __device__ static constexpr int smem(int wgs, int nq) {
    return bar_off(wgs, nq) + (2 * STAGES + 4) * 8 + 1024;
  }
  static constexpr int SMEM = smem(WGS, 2);
  static __device__ __forceinline__ uint64_t v_desc(const void* tile) {
    return (uint64_t)((saddr(tile) & 0x3FFFF) >> 4) | ((uint64_t)(TILE >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
  }
};

// The producer warp's copy of rows k0.. (rows of them) of one part of a
// unit into 64-row tiles (row r in the tiles of block r / 64, slice sl of d
// at dst + (block * NSL + sl) * TILE), VB bytes a lane and step: row r from
// src + (base + (k0 + r) * S) * ld, its first d values, each 16-byte chunk
// c of a row at swz16(r % 64, c).  A lane walks its vectors without a
// division a vector.
template <int NSL, int VB>
__device__ __forceinline__ void copy_tiles(uint8_t* dst, const __nv_bfloat16* src,
                                           long long base, int S, int ld, int k0, int rows,
                                           int d, int lane, int lanes) {
  constexpr int EPV = VB / 2;
  const int vph = d / EPV, n = rows * vph, dr = lanes / vph, dc = lanes - dr * vph;
  int r = lane / vph, c = lane - r * vph;
  for (int i = lane; i < n; i += lanes) {
    const int byte = 2 * EPV * c;
    copy_in<VB>(dst + ((r >> 6) * NSL + (byte >> 7)) * (STREAM_KC * 128) +
                    swz16(r & 63, (byte >> 4) & 7) + (byte & 15),
                src + (base + (long long)(k0 + r) * S) * ld + EPV * c);
    c += dc;
    r += dr;
    if (c >= vph) {
      c -= vph;
      ++r;
    }
  }
}

template <int NSL>
__device__ __forceinline__ void copy_tiles(int vb, uint8_t* dst, const __nv_bfloat16* src,
                                           long long base, int S, int ld, int k0, int rows,
                                           int d, int lane, int lanes) {
  switch (vb) {
    case 16: copy_tiles<NSL, 16>(dst, src, base, S, ld, k0, rows, d, lane, lanes); break;
    case 8: copy_tiles<NSL, 8>(dst, src, base, S, ld, k0, rows, d, lane, lanes); break;
    case 4: copy_tiles<NSL, 4>(dst, src, base, S, ld, k0, rows, d, lane, lanes); break;
    default: copy_tiles<NSL, 2>(dst, src, base, S, ld, k0, rows, d, lane, lanes); break;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar)) : "memory");
}
// an arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one arrival for the warp, once all its lanes are here
__device__ __forceinline__ void arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
// TMA: the box at (c0, c1, c2) of map into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The bf16 streamed forward of one CTA: the body of
// attention_stream_kernel<__nv_bfloat16, DP>.  An item's step i < nc: ring
// chunk i of K, the rows' max and sum (pass 1); step nc + i: chunk i of K
// and V, the logits again and O += T(p) V (pass 2).  The products keep
// tile_bf16's operands and order (S: a k16 step at a time over d; P V: a
// k16 step at a time over the chunk's keys).
template <int DP>
__device__ __forceinline__ void stream_bf16(const __nv_bfloat16* __restrict__ qkv,
                                            __nv_bfloat16* __restrict__ out, int items,
                                            int L, int S, int C, int H, int d, float scale,
                                            int qblocks, int vb, int vo,
                                            unsigned char* smem_raw, int tma,
                                            const CUtensorMap* tm) {
  using T = __nv_bfloat16;
  using Rg = Bf16Ring<DP>;
  constexpr int NV = STREAM_KC / 2, ST = Rg::STAGES;
  uint8_t* sm = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int wgs = (blockDim.x - 32) >> 7;          // consumer warpgroups
  const int nq = (int)gridDim.x < items ? 2 : 1;   // Q buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Rg::bar_off(wgs, nq));
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;                    // [2]: the two Q buffers
  uint64_t* qempty = qfull + 2;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int C3 = 3 * C, nc = (L + STREAM_KC - 1) / STREAM_KC, steps = 2 * nc;

  // Q by TMA where its boxes hold nothing past d (d = DP), else by the
  // producer's cp.async into buffers whose columns past d are zeros (they
  // cancel K's columns past d, which a TMA box takes from the next head;
  // rows past L hold finite rows of an earlier item or zeros, their
  // outputs never stored; K's and V's rows past L too where the producer
  // copies with cp.async, which p = 0 multiplies in V)
  const bool q_tma = tma && d == DP;
  zero_smem(sm, Rg::bar_off(wgs, nq) / 16);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, tma ? 1 : 32);   // the TMA's thread, or the producer's lanes
      mbar_init(empty + i, 4 * wgs);       // every consumer warp, done with the stage
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, q_tma ? 1 : 32);
      mbar_init(qempty + i, 4 * wgs);
    }
  }
  __syncthreads();     // the zeros and the barriers are there before any copy or wait

  // Work items (unit, block of 64 * wgs queries): item i at CTA i %
  // gridDim.x, which walks its items in turn; the grid fills the SMs once,
  // so the next item's Q and first chunks load while this one's last steps
  // run.  Chunks count on across items (chunk k in stage k % ST), Q's
  // buffers alternate (item j of a CTA in buffer j % 2).
  struct Item {
    long long base;     // token 0's row (layout S)
    int h, qc, row0, r; // head, first query, the map's row of token 0, its column block
  };
  auto item = [&](int i) {
    const int unit = i / qblocks, seq = unit / H;
    Item it;
    it.h = unit - seq * H;
    it.qc = (i - unit * qblocks) * wgs * WG_ROWS;
    it.row0 = seq / S * L;
    it.r = seq % S;
    it.base = (long long)it.row0 * S + it.r;
    return it;
  };

  if (wg == wgs) {
    // the producer warp: an item's Q, then step i < nc chunk i of K, nc + i
    // chunk i of K and V, each into its stage once every consumer is done
    // with the stage's previous chunk.  By TMA (one thread, 64-row boxes of
    // the map over qkv: a box past L holds the next sequence's rows or
    // zeros, past d the next columns, all finite; Q's zero columns cancel
    // K's, p = 0 V's rows, and V's columns past d are never stored), else
    // by the warp's cp.async
    int k = 0, j = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
      const Item it = item(i);
      const T* src = qkv + (long long)it.h * d;
      const int qb = j & 1;
      uint8_t* qbuf = sm + Rg::Q_OFF + qb * wgs * Rg::PART;
      if (j >= 2) mbar_wait(qempty + qb, ((j >> 1) - 1) & 1);
      if (q_tma) {
        if (lane == 0) {
          mbar_expect_tx(qfull + qb, wgs * Rg::PART);
          for (int w = 0; w < wgs; ++w)
#pragma unroll
            for (int sl = 0; sl < Rg::NSL; ++sl)
              tma_load_3d(qbuf + (w * Rg::NSL + sl) * Rg::TILE, tm, qfull + qb,
                          it.h * d + 64 * sl, it.r, it.row0 + it.qc + w * WG_ROWS);
        }
      } else {
        copy_tiles<Rg::NSL>(vb, qbuf, src, it.base, S, C3, it.qc,
                            L - it.qc < wgs * WG_ROWS ? L - it.qc : wgs * WG_ROWS, d, lane, 32);
        __threadfence_block();    // (the 2-byte copies are plain stores)
        mbar_arrive_copies(qfull + qb);
      }
      for (int step = 0; step < steps; ++step, ++k) {
        const int st = k % ST;
        const bool pass2 = step >= nc;
        const int k0 = (pass2 ? step - nc : step) * STREAM_KC;
        uint8_t* stage = sm + st * 2 * Rg::PART;
        if (tma) {
          if (lane == 0) {
            if (k >= ST) mbar_wait(empty + st, (k / ST - 1) & 1);
            mbar_expect_tx(full + st, (pass2 ? 2 : 1) * Rg::PART);
#pragma unroll
            for (int sl = 0; sl < Rg::NSL; ++sl) {
              tma_load_3d(stage + sl * Rg::TILE, tm, full + st, C + it.h * d + 64 * sl, it.r,
                          it.row0 + k0);
              if (pass2)
                tma_load_3d(stage + Rg::PART + sl * Rg::TILE, tm, full + st,
                            2 * C + it.h * d + 64 * sl, it.r, it.row0 + k0);
            }
          }
        } else {
          if (k >= ST) mbar_wait(empty + st, (k / ST - 1) & 1);
          const int rows = L - k0 < STREAM_KC ? L - k0 : STREAM_KC;
          copy_tiles<Rg::NSL>(vb, stage, src + C, it.base, S, C3, k0, rows, d, lane, 32);
          if (pass2)
            copy_tiles<Rg::NSL>(vb, stage + Rg::PART, src + 2 * C, it.base, S, C3, k0, rows, d,
                                lane, 32);
          __threadfence_block();
          mbar_arrive_copies(full + st);
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // e = 2^(s * scale2 - mx): the scale and log2(e) folded into one FFMA
  // before ex2.approx (the softmax's instructions bound the kernel)
  const float scale2 = scale * 1.4426950408889634f;
  int k = 0, j = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
    const Item it = item(i);
    const int q0 = it.qc + wg * WG_ROWS;                  // the warpgroup's first query
    const int qb = j & 1;
    const uint8_t* qt = sm + Rg::Q_OFF + (qb * wgs + wg) * Rg::PART;   // the warpgroup's Q
    mbar_wait(qfull + qb, (j >> 1) & 1);
    if (!q_tma) async_proxy_fence();
    float o[DP / 2], mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int n = 0; n < DP / 2; ++n) o[n] = 0.f;
    for (int step = 0; step < steps; ++step, ++k) {
      const int st = k % ST;
      mbar_wait(full + st, (k / ST) & 1);    // the chunk has landed
      if (!tma) async_proxy_fence();        // (cp.async writes; TMA's are the async proxy's)
      const bool pass2 = step >= nc;
      const int k0 = (pass2 ? step - nc : step) * STREAM_KC;
      const uint8_t* stage = sm + st * 2 * Rg::PART;
      // S = Q K^T over the chunk (a warpgroup past L computes on zero or
      // finite rows and stores nothing: a branch on it would serialise the
      // wgmmas)
      float s[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) s[e] = 0.f;
      wg_fence();
#pragma unroll
      for (int sl = 0; sl < Rg::NSL; ++sl) {
        const uint64_t qd = tile_desc(qt + sl * Rg::TILE), kd = tile_desc(stage + sl * Rg::TILE);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgBf16<STREAM_KC, 0>::ss(s, qd + 2 * kk, kd + 2 * kk, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);
      if (!pass2) arrive_warp(empty + st);     // this warp is done with the stage
      if (step + 1 == steps) arrive_warp(qempty + qb);   // and with Q
      // keys past L masked in the last chunk (value 4n + 2q + {0, 1}: row
      // g + 8q, key 8n + 2t + {0, 1})
      if (k0 + STREAM_KC > L)
#pragma unroll
        for (int e = 0; e < NV; ++e)
          if (k0 + 8 * (e >> 2) + 2 * t + (e & 1) >= L) s[e] = -INFINITY;
      if (!pass2) {
        // the rows' max (in units of log2, mx) and sum over one more chunk
        float cm[2] = {-INFINITY, -INFINITY}, cs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < NV; ++e) cm[(e >> 1) & 1] = fmaxf(cm[(e >> 1) & 1], s[e]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float m = fmaxf(mx[q], quad_max(cm[q]) * scale2);
          sum[q] *= ex2(mx[q] - m);     // 0 on the first chunk
          mx[q] = m;
        }
#pragma unroll
        for (int e = 0; e < NV; ++e)
          cs[(e >> 1) & 1] += ex2(fmaf(s[e], scale2, -mx[(e >> 1) & 1]));
#pragma unroll
        for (int q = 0; q < 2; ++q) sum[q] += quad_sum(cs[q]);
        continue;
      }
      if (k0 == 0)
#pragma unroll
        for (int q = 0; q < 2; ++q) inv[q] = 1.f / sum[q];
      // p = T(e * (1 / sum)) as the A fragment of each 16 keys: n8 tiles
      // 2j and 2j + 1 of S make one k16 fragment, as tile_bf16 packs it
      uint32_t pa[STREAM_KC / 16][4];
#pragma unroll
      for (int jj = 0; jj < STREAM_KC / 16; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 8 * jj + 2 * x;
          pa[jj][x] = pack_bf16(ex2(fmaf(s[e], scale2, -mx[x & 1])) * inv[x & 1],
                                ex2(fmaf(s[e + 1], scale2, -mx[x & 1])) * inv[x & 1]);
        }
      wg_fence();
#pragma unroll
      for (int jj = 0; jj < STREAM_KC / 16; ++jj)
        WgBf16<DP, 1>::rs(o, pa[jj], Rg::v_desc(stage + Rg::PART + jj * 16 * 128), 1);
      wg_commit();
      wg_wait0();
      fence_regs(o);
      arrive_warp(empty + st);
    }
    // rows q0 + 16 warp + g (+ 8), columns < d: accumulator 4n + 2q + {0, 1}
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = q0 + 16 * warp + g + 8 * q;
      if (row >= L) continue;
      T* y = out + (long long)it.h * d + (it.base + (long long)row * S) * C;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = 8 * n + 2 * t;
        const __nv_bfloat162 v = __floats2bfloat162_rn(o[4 * n + 2 * q], o[4 * n + 2 * q + 1]);
        if (vo) {
          if (col < d) *reinterpret_cast<__nv_bfloat162*>(y + col) = v;
        } else {
          if (col < d) y[col] = v.x;
          if (col + 1 < d) y[col + 1] = v.y;
        }
      }
    }
  }
}

// One CTA: 64-query blocks (blockIdx.x % qblocks) * (blockDim.x / 128).. of
// unit blockIdx.x / qblocks (sequence u / H, head u % H), rows laid out with
// S as attention_tc_kernel's; vb the copy width in bytes, vo: two values a
// store.
template <typename T, int DP>
__global__ void __launch_bounds__(stream_threads(sizeof(T), DP))
attention_stream_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L, int S, int C,
                        int H, int d, float scale, int qblocks, int vb, int vo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  stream_f32<DP>(qkv, out, L, S, C, H, d, scale, qblocks, vb, vo, smem_raw);
}

// The same for bf16, with qkv's TMA map (tma: 1 where the map is good, 0:
// the producer warp copies with cp.async instead); at dp = 64 two CTAs an
// SM.
template <typename T, int DP>
__global__ void __launch_bounds__(stream_threads(sizeof(T), DP), DP > 64 ? 1 : 2)
attention_stream_kernel(const T* __restrict__ qkv, T* __restrict__ out, int items, int L,
                        int S, int C, int H, int d, float scale, int qblocks, int vb, int vo,
                        int tma, const __grid_constant__ CUtensorMap tm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  stream_bf16<DP>(qkv, out, items, L, S, C, H, d, scale, qblocks, vb, vo, smem_raw, tma, &tm);
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (nothing
// new is linked), or nullptr
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 qkv, seqs sequences of L tokens laid out with S:
// (3C columns, S, seqs / S * L token rows), row q * L + l of column block
// r at row (q * L + l) * S + r of qkv; boxes of 64 columns x 1 x 64 tokens,
// 128-byte swizzled, zeros past the end.  False where TMA cannot take it
// (the address or the row stride not a multiple of 16 bytes).
inline bool encode_qkv(CUtensorMap* map, const void* qkv, long long seqs, int L, int S, int C) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(qkv) % 16 || (6LL * C) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)(3LL * C), (cuuint64_t)S, (cuuint64_t)(seqs / S * L)};
  const cuuint64_t strides[2] = {(cuuint64_t)(6LL * C), (cuuint64_t)(6LL * C * S)};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)STREAM_KC}, step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
cudaError_t launch_stream(const T* qkv, T* out, long long seqs, int L, int S, int C, int H,
                          int d, float scale, int vb, cudaStream_t stream) {
  constexpr int size = (int)sizeof(T), smem = stream_smem(size, DP);
  static_assert(smem <= SMEM_MAX, "a streamed CTA's shared memory");
  static_assert(smem == (size == 2 ? Bf16Ring<DP>::SMEM : FwdTiles<DP>::SMEM),
                "the tiles and stream_smem agree");
  // the kernel: float32 or bf16 (with the TMA map), one name
  using F32Kernel = void (*)(const T*, T*, int, int, int, int, int, float, int, int, int);
  using Bf16Kernel = void (*)(const T*, T*, int, int, int, int, int, int, float, int, int, int,
                              int, CUtensorMap);
  const void* kernel;
  if constexpr (size == 4)
    kernel = (const void*)(F32Kernel)attention_stream_kernel<T, DP>;
  else
    kernel = (const void*)(Bf16Kernel)attention_stream_kernel<T, DP>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // float32: two warpgroups a CTA; bf16: stream_wgs consumer warpgroups,
  // their Q tiles among the shared memory, and a producer warp
  const int wgs = size == 4 ? 2 : stream_wgs(DP, L);
  const int qblocks = ((L + 63) / 64 + wgs - 1) / wgs;
  const long long grid = seqs * H * qblocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vo = d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  if constexpr (size == 4) {
    ((F32Kernel)attention_stream_kernel<T, DP>)<<<(unsigned)grid, 256, smem, stream>>>(
        qkv, out, L, S, C, H, d, scale, qblocks, vb, vo);
  } else {
    CUtensorMap tm{};
    // (a box must start on 16 bytes: each head row a multiple of them, vb)
    const int tma = vb == 16 && encode_qkv(&tm, qkv, seqs, L, S, C);
    // persistent CTAs: as many as the SMs hold at once, each walking its
    // work items (with fewer items, a CTA an item and one Q buffer)
    const auto kernel = (Bf16Kernel)attention_stream_kernel<T, DP>;
    const int threads = 128 * wgs + 32;
    // the CTAs a card holds at once, asked once a device (of the first 16)
    // and warpgroup count
    static std::atomic<int> held[16][4];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    int most = dev < 16 ? held[dev][wgs].load(std::memory_order_relaxed) : 0;
    if (most == 0) {
      int sms = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                               Bf16Ring<DP>::smem(wgs, 2))) !=
              cudaSuccess)
        return err;
      most = sms * (per_sm > 0 ? per_sm : 1);
      if (dev < 16) held[dev][wgs].store(most, std::memory_order_relaxed);
    }
    const long long ctas = grid < most ? grid : most;
    kernel<<<(unsigned)ctas, threads, Bf16Ring<DP>::smem(wgs, ctas < grid ? 2 : 1), stream>>>(
        qkv, out, (int)grid, L, S, C, H, d, scale, qblocks, vb, vo, tma, tm);
  }
  return counted(LAUNCH_ATTENTION_STREAM, cudaGetLastError());
}

// One warp's 16-query tile in float32: q its first row, k and v the unit's
// tiles (nc key chunks of 16 * NKT keys); o: this lane's output fragments,
// (row g + 8r, columns 8n + 2t, + 1) at o[n][2r], o[n][2r + 1].  S = Q K^T
// as three TF32 m16n8k8 products hi*hi + (lo*hi + hi*lo) (x_hi = tf32(x),
// x_lo = tf32(x - x_hi), as gemm_sm90.cuh splits them; the two small ones
// summed apart and added in one FADD, since the tensor cores' accumulation
// truncates); the softmax on the fragments, a row's max and sum across its
// quad; p = T(e * (1 / sum)) repacked as the A operand of P V (keys 2t, 2t
// + 1 of an n8 tile as k columns t, t + 4, V's rows read in that order),
// three products again.  DEAD: the last n8 tile of keys lies wholly past L
// and is skipped (its logits would be -inf and its p exact zeros, so every
// accumulator sees the same products in the same order either way).
template <int DP, int NKT, bool DEAD>
__device__ __forceinline__ void tile_f32(float (&o)[DP / 8][4], const float* q, const float* k,
                                         const float* v, int L, int nc, float scale) {
  constexpr int STRIDE = row_stride(DP, 4), KC = 16 * NKT, KS = DP / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto dead = [](int j, int n) { return DEAD && j == NKT - 1 && n == 1; };

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
        if (!dead(j, n))
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
  // e = exp(s - max) over the live n8 tiles, and their sums cs
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  auto exps = [&](float (&cs)[2]) {
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        if (!dead(j, n))
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][n][e] = expf(s[j][n][e] - mx[e >> 1]);
            cs[e >> 1] += s[j][n][e];
          }
  };

  // beyond one chunk: the rows' max and sum over the chunks, then the
  // products with the logits computed again
  const int chunks = NKT == CHUNK_TILES ? nc : 1;
  for (int c = 0; c < chunks; ++c) {
    logits(c);
    float cm[2] = {-INFINITY, -INFINITY}, cs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][n][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], quad_max(cm[r]));
      sum[r] *= expf(mx[r] - m);     // 0 on the first chunk
      mx[r] = m;
    }
    exps(cs);
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] += quad_sum(cs[r]);
  }

  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if constexpr (NKT == CHUNK_TILES) {
      logits(c);
      float cs[2] = {0.f, 0.f};
      exps(cs);
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        if (!dead(j, n)) {
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
}

// This lane's output rows of a tile (queries q0..q0 + 15) straight from its
// fragments: row l of the unit at y0 + l * S * C; two values a store where
// vo (d even, out 8-byte aligned), else one.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 8][4], float* y0, int S, int C,
                                           int L, int q0, int d, int vo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = q0 + g + 8 * r;
    if (l >= L) continue;
    float* y = y0 + (long long)l * S * C;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (vo) {
        if (col < d)
          *reinterpret_cast<float2*>(y + col) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      } else {
        if (col < d) y[col] = o[n][2 * r];
        if (col + 1 < d) y[col + 1] = o[n][2 * r + 1];
      }
    }
  }
}

// The float32 kernel (the same name as the bf16 one, told apart by its
// arguments): the group of U units from unit blockIdx.x * U on, copied in as
// the bf16 kernel copies (cp.async by every thread, vb bytes a copy), then
// one 16-query tile a warp at a time, its output stored from the fragments
// (vo: two values a store); nc key chunks of 16 * NKT keys; DEAD: the last
// n8 tile of keys lies wholly past L (tile_f32).
template <typename T, int DP, int NKT, bool DEAD>
__global__ void __launch_bounds__(32 * f32_warps(NKT))
attention_tc_kernel(const T* __restrict__ qkv, T* __restrict__ out, long long seqs, int L,
                    int S, int C, int H, int d, float scale, int U, int nc, int vb, int vo) {
  static_assert(sizeof(T) == 4, "bf16 runs on the kernel above");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  constexpr int STRIDE = row_stride(DP, 4), KS = DP / 8;
  const int lpa = nc * 16 * NKT, qbs = (L + 15) / 16;
  const Group u((long long)blockIdx.x * U, U, seqs * H, H, L, S);
  const int n = u.G * u.HG;

  move_rows<true>(vb, u, qkv, out, sm, C, d, lpa, STRIDE);
  zero_pads<float, DP>(sm, n, L, d, lpa);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int tile = threadIdx.x >> 5; tile < n * qbs; tile += blockDim.x >> 5) {
    const int ul = tile / qbs, q0 = (tile - ul * qbs) * 16;
    const float* ut = sm + (long long)ul * 3 * lpa * STRIDE;
    const int sl = ul / u.HG, hl = ul - sl * u.HG;
    float o[KS][4];
    tile_f32<DP, NKT, DEAD>(o, ut + q0 * STRIDE, ut + lpa * STRIDE, ut + 2 * lpa * STRIDE, L, nc,
                            scale);
    store_rows<DP>(o, out + u.row(sl, 0) * C + (long long)(u.h0 + hl) * d, S, C, L, q0, d, vo);
  }
}

// The float32 kernel's launch: U the most units (U | H or H | U) in
// SMEM_TARGET, a warp a tile of the group (at most f32_warps(NKT)).
template <int DP, int NKT, bool DEAD>
cudaError_t launch_f32(const float* qkv, float* out, long long seqs, int L, int S, int C, int H,
                       int d, float scale, int vb, cudaStream_t stream) {
  using Fn = void (*)(const float*, float*, long long, int, int, int, int, int, float, int, int,
                      int, int);
  const Fn kernel = attention_tc_kernel<float, DP, NKT, DEAD>;
  const long long ub = unit_bytes(4, L, d);
  int U = 1;
  for (int u = 2; u * ub <= SMEM_TARGET; ++u)
    if (H % u == 0 || u % H == 0) U = u;
  const size_t smem = (size_t)(U * ub);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long grid = (seqs * H + U - 1) / U;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int kc = 16 * NKT, tiles = U * ((L + 15) / 16);
  const int vo = d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const int warps = tiles < f32_warps(NKT) ? tiles : f32_warps(NKT);
  kernel<<<(unsigned)grid, 32 * warps, smem, stream>>>(qkv, out, seqs, L, S, C, H, d, scale, U,
                                                       (L + kc - 1) / kc, vb, vo);
  return counted(LAUNCH_ATTENTION_TC, cudaGetLastError());
}

// dead: the last n8 tile of keys lies wholly past L (L 8 or more short of
// the 16-key tiles; never on the chunked path)
template <int DP, int NKT>
cudaError_t launch_f32_nkt(const float* qkv, float* out, long long seqs, int L, int S, int C,
                           int H, int d, float scale, int vb, cudaStream_t stream) {
  if (NKT != CHUNK_TILES && (L + 7) / 8 < 2 * NKT)
    return launch_f32<DP, NKT, true>(qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
  return launch_f32<DP, NKT, false>(qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
}

template <int DP>
cudaError_t launch_f32_dp(int nkt, const float* qkv, float* out, long long seqs, int L, int S,
                          int C, int H, int d, float scale, int vb, cudaStream_t stream) {
  switch (nkt) {
    case 2: return launch_f32_nkt<DP, 2>(qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
    case 3: return launch_f32_nkt<DP, 3>(qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
    case 5: return launch_f32_nkt<DP, 5>(qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
    case CHUNK_TILES:
      // past 144 keys only d <= 32 stays resident (variant())
      if constexpr (DP == 32)
        return launch_f32<DP, CHUNK_TILES, false>(qkv, out, seqs, L, S, C, H, d, scale, vb,
                                                  stream);
      else
        return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
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
  const int nkt = key_tiles(L);
  if constexpr (sizeof(T) == 4) {
    if (nkt == 9) {
      // 81-144 keys on wgmma: 16-byte loads where every row and head start
      // is 16-byte aligned, two values a store where d and out allow
      const int vec = d % 4 == 0 && C % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
      const int vo = d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
      return L <= 2 * WG_ROWS
                 ? launch_wg_nb<2>(qkv, out, seqs, L, S, C, H, d, scale, vec, vo, stream)
                 : launch_wg_nb<3>(qkv, out, seqs, L, S, C, H, d, scale, vec, vo, stream);
    }
    switch (padded_dim(d)) {
      case 32: return launch_f32_dp<32>(nkt, qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
      case 48: return launch_f32_dp<48>(nkt, qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
      default: return launch_f32_dp<64>(nkt, qkv, out, seqs, L, S, C, H, d, scale, vb, stream);
    }
  } else {
    const long long ub = unit_bytes(size, L, d);
    // U: the most units (U | H or H | U) in SMEM_TARGET
    int U = 1;
    for (int u = 2; u * ub <= SMEM_TARGET; ++u)
      if (H % u == 0 || u % H == 0) U = u;
    const int kc = 16 * nkt;
    const Launch<T> a{qkv, out, seqs, L, S, C, H, d, scale, U, (L + kc - 1) / kc, vb,
                      (size_t)(U * ub)};
    switch (padded_dim(d)) {
      case 32: return launch_dp<T, 32>(nkt, a, stream);
      case 48: return launch_dp<T, 48>(nkt, a, stream);
      default: return launch_dp<T, 64>(nkt, a, stream);
    }
  }
}

}  // namespace
