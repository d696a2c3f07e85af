// The weight- and bias-gradient products of the training backward (kernel
// #6, block_train.cu's weight_grads), for Hopper (sm_90a):
//
//   P[p] = D_p^T X_p (N x K)  and  b[p] = the column sums of D_p (N)
//
// for each fixed chunk p of rows of D (M, N) and X (M, K), both float32
// row-major; block_train.cu's reduce_partials_kernel then sums the chunks
// in order.  Replaces, with the ordered pass, the parameter-gradient sums
// of pafuse_tpu/ops/block_grad.py::_train_bwd_kernel (dwfc2 = gu^T dm,
// dbfc2 = sum(dm), and the same for fc1, proj and qkv), which the TPU grid
// accumulates in order into revisited output blocks.
//
// What bounds it on an H100 (data-sheet peaks at 700 W): three TF32
// products a product, as gemm_sm90.cuh takes them (x_hi = tf32(x), x_lo =
// tf32(x - x_hi); lo*hi + hi*lo + hi*hi), so 2 M N K FLOPs at 495 / 3 =
// 165 TFLOP/s against M (N + K) * 4 bytes: hundreds of FLOPs a byte, bound
// by the tensor cores.  A slice of 32 rows keeps them busy for 1536 cycles
// (two warpgroups x 4 k-steps x 3 m64n128k8 wgmmas); what it moves through
// shared memory must fit in that time at 128 bytes a cycle.
//
// Design.  The summed index m is the row of both D and X, so neither
// operand of dW = D^T X arrives K-major, which TF32 wgmma needs (its
// transposing layouts are for 16-bit types only):
//   * A persistent CTA per SM walks work items (chunk, 128 x BN tile), the
//     tiles of one chunk next to each other (they share the chunk's rows in
//     L2).  BN = 128, or 112 or 96 where that tiles K and 128 does not
//     (the face widths; 3DHP's and the monolithic model's).  512 threads:
//     two product warpgroups of 64 n-rows each, a splitting warpgroup and a
//     copying one (setmaxnreg PRODUCT_REGS, SPLIT_REGS, COPY_REGS).
//   * A ring of RAW_STAGES raw slices, copied by TMA: 32 rows of D's 128
//     columns and of X's 128 columns, in 32-column 128-byte-swizzled boxes
//     of 2-D maps over the row-major arrays, so one thread issues the
//     copies and the hardware zero-fills past M, N and K.  One thread of
//     the copying warpgroup issues them once every warp that read a stage
//     is done with it (raw_free: a lane of each product and splitting warp
//     arrives).  The product warps issue no copy and wait on no barrier of
//     each other's: where every product thread issued the copies predicated
//     (the design before this one), ptxas's loop around each TMA instruction cost
//     each product warp ~20% of its cycles, and the barrier that ended each
//     slice held both warpgroups together.
//   * A = D^T comes from registers (wgmma's RS form): each product thread
//     reads its A fragments straight from the raw D slice and splits them,
//     so every element of D is read and split once per CTA and never
//     written back.  B = X^T is split once per CTA by the splitting
//     warpgroup into a K-major hi and lo tile (a row of 32 m-values per
//     column k: one 128-byte swizzle row, the layout smem_desc reads), up to
//     CONV_BUFS - 1 slices ahead of the products, on mbarriers (a buffer
//     whole; its wgmmas done, an arrival from a lane of each product warp).
//     The k-columns of a k-step hold the rows m =
//     8 kk + 2 t + u at fragment column t + 4 u (the A fragment's (g, t)
//     takes rows 2t and 2t + 1 of each 8): with the swizzle, both the
//     fragment reads of D and the column reads of X are free of bank
//     conflicts, and a k-step still sums the same 8 rows.
//   * Three products a k-step, smallest first (lo*hi, hi*lo, hi*hi), as
//     gemm_sm90.cuh's slice_products orders them, two k-steps in flight; each
//     pair of slices goes into a fresh accumulator (scale-d 0), added to the
//     f32 total with FADDs in order (the tensor cores' own accumulation
//     truncates).
//   * The bias sums come from the same reads: each thread adds its D values
//     of a column in row order (rows m with m % 8 in {2t, 2t + 1}), the four
//     threads of a quad are summed (s0 + s1) + (s2 + s3), and the CTAs of
//     the first k tile write them beside the chunk's partial.  D is read
//     once; no second pass over it.
//   * The chunk length is a function of (M, N, K) alone (chunk_rows), so two
//     identical calls sum in the same order and give the same bits: a
//     multiple of 64 rows (whole pairs of slices) that keeps the last wave
//     of (tile, chunk) items full on 132 SMs, preferring fewer chunks (fewer
//     partials to write and sum).  ops/block_train.py's
//     weight_grad_chunk_rows is the same rule.
// No branch on the thread surrounds a wgmma (ptxas serialises them: C7518
// for a branch on a lane, C7520 on a warpgroup's rows); every loop bound and
// branch around them is uniform across the product warpgroups.
//
// What it reaches (experiments/wgrad/run.py and chip_ab.py --only train,
// H100 80GB HBM3 at 700 W, with the ordered pass; PERF.md section 6):
// WGRAD_RATE_PLACEHOLDER
// What holds it (the same script's patches, which take one cost out at a
// time): not shared memory (a slice moves ~192 KB, ~1500 cycles at 128
// bytes a cycle, but taking the split's 32 KB of stores out saves 1%); the
// product warps' own work between the wgmmas (their fragment reads and TF32
// splits, ~12%) and the splitting warpgroup's (~8%) share the SMs' issue
// slots with the wgmmas, and without either the loop still reaches only
// ~67% of the tensor cores' rate.

#pragma once

#include "gemm_sm90.cuh"

namespace {

namespace wgrad {

constexpr int BM = 128;                         // n rows of a tile: two warpgroups
constexpr int ROWS = 32;                        // rows m of a slice
constexpr int BOX = 32 * ROWS * 4;              // a 32-column box of a slice: 4 KB
constexpr int RAW_OPERAND = 4 * BOX;            // 128 columns of D or of X
constexpr int RAW_STAGE = 2 * RAW_OPERAND;      // D's, then X's
constexpr int RAW_STAGES = 4;
constexpr int B_TILE = 128 * 128;               // room for BN <= 128 rows of 128 bytes
constexpr int CONV = 2 * B_TILE;                // X's split slice: hi, then lo
constexpr int CONV_BUFS = 3;                    // split slices in flight
// two product warpgroups, the splitting one and the copying one
constexpr int THREADS = 512;
// setmaxnreg: 256 x 216 + 128 x 40 + 128 x 40 = the 512 x 128 a CTA is
// launched with (224 a product thread would leave the copying thread 24,
// and it spills there)
constexpr int PRODUCT_REGS = 216, SPLIT_REGS = 40, COPY_REGS = 40;
constexpr int CHUNK_ALIGN = 64;                 // a chunk is whole pairs of slices
constexpr int WAVE = 132;                       // the rule's SMs (an H100 SXM)
constexpr int ITEM_OVERHEAD = 64;               // the rule's cost of an item, in rows
// stages, split slices, barriers, 1 KB for the alignment
constexpr int SMEM =
    RAW_STAGES * RAW_STAGE + CONV_BUFS * CONV + 2 * (RAW_STAGES + CONV_BUFS) * 8 + 1024;
static_assert(SMEM <= sm90::SMEM_LIMIT, "the ring must fit one CTA's shared memory");

// The tile width along K: 128 where that tiles K, else 112 or 96 where
// one of them does (the face widths 224 and 448; the 3DHP and monolithic
// widths 288 and 576), else 128.
inline int tile_n(int K) {
  if (K % 128 == 0) return 128;
  return K % 112 == 0 ? 112 : K % 96 == 0 ? 96 : 128;
}

inline long long tiles(int N, int K) {
  const int bn = tile_n(K);
  return (long long)((N + BM - 1) / BM) * ((K + bn - 1) / bn);
}

// Rows of a chunk for (M, N, K): over the chunk counts P, the rows R =
// ceil(M / P) rounded up to CHUNK_ALIGN (where that still gives P chunks),
// the R with the least cost ceil(tiles * P / WAVE) * (R + ITEM_OVERHEAD),
// the fewest chunks among equals.
inline long long chunk_rows(long long M, int N, int K) {
  const long long t = tiles(N, K);
  long long best_rows = CHUNK_ALIGN, best_cost = -1;
  for (long long p = 1; p <= (M + CHUNK_ALIGN - 1) / CHUNK_ALIGN; ++p) {
    const long long r = ((M + p - 1) / p + CHUNK_ALIGN - 1) / CHUNK_ALIGN * CHUNK_ALIGN;
    if ((M + r - 1) / r != p) continue;
    const long long cost = (t * p + WAVE - 1) / WAVE * (r + ITEM_OVERHEAD);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_rows = r;
    }
  }
  return best_rows;
}

inline long long chunks(long long M, int N, int K) {
  const long long r = chunk_rows(M, N, K);
  return (M + r - 1) / r;
}

// Floats of the partials: a chunk's N x K products, then its N column sums.
inline long long part_floats(long long M, int N, int K) {
  return chunks(M, N, K) * ((long long)N * K + N);
}

// Byte offset of value j (0..31) of row r in a 128-byte-swizzled box or
// tile: 16-byte chunk j / 4 at chunk (j / 4) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int j) {
  return r * 128 + ((((j >> 2) ^ r) & 7) << 4) + (j & 3) * 4;
}

// The copies of one raw slice into the stage at shared address dst, by the
// one thread that calls it: the transaction's bytes on the stage's barrier
// (bar), then D's and X's four boxes.
__device__ __forceinline__ void load_slice(uint32_t dst, const CUtensorMap* tm_d,
                                           const CUtensorMap* tm_x, uint32_t bar, int n0,
                                           int k0, int m) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(RAW_STAGE)
               : "memory");
#pragma unroll
  for (int b = 0; b < 8; ++b)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst + b * BOX),
        "l"(reinterpret_cast<uint64_t>(b < 4 ? tm_d : tm_x)), "r"(bar),
        "r"((b < 4 ? n0 : k0) + 32 * (b & 3)), "r"(m)
        : "memory");
}

// mbar_wait on the barrier at shared address bar
__device__ __forceinline__ void wait_u32(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

// *p = (a, b) when pred, as a predicated store
__device__ __forceinline__ void store2_if(float* p, float a, float b, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p st.global.v2.f32 [%0], {%1, %2};\n}" ::"l"(p),
      "f"(a), "f"(b), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void store_if(float* p, float a, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.f32 [%0], %1;\n}" ::"l"(p),
               "f"(a), "r"((int)pred)
               : "memory");
}

// A work item: chunk (slowest), n tile, k tile; its first row and slices,
// whole pairs of them (past M a slice is zeros: the last chunk's odd slice
// adds nothing).
struct Item {
  long long chunk, r0;
  int n0, k0, slices;
};

template <int BN>
__device__ __forceinline__ Item item_of(long long item, long long per_chunk, int k_tiles,
                                        long long M, long long rows) {
  Item w;
  w.chunk = item / per_chunk;
  const int tile = (int)(item - w.chunk * per_chunk);
  w.n0 = (tile / k_tiles) * BM;
  w.k0 = (tile % k_tiles) * BN;
  w.r0 = w.chunk * rows;
  const long long n = M - w.r0 < rows ? M - w.r0 : rows;
  w.slices = (int)(2 * ((n + 2 * ROWS - 1) / (2 * ROWS)));
  return w;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap tm_d,
                   const __grid_constant__ CUtensorMap tm_x, float* __restrict__ P,
                   long long M, int N, int K, long long rows, long long chunks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* raw = smem;                                    // [RAW_STAGES][D | X]
  uint8_t* conv = smem + RAW_STAGES * RAW_STAGE;          // [CONV_BUFS][hi | lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + CONV_BUFS * CONV);   // a stage landed
  uint64_t* raw_free = full + RAW_STAGES;                 // and read by every warp that reads it
  uint64_t* split_full = raw_free + RAW_STAGES;           // a split buffer is whole
  uint64_t* split_free = split_full + CONV_BUFS;          // and read by every wgmma

  const int k_tiles = (K + BN - 1) / BN;
  const long long per_chunk = (long long)((N + BM - 1) / BM) * k_tiles;
  const long long n_items = per_chunk * chunks;
  const long long E = (long long)N * K + N;               // floats of a chunk's partial
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&raw_free[s], 12);      // a lane of each product and splitting warp
    }
    for (int b = 0; b < CONV_BUFS; ++b) {
      sm90::mbar_init(&split_full[b], 128);   // every splitting thread
      sm90::mbar_init(&split_free[b], 8);     // a lane of each product warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 384) {
    // The copying warpgroup: one thread copies the CTA's slices in order
    // (its items blockIdx.x, + gridDim.x, ...; each item's slices), slice j
    // into stage j % RAW_STAGES once every warp that read the slice that
    // stage held is done with it (raw_free), so the product warps issue no
    // copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(COPY_REGS));
    if (threadIdx.x == 384) {
      // 32-bit shared addresses and rows (M < 2^31), the items walked by
      // carrying the grid's stride from the tile into the chunk: no 64-bit
      // division, so COPY_REGS registers hold the loop
      const uint32_t raw_u = sm90::smem_u32(raw), full_u = sm90::smem_u32(full),
                     free_u = sm90::smem_u32(raw_free);
      const int per = (int)per_chunk;
      int tile = (int)(blockIdx.x % per), j = 0;
      uint32_t r0 = (blockIdx.x / per) * (uint32_t)rows;     // wraps only past the last item
#pragma unroll 1
      for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int n0 = (tile / k_tiles) * BM, k0 = (tile % k_tiles) * BN;
        const int left = (int)M - (int)r0, n = left < (int)rows ? left : (int)rows;
        const int slices = 2 * ((n + 2 * ROWS - 1) / (2 * ROWS));
#pragma unroll 1
        for (int s = 0; s < slices; ++s, ++j) {
          const uint32_t st = j % RAW_STAGES;
          if (j >= RAW_STAGES) wait_u32(free_u + 8 * st, (j / RAW_STAGES - 1) & 1);
          load_slice(raw_u + st * RAW_STAGE, &tm_d, &tm_x, full_u + 8 * st, n0, k0,
                     (int)r0 + ROWS * s);
        }
        for (tile += gridDim.x; tile >= per; tile -= per) r0 += (uint32_t)rows;
      }
    }
    return;
  }

  if (threadIdx.x >= 256) {
    // The splitting warpgroup: X of each of the CTA's slices i, in order,
    // into the K-major hi and lo tiles of buffer i % CONV_BUFS (up to
    // CONV_BUFS - 1 slices ahead of the products).  Thread k takes column k
    // of the 128 copied (rows k >= BN of a tile are room no wgmma reads)
    // and the tile's 16-byte chunks c, each of the 4 rows m of its k-step
    // that sit at the chunk's fragment columns.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SPLIT_REGS));
    const int k = threadIdx.x - 256;
    int i = 0;
#pragma unroll 1
    for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int slices = item_of<BN>(item, per_chunk, k_tiles, M, rows).slices;
#pragma unroll 1
      for (int s = 0; s < slices; ++s, ++i) {
        sm90::mbar_wait(&full[i % RAW_STAGES], (i / RAW_STAGES) & 1);
        if (i >= CONV_BUFS) sm90::mbar_wait(&split_free[i % CONV_BUFS], (i / CONV_BUFS - 1) & 1);
        const uint8_t* col = raw + (i % RAW_STAGES) * RAW_STAGE + RAW_OPERAND + (k >> 5) * BOX;
        uint8_t* hi = conv + (i % CONV_BUFS) * CONV;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float h[4], l[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int m = 8 * (c >> 1) + (c & 1) + 2 * u;
            sm90::split_tf32(*reinterpret_cast<const float*>(col + swz(m, k & 31)), h[u], l[u]);
          }
          const int off = k * 128 + (((c ^ k) & 7) << 4);
          *reinterpret_cast<float4*>(hi + off) = *reinterpret_cast<const float4*>(h);
          *reinterpret_cast<float4*>(hi + B_TILE + off) = *reinterpret_cast<const float4*>(l);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        sm90::mbar_arrive(&split_full[i % CONV_BUFS]);
        // this warp has read slice i's X
        __syncwarp();
        if ((k & 31) == 0) sm90::mbar_arrive(&raw_free[i % RAW_STAGES]);
      }
    }
    return;
  }

  // The two product warpgroups: no branch on the thread around a wgmma
  // (ptxas would serialise them: C7518), so the barrier arrivals are
  // predicated instead.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PRODUCT_REGS));
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's A rows (n, the D columns, of the tile) nn and nn + 8
  const int nn = 64 * wg + 16 * warp + g;

  float acc[BN / 2], part[BN / 2];
  int it = 0;
#pragma unroll 1
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item w = item_of<BN>(item, per_chunk, k_tiles, M, rows);
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
    float bs[2] = {0.f, 0.f};             // the bias sums of rows nn, nn + 8
    // a pair of slices a step: the pair's drain and FADDs are straight-line
    // code after its second slice, so no control flow joins while a wgmma
    // that writes part is in flight (ptxas would wait there: C7517)
#pragma unroll 1
    for (int s = 0; s < w.slices; s += 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half, ++it) {
        const uint8_t* ds = raw + (it % RAW_STAGES) * RAW_STAGE;
        const uint8_t* bt = conv + (it % CONV_BUFS) * CONV;
        const uint64_t bh = sm90::smem_desc(bt), bl = sm90::smem_desc(bt + B_TILE);
        sm90::mbar_wait(&full[it % RAW_STAGES], (it / RAW_STAGES) & 1);
        sm90::mbar_wait(&split_full[it % CONV_BUFS], (it / CONV_BUFS) & 1);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A fragment e: row nn + 8 (e & 1), k column t + 4 (e >> 1), which
          // holds row m = 8 kk + 2 t + (e >> 1) of the slice; read before
          // the wait, split after it
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = nn + 8 * (e & 1), m = 8 * kk + 2 * t + (e >> 1);
            pv[e] = *reinterpret_cast<const float*>(ds + (n >> 5) * BOX + swz(m, n & 31));
          }
          // the group two back (the last to read set kk & 1) is done; from
          // kk = 1 on, every wgmma of slice it - 1 is: its split buffer is
          // free
          sm90::wgmma_wait<1>();
          if (kk == 1)
            sm90::arrive_if(&split_free[(it + CONV_BUFS - 1) % CONV_BUFS],
                            lane == 0 && it > 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = pv[e];
            ah[kk & 1][e] = sm90::tf32_bits(v);
            al[kk & 1][e] = sm90::tf32_bits(v - __uint_as_float(ah[kk & 1][e]));
            bs[e & 1] += v;
          }
          sm90::wgmma_fence();
          sm90::WgmmaRs<BN>::tf32(part, al[kk & 1], bh + 2 * kk, half || kk);   // lo * hi
          sm90::WgmmaRs<BN>::tf32(part, ah[kk & 1], bl + 2 * kk, 1);           // hi * lo
          sm90::WgmmaRs<BN>::tf32(part, ah[kk & 1], bh + 2 * kk, 1);           // hi * hi
          sm90::wgmma_commit();
        }
        // this warp has read its D of slice it
        sm90::arrive_if(&raw_free[it % RAW_STAGES], lane == 0);
        if (half) {
          sm90::wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < BN / 2; ++q) acc[q] += part[q];
        }
      }
    }

    // epilogue: accumulator 4j + 2h + {0, 1} is (row nn + 8h, col 8j + 2t + {0, 1})
    float* out = P + w.chunk * E;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int k = w.k0 + 8 * j + 2 * t;        // K % 8 == 0: k < K means k + 1 < K
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = w.n0 + nn + 8 * h;
        store2_if(out + (long long)n * K + k, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                  n < N && k < K);
      }
    }
    if (w.k0 == 0) {
      // the quad's four row-order sums of each column: (s0 + s1) + (s2 + s3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = bs[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int n = w.n0 + nn + 8 * h;
        store_if(out + (long long)N * K + n, v, t == 0 && n < N);
      }
    }
  }
}

template <int BN>
cudaError_t launch_bn(const float* D, const float* X, float* P, long long M, int N, int K,
                      cudaStream_t stream) {
  CUtensorMap md, mx;
  cudaError_t e;
  if ((e = sm90::encode_tile<float>(&md, D, M, N, ROWS)) != cudaSuccess ||
      (e = sm90::encode_tile<float>(&mx, X, M, K, ROWS)) != cudaSuccess)
    return e;
  auto kernel = wgrad_wgmma_kernel<BN>;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
      cudaSuccess)
    return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long rows = chunk_rows(M, N, K), nch = (M + rows - 1) / rows;
  const long long items = tiles(N, K) * nch;
  const unsigned grid = (unsigned)(items < sms ? items : sms);    // persistent
  kernel<<<grid, THREADS, SMEM, stream>>>(md, mx, P, M, N, K, rows, nch);
  return counted(LAUNCH_WGRAD_WGMMA, cudaGetLastError());
}

// The partials of D (M, N)^T X (M, K) and of D's column sums into P
// (part_floats(M, N, K) floats): N and K multiples of 8, 1 <= M < 2^31.
inline cudaError_t partials(const float* D, const float* X, float* P, long long M, int N,
                            int K, cudaStream_t stream) {
  if (M < 1 || M >= (1LL << 31) - ROWS || N < 8 || K < 8 || N % 8 || K % 8)
    return cudaErrorInvalidValue;
  switch (tile_n(K)) {
    case 112:
      return launch_bn<112>(D, X, P, M, N, K, stream);
    case 96:
      return launch_bn<96>(D, X, P, M, N, K, stream);
    default:
      return launch_bn<128>(D, X, P, M, N, K, stream);
  }
}

}  // namespace wgrad

}  // namespace
