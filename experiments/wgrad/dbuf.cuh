// The parent design of the weight-gradient kernel with two pair
// accumulators (pa, pb) taken in turn, so a pair's FADDs run at the next
// pair's first k-steps instead of after a drain, for experiments/wgrad/run.py
// (the tree spec NAME=DIR+dbuf).  The same bits; 64 more registers at BN =
// 128.

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
constexpr int THREADS = 384;                    // two product warpgroups + the splitting one
constexpr int PRODUCT_REGS = 232, SPLIT_REGS = 40;     // setmaxnreg: 256 x 232 + 128 x 40 <= 64K
constexpr int CHUNK_ALIGN = 64;                 // a chunk is whole pairs of slices
constexpr int WAVE = 132;                       // the rule's SMs (an H100 SXM)
constexpr int ITEM_OVERHEAD = 64;               // the rule's cost of an item, in rows
// stages, split slices, barriers, 1 KB for the alignment
constexpr int SMEM =
    RAW_STAGES * RAW_STAGE + CONV_BUFS * CONV + (RAW_STAGES + 2 * CONV_BUFS) * 8 + 1024;
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

// The copies of one raw slice when p (thread 0): the transaction's bytes
// on the stage's barrier, then D's and X's four boxes.  Predicated rather
// than branched on the thread, so no divergent path crosses the wgmmas in
// flight.
__device__ __forceinline__ void load_slice(uint8_t* dst, const CUtensorMap* tm_d,
                                           const CUtensorMap* tm_x, uint64_t* bar, int n0,
                                           int k0, int m, int p) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}" ::"r"(sm90::smem_u32(bar)),
      "r"(RAW_STAGE), "r"(p)
      : "memory");
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const CUtensorMap* map = b < 4 ? tm_d : tm_x;
    const int c0 = (b < 4 ? n0 : k0) + 32 * (b & 3);
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
        "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n}" ::"r"(sm90::smem_u32(dst + b * BOX)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(m), "r"(p)
        : "memory");
  }
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
  uint64_t* split_full = full + RAW_STAGES;               // a split buffer is whole
  uint64_t* split_free = split_full + CONV_BUFS;          // and read by every wgmma

  const int k_tiles = (K + BN - 1) / BN;
  const long long per_chunk = (long long)((N + BM - 1) / BM) * k_tiles;
  const long long n_items = per_chunk * chunks;
  const long long E = (long long)N * K + N;               // floats of a chunk's partial
  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) sm90::mbar_init(&full[s], 1);
    for (int b = 0; b < CONV_BUFS; ++b) {
      sm90::mbar_init(&split_full[b], 128);   // every splitting thread
      sm90::mbar_init(&split_free[b], 8);     // a lane of each product warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

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
      }
    }
    return;
  }

  // The two product warpgroups: no branch on the thread around a wgmma
  // (ptxas would serialise them: C7518), so the copies and the barrier
  // arrivals are predicated instead.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PRODUCT_REGS));
  // The copies run RAW_STAGES slices ahead of the products, along the CTA's
  // slices in order (its items blockIdx.x, + gridDim.x, ...; each item's
  // slices): slice i into stage i % RAW_STAGES, issued by thread 0 once the
  // product warps are done with the slice that stage held (the barrier
  // that ends each slice; its X was split before its products began).  lp:
  // the next slice to copy, lw its item.
  long long lp_item = blockIdx.x;
  int lp_s = 0, lp_i = 0;
  Item lw = item_of<BN>(lp_item, per_chunk, k_tiles, M, rows);
  auto load_next = [&]() {
    if (lp_item < n_items) {
      const int st = lp_i % RAW_STAGES;
      load_slice(raw + st * RAW_STAGE, &tm_d, &tm_x, &full[st], lw.n0, lw.k0,
                 (int)(lw.r0 + (long long)ROWS * lp_s), threadIdx.x == 0);
      ++lp_i;
      if (++lp_s == lw.slices) {
        lp_s = 0;
        lp_item += gridDim.x;
        if (lp_item < n_items) lw = item_of<BN>(lp_item, per_chunk, k_tiles, M, rows);
      }
    }
  };
#pragma unroll 1
  for (int i = 0; i < RAW_STAGES; ++i) load_next();

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's A rows (n, the D columns, of the tile) nn and nn + 8
  const int nn = 64 * wg + 16 * warp + g;

  float acc[BN / 2], pa[BN / 2], pb[BN / 2];
  float bs[2];                            // the bias sums of rows nn, nn + 8
  int it = 0;
  // A pair of slices into cur (a fresh accumulator), and the pair before's
  // products (prev) added to acc at its first slice's k-step 1, where every
  // wgmma of that pair is done: the tensor cores run this pair's first
  // products meanwhile, and no warpgroup drains its wgmmas between pairs.
  auto pair = [&](float (&cur)[BN / 2], const float (&prev)[BN / 2]) {
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
        // free, and at the pair's first slice the pair before is whole
        sm90::wgmma_wait<1>();
        if (kk == 1) {
          sm90::arrive_if(&split_free[(it + CONV_BUFS - 1) % CONV_BUFS], lane == 0 && it > 0);
          if (!half) {
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) acc[q] += prev[q];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = pv[e];
          ah[kk & 1][e] = sm90::tf32_bits(v);
          al[kk & 1][e] = sm90::tf32_bits(v - __uint_as_float(ah[kk & 1][e]));
          bs[e & 1] += v;
        }
        sm90::wgmma_fence();
        sm90::WgmmaRs<BN>::tf32(cur, al[kk & 1], bh + 2 * kk, half || kk);   // lo * hi
        sm90::WgmmaRs<BN>::tf32(cur, ah[kk & 1], bl + 2 * kk, 1);           // hi * lo
        sm90::WgmmaRs<BN>::tf32(cur, ah[kk & 1], bh + 2 * kk, 1);           // hi * hi
        sm90::wgmma_commit();
      }
      // both product warpgroups are done with slice it's raw stage (its X
      // was split before its products began): the stage takes slice it +
      // RAW_STAGES
      asm volatile("bar.sync 1, 256;" ::: "memory");
      load_next();
    }
  };

#pragma unroll 1
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item w = item_of<BN>(item, per_chunk, k_tiles, M, rows);
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = pb[q] = 0.f;
    bs[0] = bs[1] = 0.f;
    // the pairs alternate between pa and pb, two a step; the sums keep
    // their order (((0 + 0) + pair 0) + pair 1) + ...
    const int pairs = w.slices / 2;
#pragma unroll 1
    for (int pr = 0;; pr += 2) {
      pair(pa, pb);
      if (pr + 1 == pairs) break;
      pair(pb, pa);
      if (pr + 2 == pairs) break;
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] += pairs & 1 ? pa[q] : pb[q];

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
  const auto kernel = wgrad_wgmma_kernel<BN>;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  // the SM count, and the kernel's shared-memory attribute set, once a
  // device (of the first 16) and instantiation
  static std::atomic<int> sms_of[16];
  int sms = dev < 16 ? sms_of[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if (dev < 16) sms_of[dev].store(sms, std::memory_order_relaxed);
  }
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
