// #6's LayerNorm backward in four designs, and two copies of the same bytes
// without the arithmetic, behind one launcher for run.py (float32, C up to
// 512): v 0, a warp a row, lnb_ctas CTAs an SM (block_train.cu's design);
// 1, the same with two rows of a warp in flight; 3, one row a warp at 2
// CTAs an SM up to 384 columns; 2, one CTA an SM whose producer warp fills
// a ring of shared memory with 1-D bulk copies (TMA) a stage of eight rows
// at a time for eight consumer warps; 4, a copy on design 0's grid; 5, a
// grid-stride copy at 2048 threads an SM.  Built by run.py with the
// library's nvcc flags; not part of the package.
#include "../../pafuse_tpu_torch/ops/csrc/gemm_sm90.cuh"
namespace {
constexpr int LNB_THREADS = 256, LNB_WARPS = 8, LNB_SMS = 132;
long long n_chunks(long long M, long long rows) { return (M + rows - 1) / rows; }
constexpr int lnb_chunks(int C) {
  return C <= 128 ? 1 : C <= 256 ? 2 : C <= 384 ? 3 : C <= 512 ? 4 : C <= 768 ? 6 : 8;
}
constexpr int LNB_MAX_STAGES = 8;
// dynamic shared memory: the barriers (256 bytes), the scale (4 KB), then
// the ring, up to the 227 KB a CTA may take
constexpr int LNB_RING = 256 + 4096, LNB_SMEM = 232448;

// 4 consecutive values of a row to and from f32: one 16-byte float32 or
// 8-byte bfloat16 access (shared memory in, device memory out).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
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

// bytes (a multiple of 16) from src (16-byte aligned) to shared dst, their
// arrival counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(sm90::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(sm90::smem_u32(bar))
      : "memory");
}

template <typename TG, typename TX, typename TO, int NCH>
__global__ void __launch_bounds__(LNB_THREADS + 32, 1)
ln_bwd_kernel(const TG* __restrict__ G, const TX* __restrict__ X,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ R,
              const float* __restrict__ mask, int L, TO* __restrict__ DX,
              float* __restrict__ DXM, float* __restrict__ P, long long M, int C,
              long long rows, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + LNB_MAX_STAGES;
  float* sc = reinterpret_cast<float*>(smem + 256);
  uint8_t* ring = smem + LNB_RING;
  const int gbytes = LNB_WARPS * C * (int)sizeof(TG), xbytes = LNB_WARPS * C * (int)sizeof(TX);
  const int sbytes = gbytes + xbytes + (R != nullptr ? LNB_WARPS * C * 4 : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, chunks = C >> 2;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  const int nst = (int)((r1 - r0 + LNB_WARPS - 1) / LNB_WARPS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], LNB_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) sc[c] = scale[c];
  __syncthreads();

  if (warp == LNB_WARPS) {       // the producer
    if (lane == 0) {
      for (int k = 0; k < nst; ++k) {
        const int s = k % stages;
        if (k >= stages) sm90::mbar_wait(&empty[s], ((k / stages) - 1) & 1);
        const long long ra = r0 + (long long)k * LNB_WARPS;
        const uint32_t n = (uint32_t)(r1 - ra < LNB_WARPS ? r1 - ra : LNB_WARPS) * C;
        uint8_t* st = ring + s * sbytes;
        const uint32_t g = n * (uint32_t)sizeof(TG), x = n * (uint32_t)sizeof(TX);
        sm90::mbar_expect_tx(&full[s], g + x + (R != nullptr ? 4 * n : 0));
        bulk_load(st, G + ra * C, g, &full[s]);
        bulk_load(st + gbytes, X + ra * C, x, &full[s]);
        if (R != nullptr) bulk_load(st + gbytes + xbytes, R + ra * C, 4 * n, &full[s]);
      }
    }
    return;
  }

  float ps[NCH][4], pb[NCH][4];
#pragma unroll
  for (int q = 0; q < NCH; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) ps[q][e] = pb[q][e] = 0.f;

  // a row's statistics (and mask), loaded a stage before the row's turn
  auto stats = [&](long long m, float& mu, float& inv, float& mk) {
    mu = inv = mk = 0.f;
    if (m < r1) {
      mu = __ldg(mean + m);
      inv = __ldg(rstd + m);
      if (DXM != nullptr) mk = __ldg(mask + (unsigned)m / (unsigned)L);
    }
  };
  float mu, inv, mk;
  long long m = r0 + warp;
  stats(m, mu, inv, mk);
  for (int k = 0; k < nst; ++k, m += LNB_WARPS) {
    float mu_n, inv_n, mk_n;
    stats(m + LNB_WARPS, mu_n, inv_n, mk_n);
    const int s = k % stages;
    sm90::mbar_wait(&full[s], (k / stages) & 1);
    if (m < r1) {
      const uint8_t* st = ring + s * sbytes;
      const TG* gr = reinterpret_cast<const TG*>(st) + warp * C;
      const TX* xr = reinterpret_cast<const TX*>(st + gbytes) + warp * C;
      const float* rr = reinterpret_cast<const float*>(st + gbytes + xbytes) + warp * C;
      // g -> g*s and x -> xhat; the row sums and the column partials
      float g[NCH][4], xh[NCH][4];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NCH; ++q) {
        const int c4 = lane + 32 * q;
        if (c4 >= chunks) continue;
        load4(gr + 4 * c4, g[q]);
        load4(xr + 4 * c4, xh[q]);
        float sv[4];
        load4(sc + 4 * c4, sv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dy = g[q][e];
          const float xhat = (xh[q][e] - mu) * inv;
          const float gs = dy * sv[e];
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
        float dx[4], rv[4];
        if (R != nullptr) load4(rr + 4 * c4, rv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dx[e] = inv * (g[q][e] - s1 - xh[q][e] * s2);
          if (R != nullptr) dx[e] += rv[e];
        }
        store4(DX + m * C + 4 * c4, dx);
        if (DXM != nullptr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[e] *= mk;
          store4(DXM + m * C + 4 * c4, dx);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    mu = mu_n;
    inv = inv_n;
    mk = mk_n;
  }

  // every stage consumed: the ring takes the warps' column sums
  asm volatile("bar.sync 1, %0;" ::"n"(LNB_THREADS) : "memory");
  float* red = reinterpret_cast<float*>(ring);
  float* out = P + (long long)blockIdx.x * 2 * C;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c4 = lane + 32 * q;
      if (c4 < chunks) store4(red + warp * C + 4 * c4, part == 0 ? ps[q] : pb[q]);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(LNB_THREADS) : "memory");
    for (int c = threadIdx.x; c < C; c += LNB_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < LNB_WARPS; ++w) a += red[w * C + c];
      out[part * C + c] = a;
    }
    // read before the bias sums overwrite it
    asm volatile("bar.sync 1, %0;" ::"n"(LNB_THREADS) : "memory");
  }
}

// The ordered sum of the LayerNorm partials, out[e] = the sum over p of
// P[p, e] for E = 2C columns (dscale, then dbias), in a fixed two-level
// order: thread (s, col) of a CTA's 32 columns adds the partials p = s, s +
// LNS_SPLIT, s + 2 LNS_SPLIT, ... in that order, LNS_LOADS loads in flight;
// then thread (0, col) adds the LNS_SPLIT sums in s order.  A CTA of 1024
// threads a 32 columns: at most 132 partials make 5 loads a thread, one
// round trip, where one thread a column waited for hundreds.
constexpr int LNS_SPLIT = 32, LNS_THREADS = 32 * LNS_SPLIT, LNS_LOADS = 8;

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


constexpr int ctasA(int nch) { return nch <= 2 ? 3 : nch <= 4 ? 2 : 1; }
constexpr int ctasB(int nch) { return nch <= 3 ? 2 : 1; }

// register design, RPW rows of a warp in flight at once
template <typename TG, typename TX, typename TO, int NCH, int RPW, int CTAS>
__global__ void __launch_bounds__(LNB_THREADS, CTAS)
ln_reg_kernel(const TG* __restrict__ G, const TX* __restrict__ X,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ R,
              const float* __restrict__ mask, int L, TO* __restrict__ DX,
              float* __restrict__ DXM, float* __restrict__ P, long long M, int C,
              long long rows) {
  constexpr int W = 128 * NCH;
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
  for (long long m0 = r0 + warp; m0 < r1; m0 += LNB_WARPS * RPW) {
    float g[RPW][NCH][4], xh[RPW][NCH][4], rv[RPW][NCH][4];
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const long long m = m0 + (long long)u * LNB_WARPS;
#pragma unroll
      for (int q = 0; q < NCH; ++q) {
        const int c4 = lane + 32 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) g[u][q][e] = xh[u][q][e] = rv[u][q][e] = 0.f;
        if (m < r1 && c4 < chunks) {
          float t[4];
          if (sizeof(TG) == 4) { const float4 f = __ldg(reinterpret_cast<const float4*>(G + m * C + 4 * c4)); g[u][q][0]=f.x; g[u][q][1]=f.y; g[u][q][2]=f.z; g[u][q][3]=f.w; }
          else { const uint2 raw = __ldg(reinterpret_cast<const uint2*>(G + m * C + 4 * c4)); load4(reinterpret_cast<const __nv_bfloat16*>(&raw), t); for (int e=0;e<4;++e) g[u][q][e]=t[e]; }
          if (sizeof(TX) == 4) { const float4 f = __ldg(reinterpret_cast<const float4*>(X + m * C + 4 * c4)); xh[u][q][0]=f.x; xh[u][q][1]=f.y; xh[u][q][2]=f.z; xh[u][q][3]=f.w; }
          else { const uint2 raw = __ldg(reinterpret_cast<const uint2*>(X + m * C + 4 * c4)); load4(reinterpret_cast<const __nv_bfloat16*>(&raw), t); for (int e=0;e<4;++e) xh[u][q][e]=t[e]; }
          if (R != nullptr) { const float4 f = __ldg(reinterpret_cast<const float4*>(R + m * C + 4 * c4)); rv[u][q][0]=f.x; rv[u][q][1]=f.y; rv[u][q][2]=f.z; rv[u][q][3]=f.w; }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const long long m = m0 + (long long)u * LNB_WARPS;
      if (m >= r1) break;
      const float mu = __ldg(mean + m), inv = __ldg(rstd + m);
      const float mk = DXM != nullptr ? __ldg(mask + (unsigned)m / (unsigned)L) : 0.f;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NCH; ++q) {
        if (lane + 32 * q >= chunks) continue;
        float sv[4];
        load4(sc + 4 * (lane + 32 * q), sv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dy = g[u][q][e];
          const float xhat = (xh[u][q][e] - mu) * inv;
          const float gs = dy * sv[e];
          g[u][q][e] = gs;
          xh[u][q][e] = xhat;
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
          dx[e] = inv * (g[u][q][e] - s1 - xh[u][q][e] * s2);
          if (R != nullptr) dx[e] += rv[u][q][e];
        }
        store4(DX + m * C + 4 * c4, dx);
        if (DXM != nullptr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[e] *= mk;
          store4(DXM + m * C + 4 * c4, dx);
        }
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
    __syncthreads();
  }
}

// streaming ceilings: the same reads and writes without the arithmetic
template <int NCH>
__global__ void __launch_bounds__(LNB_THREADS, ctasA(NCH))
copy_rows_kernel(const float* __restrict__ G, const float* __restrict__ X, const float* __restrict__ R,
                 float* __restrict__ DX, float* __restrict__ DXM, long long M, int C, long long rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, chunks = C >> 2;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  for (long long m = r0 + warp; m < r1; m += LNB_WARPS) {
    float4 a[NCH], b[NCH], c[NCH];
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c4 = lane + 32 * q;
      if (c4 < chunks) {
        a[q] = __ldg(reinterpret_cast<const float4*>(G + m * C) + c4);
        b[q] = __ldg(reinterpret_cast<const float4*>(X + m * C) + c4);
        c[q] = R != nullptr ? __ldg(reinterpret_cast<const float4*>(R + m * C) + c4) : make_float4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int q = 0; q < NCH; ++q) {
      const int c4 = lane + 32 * q;
      if (c4 < chunks) {
        const float4 d = make_float4(a[q].x + b[q].x + c[q].x, a[q].y + b[q].y + c[q].y, a[q].z + b[q].z + c[q].z, a[q].w + b[q].w + c[q].w);
        reinterpret_cast<float4*>(DX + m * C)[c4] = d;
        if (DXM != nullptr) reinterpret_cast<float4*>(DXM + m * C)[c4] = d;
      }
    }
  }
}

__global__ void __launch_bounds__(1024)
copy_flat_kernel(const float4* __restrict__ G, const float4* __restrict__ X, const float4* __restrict__ R,
                 float4* __restrict__ DX, float4* __restrict__ DXM, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const float4 a = __ldg(G + i), b = __ldg(X + i), c = R != nullptr ? __ldg(R + i) : make_float4(0, 0, 0, 0);
    const float4 d = make_float4(a.x + b.x + c.x, a.y + b.y + c.y, a.z + b.z + c.z, a.w + b.w + c.w);
    DX[i] = d;
    if (DXM != nullptr) DXM[i] = d;
  }
}

template <typename TG, typename TX, typename TO, int NCH>
int run(int v, const TG* G, const TX* X, const float* mean, const float* rstd,
        const float* scale, const float* R, const float* mask, int L, TO* DX, float* DXM,
        float* part, float* ds_db, long long M, int C, cudaStream_t st) {
  long long rows, parts;
  if (v == 0) {          // register, one row a warp
    rows = n_chunks(M, (long long)LNB_SMS * ctasA(NCH)); parts = n_chunks(M, rows);
    ln_reg_kernel<TG, TX, TO, NCH, 1, ctasA(NCH)><<<(unsigned)parts, LNB_THREADS, 0, st>>>(
        G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C, rows);
  } else if (v == 1) {   // register, two rows a warp
    rows = n_chunks(M, (long long)LNB_SMS * ctasB(NCH)); parts = n_chunks(M, rows);
    ln_reg_kernel<TG, TX, TO, NCH, 2, ctasB(NCH)><<<(unsigned)parts, LNB_THREADS, 0, st>>>(
        G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C, rows);
  } else if (v == 3) {   // register, one row a warp, 2 CTAs always
    rows = n_chunks(M, (long long)LNB_SMS * ctasB(NCH)); parts = n_chunks(M, rows);
    ln_reg_kernel<TG, TX, TO, NCH, 1, ctasB(NCH)><<<(unsigned)parts, LNB_THREADS, 0, st>>>(
        G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C, rows);
  } else if (v == 4) {   // copy, the register design's grid
    rows = n_chunks(M, (long long)LNB_SMS * ctasA(NCH)); parts = n_chunks(M, rows);
    copy_rows_kernel<NCH><<<(unsigned)parts, LNB_THREADS, 0, st>>>(
        (const float*)G, (const float*)X, R, (float*)DX, DXM, M, C, rows);
    return (int)cudaGetLastError();
  } else if (v == 5) {   // copy, flat, every thread the SMs hold
    copy_flat_kernel<<<132 * 2, 1024, 0, st>>>((const float4*)G, (const float4*)X, (const float4*)R,
                                               (float4*)DX, (float4*)DXM, M * C / 4);
    return (int)cudaGetLastError();
  } else {               // the ring
    rows = n_chunks(M, LNB_SMS); parts = n_chunks(M, rows);
    const int sbytes = LNB_WARPS * C * (int)(sizeof(TG) + sizeof(TX) + (R != nullptr ? 4 : 0));
    const int stages = (LNB_SMEM - LNB_RING) / sbytes < LNB_MAX_STAGES ? (LNB_SMEM - LNB_RING) / sbytes : LNB_MAX_STAGES;
    const int smem = LNB_RING + stages * sbytes;
    auto kernel = ln_bwd_kernel<TG, TX, TO, NCH>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<(unsigned)parts, LNB_THREADS + 32, smem, st>>>(G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, M, C, rows, stages);
  }
  cudaError_t err = cudaGetLastError();
  if (err) return (int)err;
  ln_sums_kernel<<<(unsigned)((2 * C + 31) / 32), LNS_THREADS, 0, st>>>(part, (int)parts, 2 * C, ds_db);
  return (int)cudaGetLastError();
}
template <typename TG, typename TX, typename TO>
int dispatch(int v, const TG* G, const TX* X, const float* mean, const float* rstd, const float* scale, const float* R, const float* mask, int L, TO* DX, float* DXM, float* part, float* ds_db, long long M, int C, cudaStream_t st) {
  switch (lnb_chunks(C)) {
    case 2: return run<TG, TX, TO, 2>(v, G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, ds_db, M, C, st);
    case 3: return run<TG, TX, TO, 3>(v, G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, ds_db, M, C, st);
    case 4: return run<TG, TX, TO, 4>(v, G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, ds_db, M, C, st);
  }
  return -1;
}
}  // namespace
extern "C" int ln_variant(int v, const float* G, const float* X, const float* mean, const float* rstd, const float* scale, const float* R, const float* mask, int L, float* DX, float* DXM, float* part, float* ds_db, long long M, int C, void* stream) {
  return dispatch<float, float, float>(v, G, X, mean, rstd, scale, R, mask, L, DX, DXM, part, ds_db, M, C, (cudaStream_t)stream);
}
