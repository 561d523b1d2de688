// Fused residual-add + LayerNorm forward (K2) for Hopper (sm_90a).
//
// Replaces: visitron_tpu/ops/layernorm.py:_fwd_res_kernel and _fwd_kernel,
// reached through _call_fwd (the Pallas calls of fused_add_layernorm).
// Same function over rows of (R, H):
//   h   = x [+ residual]                       in fp32
//   mu  = mean(h), var = max(mean(h^2) - mu^2, 0)   (fast variance)
//   y   = (h - mu) * rsqrt(var + eps) * gamma + beta, stored in x's dtype.
//
// What bounds it on an H100: bytes.  It reads x (and the residual) and
// writes y once, with ~10 flops per element, far below the card's
// operations-per-byte balance.
//
// Design: one warp per row, eight rows per block.  Lanes read 16-byte
// vectors (8 bf16 or 4 fp32 values), so a warp's loads are fully coalesced;
// the sum and the sum of squares are reduced in fp32 by warp shuffles, with
// no shared memory and no block barrier.  The row is read a second time for
// the normalisation instead of being held in registers: a 768-wide bf16 row
// is 1.5 KB, so the second read hits L1 and device memory sees each byte
// once.  The residual pointer may be null (the embedding LayerNorm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
add_layernorm_fwd(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ y, int R, int H, float eps) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte vector
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const long long base = static_cast<long long>(row) * H;
  const T* xr = x + base;
  const T* rr = res == nullptr ? nullptr : res + base;
  const int nvec = H / V;

  float sum = 0.f, sq = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    float h[V];
    load_vec(xr + i * V, h);
    if (rr != nullptr) {
      float r[V];
      load_vec(rr + i * V, r);
#pragma unroll
      for (int e = 0; e < V; ++e) h[e] += r[e];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sum += h[e];
      sq = fmaf(h[e], h[e], sq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mu = sum / H;
  const float var = fmaxf(sq / H - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);

  T* yr = y + base;
  for (int i = lane; i < nvec; i += 32) {
    float h[V], g[V], bt[V];
    load_vec(xr + i * V, h);
    if (rr != nullptr) {
      float r[V];
      load_vec(rr + i * V, r);
#pragma unroll
      for (int e = 0; e < V; ++e) h[e] += r[e];
    }
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      load_vec(gamma + i * V + e, g + e);
      load_vec(beta + i * V + e, bt + e);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) h[e] = (h[e] - mu) * rstd * g[e] + bt[e];
    store_vec(yr + i * V, h);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* gamma,
                   const void* beta, void* y, int R, int H, float eps,
                   cudaStream_t stream) {
  const int grid = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  add_layernorm_fwd<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), R, H, eps);
  return cudaGetLastError();
}

// ============================================================================
// Backward (K2b).
//
// Replaces: visitron_tpu/ops/layernorm.py:_bwd_res_kernel and _bwd_kernel,
// reached through _call_bwd, and the jnp.sum of their partials (:202).  Same
// function over rows of (R, H), from dy and the forward's inputs (h is
// recomputed in fp32, never stored):
//   h = x [+ residual], mu, rstd as in the forward, xhat = (h - mu) * rstd
//   g = dy * gamma, s1 = mean(g), s2 = mean(g * xhat)
//   dh = (g - s1 - xhat * s2) * rstd            stored in dy's dtype
//   dgamma = sum_rows dy * xhat, dbeta = sum_rows dy   (fp32)
// dh is the gradient of both x and the residual.
//
// What bounds it on an H100: bytes.  It reads dy, x (and the residual) and
// writes dh once, with ~20 flops per element: at R 16384 x H 768 in bf16,
// 101 MB, 0.030 ms at 3.35 TB/s.
//
// Design.
// - One read of each row.  A warp takes one row at a time.  The row's x, dy
//   (and residual) arrive in a shared-memory stage, and each lane moves its
//   16-byte vectors from there into registers once: h = x + residual and dy
//   in fp32, NV vectors a lane.  The statistics, the two means and dh all
//   read those registers, so device memory sees each input byte once.
// - Column partials where the row already is.  Lane l takes vectors l,
//   l + 32, ... of every row, so it meets the same columns in each row its
//   warp takes, and adds dy * xhat and dy into registers across all of them.
//   At the end the block sums its warps' accumulators in warp order, through
//   shared memory, into one fp32 partial row of dgamma and dbeta.
// - Enough bytes in flight.  The grid is as many blocks as fit on the card
//   at once (persistent: warp w of block b walks rows W b + w, with a stride
//   of W x grid).  Each warp keeps a ring of kBwdStages rows.  Lane 0 asks
//   the Tensor Memory Accelerator for each row with one 1-D bulk copy per
//   array (cp.async.bulk, whose completion is counted in bytes on the
//   stage's mbarrier).  A stage is asked for again as soon as the lanes have
//   taken its row into registers, so two rows are in flight while one is
//   computed: at H 768 in bf16, 16 warps x 2 x 4.6 KB = 147 KB an SM,
//   against the ~25 KB that 3.35 TB/s x ~1 us of latency / 132 SMs asks for.
//   Rows are 16-byte multiples (H % 8 == 0), as bulk copies require.
// - The final sum inside the library.  A second small kernel,
//   add_layernorm_bwd_sum, sums the partial rows of each column in a fixed
//   order.  No float atomics: the grid depends only on the card and the
//   shape, so dh, dgamma and dbeta are equal bit for bit from one launch to
//   the next.  The summation order, and so the last bits, differ between
//   card models with other SM counts.
// - Registers.  The row path is templated on NV, the vectors a lane holds
//   (H <= 1024: at most 4 bf16 or 8 fp32 vectors).  At H 768 in bf16 a lane
//   holds 24 values of h and of dy and 48 accumulators in 128 registers, so
//   one block of W = 16 warps fills an SM and its 16 warps share one partial
//   row (against two blocks of 8 on an H100 SXM: 4% faster at R 12288, a
//   shorter final sum).  bf16 rows past 768 and fp32 rows take blocks of 8
//   warps.  Rows past 1024 (to H 4096) take add_layernorm_bwd_general: four
//   warps a block, the accumulators in shared memory, and plain loads in
//   three passes over the row, which re-read it from L1/L2.  That path is
//   there to be right.

constexpr int kBwdStages = 2;           // rows in a warp's ring
constexpr int kBwdGeneralWarps = 4;     // row walkers of a general block
constexpr int kBwdMaxRingH = 1024;      // widest row of the register path
constexpr int kSumGroups = 16;          // row groups of a sum block (32 columns)

template <typename T>
constexpr int kMaxNV = kBwdMaxRingH / (16 / static_cast<int>(sizeof(T))) / 32;

// Row walkers of a ring block.  16 (one block an SM, at most 128 registers a
// thread) where a lane holds at most 24 bf16 values, so that the SM's 16
// warps share one partial row; else 8 (two blocks an SM where the registers
// and the ring allow).
__host__ __device__ constexpr int ring_warps(int elt_bytes, int nv) {
  return elt_bytes == 2 && nv <= 3 ? 16 : 8;
}
__host__ __device__ constexpr int ring_min_blocks(int elt_bytes, int nv) {
  return ring_warps(elt_bytes, nv) == 16 || nv * 16 / elt_bytes > 24 ? 1 : 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// The stage's one arrival, which also expects `bytes` of copies on `bar`.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums the block's per-warp accumulators `red` ([warp][dgamma H | dbeta H])
// in warp order into the block's partial row of `part`.
__device__ __forceinline__ void write_partial(const float* red, int warps, float* part,
                                              int H) {
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * H; c += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += red[w * 2 * H + c];
    part[static_cast<long long>(blockIdx.x) * 2 * H + c] = t;
  }
}

// Dynamic shared memory of a ring block: room for 16 x kBwdStages
// mbarriers, gamma, then the ring (W warps x kBwdStages stages of x, dy
// [, residual]), which the final reduction reuses for W x 2H fp32
// accumulators.
constexpr int kRingBarBytes = 16 * kBwdStages * 8;

template <typename T, int NV>
__global__ void __launch_bounds__(ring_warps(sizeof(T), NV) * 32,
                                  ring_min_blocks(sizeof(T), NV))
add_layernorm_bwd_ring(const T* __restrict__ dy, const T* __restrict__ x,
                       const T* __restrict__ res, const float* __restrict__ gamma,
                       T* __restrict__ dh, float* __restrict__ part, int R, int H,
                       float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int W = ring_warps(sizeof(T), NV);
  extern __shared__ __align__(16) unsigned char smem[];
  float* gamma_s = reinterpret_cast<float*>(smem + kRingBarBytes);
  unsigned char* ring = reinterpret_cast<unsigned char*>(gamma_s + H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = H / V;
  const uint32_t row_bytes = H * sizeof(T);
  const uint32_t stage_bytes = (res == nullptr ? 2 : 3) * row_bytes;
  const int stride = gridDim.x * W;
  const int first = blockIdx.x * W + warp;
  unsigned char* my_ring = ring + warp * kBwdStages * stage_bytes;
  const uint32_t my_bars = smem_addr(smem) + warp * kBwdStages * 8;

  if (lane == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(my_bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = 4 * threadIdx.x; c < H; c += 4 * blockDim.x)
    *reinterpret_cast<float4*>(gamma_s + c) = *reinterpret_cast<const float4*>(gamma + c);
  __syncthreads();

  // Lane 0 asks for `row`, the warp's k-th, into stage k % kBwdStages.
  auto request = [&](int k, int row) {
    const uint32_t bar = my_bars + 8 * (k % kBwdStages);
    const uint32_t dst = smem_addr(my_ring + (k % kBwdStages) * stage_bytes);
    const long long base = static_cast<long long>(row) * H;
    mbar_expect(bar, stage_bytes);
    bulk_copy(dst, x + base, row_bytes, bar);
    bulk_copy(dst + row_bytes, dy + base, row_bytes, bar);
    if (res != nullptr) bulk_copy(dst + 2 * row_bytes, res + base, row_bytes, bar);
  };
  if (lane == 0)
    for (int k = 0; k < kBwdStages && first + k * stride < R; ++k)
      request(k, first + k * stride);

  float dg[NV][V], db[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) dg[j][e] = db[j][e] = 0.f;

  int k = 0;
  for (int row = first; row < R; row += stride, ++k) {
    mbar_wait(my_bars + 8 * (k % kBwdStages), (k / kBwdStages) & 1);
    const T* xs = reinterpret_cast<const T*>(my_ring + (k % kBwdStages) * stage_bytes);
    float h[NV][V], d[NV][V];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        load_vec(xs + i * V, h[j]);
        if (res != nullptr) {
          float r[V];
          load_vec(xs + 2 * H + i * V, r);
#pragma unroll
          for (int e = 0; e < V; ++e) h[j][e] += r[e];
        }
        load_vec(xs + H + i * V, d[j]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sum += h[j][e];
          sq = fmaf(h[j][e], h[j][e], sq);
        }
      }
    }
    // The row is in registers: its stage takes the row after next.
    __syncwarp();
    if (lane == 0 && row + kBwdStages * stride < R) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      request(k + kBwdStages, row + kBwdStages * stride);
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / H;
    const float var = fmaxf(sq / H - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);

    // xhat replaces h and g = dy * gamma replaces dy once the column
    // partials have taken dy.
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
        float gm[V];
#pragma unroll
        for (int e = 0; e < V; e += 4) load_vec(gamma_s + i * V + e, gm + e);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = (h[j][e] - mu) * rstd;
          const float g = d[j][e] * gm[e];
          a1 += g;
          a2 = fmaf(g, xhat, a2);
          dg[j][e] = fmaf(d[j][e], xhat, dg[j][e]);
          db[j][e] += d[j][e];
          h[j][e] = xhat;
          d[j][e] = g;
        }
      }
    }
    const float s1 = warp_sum(a1) / H, s2 = warp_sum(a2) / H;

    T* dhr = dh + static_cast<long long>(row) * H;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) h[j][e] = (d[j][e] - s1 - h[j][e] * s2) * rstd;
        store_vec(dhr + i * V, h[j]);
      }
    }
  }

  __syncthreads();  // every ring is drained: it holds the accumulators now
  float* red = reinterpret_cast<float*>(ring);
  float* mine = red + warp * 2 * H;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * j;
    if (i < nvec) {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        store_vec(mine + i * V + e, dg[j] + e);
        store_vec(mine + H + i * V + e, db[j] + e);
      }
    }
  }
  write_partial(red, W, part, H);
}

// Any H up to 4096: the accumulators of each warp ([dgamma H | dbeta H]) in
// dynamic shared memory, each lane owning the columns of its vectors.
template <typename T>
__global__ void __launch_bounds__(kBwdGeneralWarps * 32)
add_layernorm_bwd_general(const T* __restrict__ dy, const T* __restrict__ x,
                          const T* __restrict__ res, const float* __restrict__ gamma,
                          T* __restrict__ dh, float* __restrict__ part, int R, int H,
                          float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float acc[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = H / V;
  float* mine = acc + warp * 2 * H;
  for (int c = 4 * lane; c < 2 * H; c += 128)
    *reinterpret_cast<float4*>(mine + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  const int stride = gridDim.x * kBwdGeneralWarps;
  for (int row = blockIdx.x * kBwdGeneralWarps + warp; row < R; row += stride) {
    const long long base = static_cast<long long>(row) * H;
    // h of vector i, from device memory (L1/L2 after the first pass).
    auto load_h = [&](int i, float* h) {
      load_vec(x + base + i * V, h);
      if (res != nullptr) {
        float r[V];
        load_vec(res + base + i * V, r);
#pragma unroll
        for (int e = 0; e < V; ++e) h[e] += r[e];
      }
    };
    float sum = 0.f, sq = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      float h[V];
      load_h(i, h);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sum += h[e];
        sq = fmaf(h[e], h[e], sq);
      }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / H;
    const float var = fmaxf(sq / H - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);

    float a1 = 0.f, a2 = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      float h[V], d[V], gm[V], ag[V], ab[V];
      load_h(i, h);
      load_vec(dy + base + i * V, d);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        load_vec(gamma + i * V + e, gm + e);
        load_vec(mine + i * V + e, ag + e);
        load_vec(mine + H + i * V + e, ab + e);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (h[e] - mu) * rstd;
        const float g = d[e] * gm[e];
        a1 += g;
        a2 = fmaf(g, xhat, a2);
        ag[e] = fmaf(d[e], xhat, ag[e]);
        ab[e] += d[e];
      }
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        store_vec(mine + i * V + e, ag + e);
        store_vec(mine + H + i * V + e, ab + e);
      }
    }
    const float s1 = warp_sum(a1) / H, s2 = warp_sum(a2) / H;

    for (int i = lane; i < nvec; i += 32) {
      float h[V], d[V], gm[V];
      load_h(i, h);
      load_vec(dy + base + i * V, d);
#pragma unroll
      for (int e = 0; e < V; e += 4) load_vec(gamma + i * V + e, gm + e);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (h[e] - mu) * rstd;
        h[e] = (d[e] * gm[e] - s1 - xhat * s2) * rstd;
      }
      store_vec(dh + base + i * V, h);
    }
  }
  write_partial(acc, kBwdGeneralWarps, part, H);
}

// out[c] = sum over p of part[p][c], c < n, in a fixed order: thread group g
// sums rows g, g + kSumGroups, ...; then the groups are added in order.
// P == 0 writes zeros.
__global__ void __launch_bounds__(32 * kSumGroups)
add_layernorm_bwd_sum(const float* __restrict__ part, float* __restrict__ out, int P,
                      int n) {
  __shared__ float s[kSumGroups][32];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int p = grp; p < P; p += kSumGroups) t += part[static_cast<long long>(p) * n + c];
  }
  s[grp][lane] = t;
  __syncthreads();
  if (grp == 0 && c < n) {
    float u = 0.f;
#pragma unroll
    for (int g = 0; g < kSumGroups; ++g) u += s[g][lane];
    out[c] = u;
  }
}

// The row kernel a shape takes, its block and its dynamic shared memory.
struct BwdPlan {
  const void* fn;
  int warps;
  int smem;
};

template <typename T, int NV>
const void* ring_kernel(int nv) {
  if constexpr (NV > kMaxNV<T>) {
    return nullptr;
  } else {
    return nv == NV ? reinterpret_cast<const void*>(&add_layernorm_bwd_ring<T, NV>)
                    : ring_kernel<T, NV + 1>(nv);
  }
}

template <typename T>
BwdPlan bwd_plan(int H, bool has_res) {
  constexpr int V = 16 / sizeof(T);
  if (H <= kBwdMaxRingH) {
    const int nv = (H / V + 31) / 32;
    const int warps = ring_warps(sizeof(T), nv);
    const int ring = warps * kBwdStages * (has_res ? 3 : 2) * H * sizeof(T);
    const int red = warps * 2 * H * static_cast<int>(sizeof(float));
    return {ring_kernel<T, 1>(nv), warps,
            kRingBarBytes + H * static_cast<int>(sizeof(float)) + (ring > red ? ring : red)};
  }
  return {reinterpret_cast<const void*>(&add_layernorm_bwd_general<T>), kBwdGeneralWarps,
          kBwdGeneralWarps * 2 * H * static_cast<int>(sizeof(float))};
}

// Blocks of `plan` that fit on the current device at once, cached by device,
// kernel and shared memory (an occupancy query costs microseconds).  The
// first query for a kernel on a device also lifts its dynamic shared memory
// limit to the device's opt-in maximum, once: the launches then set nothing.
cudaError_t resident_blocks(const BwdPlan& plan, int* out) {
  struct Entry {
    int device;
    const void* fn;
    int smem;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i)
      if (cache[i].device == device && cache[i].fn == plan.fn && cache[i].smem == plan.smem) {
        *out = cache[i].blocks;
        return cudaSuccess;
      }
  }
  int optin = 0, per_sm = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(plan.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan.fn, plan.warps * 32,
                                                      plan.smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  if (used < 64) cache[used++] = {device, plan.fn, plan.smem, *out};
  return cudaSuccess;
}

// The partial rows (blocks of the row kernel) for R rows.
cudaError_t bwd_partials(const BwdPlan& plan, int R, int* out) {
  if (R == 0) {
    *out = 0;
    return cudaSuccess;
  }
  int resident;
  const cudaError_t err = resident_blocks(plan, &resident);
  if (err != cudaSuccess) return err;
  const int needed = (R + plan.warps - 1) / plan.warps;
  *out = needed < resident ? needed : resident;
  return cudaSuccess;
}

bool bwd_shape_ok(int R, int H, int dtype) {
  return R >= 0 && H > 0 && H % 8 == 0 && H <= 4096 && (dtype == 0 || dtype == 1);
}

template <typename T>
cudaError_t launch_bwd(const void* dy, const void* x, const void* res, const void* gamma,
                       void* dh, void* scratch, void* sums, int R, int H, float eps,
                       int scratch_floats, cudaStream_t stream) {
  const BwdPlan plan = bwd_plan<T>(H, res != nullptr);
  int P;
  cudaError_t err = bwd_partials(plan, R, &P);
  if (err != cudaSuccess) return err;
  if (scratch_floats != 2 * H * P) return cudaErrorInvalidValue;
  if (P > 0) {
    const T* dy_ = static_cast<const T*>(dy);
    const T* x_ = static_cast<const T*>(x);
    const T* res_ = static_cast<const T*>(res);
    const float* gamma_ = static_cast<const float*>(gamma);
    T* dh_ = static_cast<T*>(dh);
    float* part = static_cast<float*>(scratch);
    void* args[] = {&dy_, &x_, &res_, &gamma_, &dh_, &part, &R, &H, &eps};
    err = cudaLaunchKernel(plan.fn, dim3(P), dim3(plan.warps * 32), args, plan.smem, stream);
    if (err != cudaSuccess) return err;
  }
  add_layernorm_bwd_sum<<<(2 * H + 31) / 32, 32 * kSumGroups, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(sums), P, 2 * H);
  return cudaGetLastError();
}

}  // namespace

// The fp32 scratch that vt_layernorm_bwd needs for R rows of width H:
// 2H floats (a partial row of dgamma, then of dbeta) for each block of the
// grid, which depends on the current device's SM count.  Negative on an
// unsupported shape or dtype (0 = float32, 1 = bfloat16), or minus a CUDA
// error.
extern "C" int vt_layernorm_bwd_scratch(int R, int H, int dtype, int has_res) {
  if (!bwd_shape_ok(R, H, dtype)) return -static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan plan = dtype == 0 ? bwd_plan<float>(H, has_res != 0)
                                  : bwd_plan<__nv_bfloat16>(H, has_res != 0);
  int P;
  const cudaError_t err = bwd_partials(plan, R, &P);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return 2 * H * P;
}

// dtype: 0 = float32, 1 = bfloat16.  dy, x, residual (nullable) and dh are
// contiguous (R, H) of that dtype with H % 8 == 0, H <= 4096, and 16-byte
// aligned; gamma is fp32.  scratch holds scratch_floats fp32, exactly
// vt_layernorm_bwd_scratch(R, H, dtype, residual != null); sums gets
// dgamma then dbeta, 2H fp32.  Two launches on the stream: the row kernel
// and the final sum.
extern "C" int vt_layernorm_bwd(const void* dy, const void* x, const void* res,
                                const void* gamma, void* dh, void* scratch, void* sums,
                                int R, int H, float eps, int scratch_floats,
                                int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bwd_shape_ok(R, H, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_bwd<float>(dy, x, res, gamma, dh, scratch, sums, R, H, eps,
                             scratch_floats, st);
  return launch_bwd<__nv_bfloat16>(dy, x, res, gamma, dh, scratch, sums, R, H, eps,
                                   scratch_floats, st);
}

// dtype: 0 = float32, 1 = bfloat16.  x, residual (nullable) and y are
// contiguous (R, H) with H % 8 == 0 and 16-byte aligned; gamma/beta are fp32.
extern "C" int vt_layernorm_fwd(const void* x, const void* res, const void* gamma,
                                const void* beta, void* y, int R, int H,
                                float eps, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0) return launch<float>(x, res, gamma, beta, y, R, H, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, res, gamma, beta, y, R, H, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
