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

}  // namespace

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
