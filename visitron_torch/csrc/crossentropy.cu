// Fused masked softmax cross-entropy for Hopper (sm_90a): forward (K3f) and
// backward (K3b).
//
// Replaces: visitron_tpu/ops/crossentropy.py:_fwd_kernel (reached through
// _call_fwd) and _bwd_kernel (reached through _call_bwd), the Pallas kernels
// of fused_masked_softmax_ce.  Same function, per row r of logits x (R, V)
// in bf16 or fp32 with an integer label y_r:
//   lse_r = log sum_j exp(x_rj)                    (fp32)
//   ce_r  = valid_r ? lse_r - x_r,y_r : 0,   valid_r = 0 <= y_r < V
//   dx_rj = g_r * valid_r * (exp(x_rj - lse_r) - [j == y_r]), in x's dtype
// The backward writes every element of dx: an ignored row gets zeros.
//
// What bounds it on an H100: the bytes.  At the pretraining shapes (R = 16 *
// 768 rows, V = 30525, bf16) the forward reads the 750 MB of logits once
// (0.22 ms at 3.35 TB/s) and the backward reads and writes them (0.45 ms);
// the arithmetic, one exp per element, is a few hundred MFLOP.
//
// Design against what the TPU kernel relied on: the Pallas kernels walk each
// block of rows over 2048-wide vocabulary chunks in grid order, carrying the
// running max, sum and label logit in VMEM scratch from one chunk to the
// next.  Blocks on the H100 run in no order and cannot carry sums across the
// grid, so here one block of 256 threads takes one whole row: the threads
// stride over the vocabulary with coalesced 16-byte loads, each keeps an
// online (max, sum) in fp32, and the block merges the 256 pairs with warp
// shuffles and then through shared memory.  The label logit is one read.
// V = 30525 is odd, so most rows of a contiguous (R, V) bf16 tensor start off
// any 16-byte (even 4-byte) boundary: each row is walked as a scalar head up
// to the first 16-byte boundary, a body of 16-byte vectors and a scalar tail,
// so nothing is padded or copied.  The backward recomputes the
// probabilities from the logits and the lse with the same walk and writes dx
// through the same head/body/tail split (dx is allocated with the logits'
// alignment).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 16-byte vector loads and stores of N values, converted to and from fp32.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int N = 4;
  __device__ static float get(const float* p) { return *p; }
  __device__ static void put(float* p, float v) { *p = v; }
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower index sits in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&two);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The split of a row of V values of T at `row` into a scalar head [0, head),
// a body of nvec 16-byte vectors and a scalar tail [tail, V).
template <typename T>
struct RowSplit {
  int head, nvec, tail;
  __device__ RowSplit(const T* row, int V) {
    constexpr int N = Io<T>::N;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15u) / sizeof(T));
    head = mis ? N - mis : 0;
    if (head > V) head = V;
    nvec = (V - head) / N;
    tail = head + nvec * N;
  }
};

// (m, s) <- the online softmax pair of the union of (m, s) and (m2, s2).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__device__ __forceinline__ void add_one(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else if (v > -INFINITY) {
    s += expf(v - m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd(const T* __restrict__ x, const long long* __restrict__ labels,
       float* __restrict__ ce, float* __restrict__ lse, int V) {
  constexpr int N = Io<T>::N;
  __shared__ float sm[kWarps], ss[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* xr = x + static_cast<long long>(row) * V;
  const RowSplit<T> sp(xr, V);

  float m = -INFINITY, s = 0.f;
  for (int i = tid; i < sp.head; i += kThreads) add_one(m, s, Io<T>::get(xr + i));
  for (int j = tid; j < sp.nvec; j += kThreads) {
    float v[N];
    Io<T>::load(xr + sp.head + j * N, v);
    float mx = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) mx = fmaxf(mx, v[i]);
    if (mx > m) {
      s *= expf(m - mx);
      m = mx;
    }
    if (m == -INFINITY) continue;
#pragma unroll
    for (int i = 0; i < N; ++i) s += expf(v[i] - m);
  }
  for (int i = sp.tail + tid; i < V; i += kThreads) add_one(m, s, Io<T>::get(xr + i));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if ((tid & 31) == 0) {
    sm[tid >> 5] = m;
    ss[tid >> 5] = s;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) merge(m, s, sm[w], ss[w]);
    const float l = m + logf(s);
    const long long y = labels[row];
    const bool valid = y >= 0 && y < V;
    ce[row] = valid ? l - Io<T>::get(xr + y) : 0.f;
    lse[row] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd(const T* __restrict__ x, const long long* __restrict__ labels,
       const float* __restrict__ lse, const float* __restrict__ g, T* __restrict__ dx,
       int V) {
  constexpr int N = Io<T>::N;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const long long off = static_cast<long long>(row) * V;
  const T* xr = x + off;
  T* dr = dx + off;
  const RowSplit<T> sp(xr, V);
  const long long y = labels[row];
  const float gv = (y >= 0 && y < V) ? g[row] : 0.f;
  const float l = lse[row];

  auto grad = [&](float v, int col) {
    return gv * (expf(v - l) - (col == y ? 1.f : 0.f));
  };
  for (int i = tid; i < sp.head; i += kThreads) Io<T>::put(dr + i, grad(Io<T>::get(xr + i), i));
  for (int j = tid; j < sp.nvec; j += kThreads) {
    const int c0 = sp.head + j * N;
    float v[N];
    Io<T>::load(xr + c0, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = grad(v[i], c0 + i);
    Io<T>::store(dr + c0, v);
  }
  for (int i = sp.tail + tid; i < V; i += kThreads)
    Io<T>::put(dr + i, grad(Io<T>::get(xr + i), i));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x: contiguous (R, V) logits; labels:
// (R,) int64; ce, lse: (R,) fp32 outputs.
extern "C" int vt_ce_fwd(const void* x, const void* labels, void* ce, void* lse, int R,
                         int V, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  if (dtype == 0)
    ce_fwd<float><<<R, kThreads, 0, st>>>(static_cast<const float*>(x), y,
                                          static_cast<float*>(ce),
                                          static_cast<float*>(lse), V);
  else if (dtype == 1)
    ce_fwd<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), y, static_cast<float*>(ce),
        static_cast<float*>(lse), V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dtype as above.  x and dx: contiguous (R, V) with bases on the same 16-byte
// phase; lse and g (the per-row cotangent): (R,) fp32.
extern "C" int vt_ce_bwd(const void* x, const void* labels, const void* lse,
                         const void* g, void* dx, int R, int V, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* y = static_cast<const long long*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 0)
    ce_bwd<float><<<R, kThreads, 0, st>>>(static_cast<const float*>(x), y, l, gg,
                                          static_cast<float*>(dx), V);
  else if (dtype == 1)
    ce_bwd<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), y, l, gg,
        static_cast<__nv_bfloat16*>(dx), V);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
