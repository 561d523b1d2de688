// Packed fused self-attention forward (K1) for Hopper (sm_90a).
//
// Replaces: visitron_tpu/ops/attention.py:_fused_packed_fwd_kernel, reached
// through _fused_packed_forward (the Pallas call of fused_attention_packed).
// Same function: for each (batch b, head h) of packed (B, S, H*D) q/k/v,
//   s = (q_h k_h^T) / sqrt(D) + key_bias[b]   (fp32)
//   a = softmax(s) over full rows             (fp32)
//   a = where(keep(q, k), a, 0) / (1 - rate)  (optional hash dropout)
//   out_h = a.astype(v.dtype) @ v_h           (fp32 accumulation)
// plus, on request, lse = m + log(l) per row as (B*H, S) fp32.
//
// What bounds it on an H100: at the serving shapes (B = 64, S = 256..512,
// H = 12, D = 64, bf16) the bytes (q/k/v/out once each) and the arithmetic
// (4*B*H*S^2*D at the bf16 tensor-core rate) give bounds of the same order,
// a few tens of microseconds; bytes are the larger.
//
// Design against what the TPU kernel relied on: the Pallas kernel keeps a
// whole (S, S) fp32 score matrix per head in VMEM (1 MB at S = 512), which no
// SM has.  Here one block takes one (b, h, 64-row query tile) and walks
// 64-wide K/V tiles with an online max/sum (flash-style), which is the same
// function as the full-row softmax.  Rows are read straight from the packed
// layout through a row stride, so q/k/v may be strided views of the fused QKV
// projection with no split or transpose copies.  Dropout recomputes the TPU
// kernel's murmur3 position hash over the absolute (query, key) indices of
// the head, so masks match it bit for bit; l counts every probability, kept
// or not, as there.  The unnormalised probabilities are rounded to v's dtype
// before the PV product (the TPU kernel rounds the normalised ones: the two
// differ at the dtype's rounding level).
//
// Two instantiations:
//   * bf16 (the serving path): the dot products run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Four warps, 16 query
//     rows each; Q fragments stay in registers for the whole key loop, the
//     score accumulators are reused as the A operand of the PV product, and
//     K/V tiles are staged in padded shared memory (conflict-free fragment
//     loads).  Single-buffered and synchronous: no cp.async/TMA pipelining
//     or wgmma yet, so it stays above its bound.
//   * fp32 (a tight reference on the card): the same loop with fp32 FMA on
//     the CUDA cores; eight warps of 8 rows, each lane owning two keys of a
//     tile for the scores and D/32 output columns for the PV product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

// murmur3 finaliser over the absolute (row, col) coordinate of the head:
// visitron_tpu/ops/attention.py:_keep_mask, in native uint32 arithmetic.
__device__ __forceinline__ bool keep_bit(uint32_t r, uint32_t c, uint32_t seed,
                                         uint32_t thr) {
  uint32_t x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u) ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thr;
}

// ---- fp32: FMA on the CUDA cores --------------------------------------------

constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
packed_attention_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ key_bias,
                          float* __restrict__ out, float* __restrict__ lse, int S,
                          int H, long long q_sb, long long q_ss, long long k_sb,
                          long long k_ss, long long v_sb, long long v_ss,
                          uint32_t seed, uint32_t thr, float inv_keep,
                          int dropout, float sm_scale) {
  constexpr int DP = D + 4;      // padded fp32 row: 16-byte aligned, conflict-free float4
  constexpr int PP = kBK + 4;
  constexpr int DPL = D / 32;    // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kBQ x DP
  float* Ks = Qs + kBQ * DP;                     // kBK x DP
  float* Vs = Ks + kBK * DP;                     // kBK x D
  float* Ps = Vs + kBK * D;                      // kBQ x PP

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* qb = q + b * q_sb + h * D;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  const float* bias = key_bias + static_cast<long long>(b) * S;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * DP + d] = s < S ? qb[s * q_ss + d] : 0.f;
  }

  float m[kRows], l[kRows], o[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) o[r][t] = 0.f;
  }
  const float* qrow0 = Qs + (warp * kRows) * DP;
  float* prow0 = Ps + (warp * kRows) * PP;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool ok = s < S;
      Ks[r * DP + d] = ok ? kb[s * k_ss + d] : 0.f;
      Vs[r * D + d] = ok ? vb[s * v_ss + d] : 0.f;
    }
    __syncthreads();

    float sc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r][0] = sc[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(Ks + lane * DP);
    const float4* kc = reinterpret_cast<const float4*>(Ks + (lane + 32) * DP);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 x = ka[d4], y = kc[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(qrow0 + r * DP)[d4];
        sc[r][0] = fmaf(qv.x, x.x, fmaf(qv.y, x.y, fmaf(qv.z, x.z, fmaf(qv.w, x.w, sc[r][0]))));
        sc[r][1] = fmaf(qv.x, y.x, fmaf(qv.y, y.y, fmaf(qv.z, y.z, fmaf(qv.w, y.w, sc[r][1]))));
      }
    }

    const int c0 = k0 + lane, c1 = k0 + lane + 32;
    const float b0 = c0 < S ? bias[c0] : 0.f;
    const float b1 = c1 < S ? bias[c1] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s0 = c0 < S ? sc[r][0] * sm_scale + b0 : -INFINITY;
      const float s1 = c1 < S ? sc[r][1] * sm_scale + b1 : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);  // finite: key k0 < S is in every tile
      const float corr = expf(m[r] - m_new);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) o[r][t] *= corr;
      if (dropout) {
        const uint32_t qi = static_cast<uint32_t>(q0 + warp * kRows + r);
        p0 = keep_bit(qi, static_cast<uint32_t>(c0), hseed, thr) ? p0 * inv_keep : 0.f;
        p1 = keep_bit(qi, static_cast<uint32_t>(c1), hseed, thr) ? p1 * inv_keep : 0.f;
      }
      prow0[r * PP + lane] = p0;
      prow0[r * PP + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = reinterpret_cast<const float4*>(prow0 + r * PP)[j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j4 * 4 + jj) * D + lane * DPL;
        float vv[DPL];
        if constexpr (DPL == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vrow);
          vv[0] = t2.x;
          vv[1] = t2.y;
        } else {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow);
          vv[0] = t4.x;
          vv[1] = t4.y;
          vv[2] = t4.z;
          vv[3] = t4.w;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int t = 0; t < DPL; ++t) o[r][t] = fmaf(pj, vv[t], o[r][t]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + warp * kRows + r;
    if (s >= S) continue;
    const float inv = 1.f / l[r];
    float* orow = out + (static_cast<long long>(b) * S + s) * H * D + h * D + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) orow[t] = o[r][t] * inv;
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * H + h) * S + s] = m[r] + logf(l[r]);
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                   const void* key_bias, void* out, void* lse, int B, int S,
                   int H, long long q_sb, long long q_ss, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss,
                   uint32_t seed, uint32_t thr, float inv_keep, int dropout,
                   float sm_scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  packed_attention_fwd_fp32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<float*>(out),
      static_cast<float*>(lse), S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, seed,
      thr, inv_keep, dropout, sm_scale);
  return cudaGetLastError();
}

// ---- bf16: tensor cores (mma.sync m16n8k16) --------------------------------

constexpr int kMmaWarps = 4;                 // 16 query rows per warp
constexpr int kMmaThreads = kMmaWarps * 32;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values as one fragment register: `lo` in the low half (the
// smaller column index), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* lo,
                                            const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * kBQ * (D + 8) * 2;  // Q, K, V tiles of bf16, rows padded by 8
}

// Copies a (64, D) tile of rows [r0, r0 + 64) into padded shared memory with
// 16-byte loads; rows at or beyond S are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int r0, int S,
                                          int tid) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < kBQ * VPR; i += kMmaThreads) {
    const int r = i / VPR, c = (i % VPR) * 8, s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + s * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
packed_attention_fwd_mma(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ key_bias,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                         int S, int H, long long q_sb, long long q_ss,
                         long long k_sb, long long k_ss, long long v_sb,
                         long long v_ss, uint32_t seed, uint32_t thr,
                         float inv_keep, int dropout, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;  // k-steps of the QK^T product
  constexpr int NT = D / 8;       // n-tiles of the output
  constexpr int KT = kBK / 8;     // n-tiles of the scores (keys)
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const float* bias = key_bias + static_cast<long long>(b) * S;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);

  load_tile<D>(Qs, q + b * q_sb + h * D, q_ss, q0, S, tid);
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  const __nv_bfloat16* qw = Qs + (warp * 16) * LD;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = ld32(qw + g * LD + kk * 16 + 2 * t);
    qa[kk][1] = ld32(qw + (g + 8) * LD + kk * 16 + 2 * t);
    qa[kk][2] = ld32(qw + g * LD + kk * 16 + 8 + 2 * t);
    qa[kk][3] = ld32(qw + (g + 8) * LD + kk * 16 + 8 + 2 * t);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<D>(Ks, k + b * k_sb + h * D, k_ss, k0, S, tid);
    load_tile<D>(Vs, v + b * v_sb + h * D, v_ss, k0, S, tid);
    __syncthreads();

    float sc[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_16816(sc[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // Scale, key bias, ragged-tile mask; row maxima over the 4 lanes of a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * t + e;
        const bool ok = key < S;
        const float kb = ok ? bias[key] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sc[j][2 * r + e];
          x = ok ? x * sm_scale + kb : -INFINITY;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key k0 < S is in every tile
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * t + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p = expf(sc[j][2 * r + e] - m[r]);
          ps[r] += p;
          if (dropout)
            p = keep_bit(static_cast<uint32_t>(rows[r]), static_cast<uint32_t>(key),
                         hseed, thr) ? p * inv_keep : 0.f;
          sc[j][2 * r + e] = p;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = l[r] * corr[r] + ps[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // PV: the score accumulators of key tiles (2kk, 2kk+1) are the A
    // fragment of k-step kk; B pairs come from two rows of the V tile.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vr = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        mma_16816(o[n], pa, ld_pair(vc, vc + LD), ld_pair(vc + 8 * LD, vc + 9 * LD));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = out + (static_cast<long long>(b) * S + rows[r]) * H * D + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * H + h) * S + rows[r]] = m[r] + logf(l[r]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* key_bias, void* out, void* lse, int B, int S,
                       int H, long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       uint32_t seed, uint32_t thr, float inv_keep, int dropout,
                       float sm_scale, cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  packed_attention_fwd_mma<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(key_bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, H, q_sb,
      q_ss, k_sb, k_ss, v_sb, v_ss, seed, thr, inv_keep, dropout, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// Strides are in elements; the last dim of q/k/v is contiguous and out is a
// contiguous (B, S, H*D) tensor.  bf16 q/k/v rows are read as 16-byte vectors:
// their base pointers are 16-byte aligned and their strides multiples of 8.
extern "C" int vt_attention_fwd(const void* q, const void* k, const void* v,
                                const void* key_bias, void* out, void* lse,
                                int B, int S, int H, int D, long long q_sb,
                                long long q_ss, long long k_sb, long long k_ss,
                                long long v_sb, long long v_ss, int dtype,
                                unsigned int seed, unsigned int thr,
                                float inv_keep, int dropout, float sm_scale,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_ATTN_LAUNCH(FN, DD)                                                   \
  FN<DD>(q, k, v, key_bias, out, lse, B, S, H, q_sb, q_ss, k_sb, k_ss, v_sb,     \
         v_ss, seed, thr, inv_keep, dropout, sm_scale, st)
  if (dtype == 0 && D == 64) return VT_ATTN_LAUNCH(launch_fp32, 64);
  if (dtype == 0 && D == 128) return VT_ATTN_LAUNCH(launch_fp32, 128);
  if (dtype == 1 && D == 64) return VT_ATTN_LAUNCH(launch_mma, 64);
  if (dtype == 1 && D == 128) return VT_ATTN_LAUNCH(launch_mma, 128);
#undef VT_ATTN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
