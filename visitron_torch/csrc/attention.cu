// Packed fused self-attention for Hopper (sm_90a): forward (K1f) and,
// further down, backward (K1b).
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

// ============================================================================
// Backward (K1b).
//
// Replaces: visitron_tpu/ops/attention.py:_fused_packed_bwd_kernel, reached
// through _fused_packed_bwd_rule.  Same function, per (b, h), with the lse
// that the forward wrote:
//   a    = exp(s - lse)                  (s as in the forward, fp32)
//   dp   = dO v^T                        (fp32)
//   a_eff, da = where(keep, a, 0)/(1-r), where(keep, dp, 0)/(1-r)
//   dv   = a_eff.astype(dtype)^T dO
//   D_i  = sum_j a_eff_ij dp_ij
//   ds   = (a * (da - D_i) * scale).astype(dtype)
//   dq   = ds k,  dk = ds^T q            (fp32 accumulation, stored in dtype)
// The key bias gets no gradient.
//
// What bounds it on an H100: at the train shapes (B 64, S 256..512, 12 x 64,
// bf16) the operations.  Reading q, k, v, dO and the lse and writing dq, dk,
// dv is about 7*B*S*H*D bf16 elements; the two launches below do 9 S x S x D
// products per head (five are the minimum), 18*B*H*S^2*D FLOPs.
//
// Design against what the TPU kernel relied on: the Pallas kernel holds the
// whole (S, S) score matrix of a head in VMEM and produces dq, dk and dv in
// one program.  No SM has room for that, and blocks cannot carry sums across
// the grid, so the work is split flash-style into two launches that need no
// atomics (results are the same run to run):
//   1. dq, one block per (b, h, 64-query tile): a first walk over the key
//      tiles sums D_i = sum_j a_eff dp (the TPU kernel's formula, not the
//      flash shortcut rowsum(dO * out): with out rounded to bf16 that
//      shortcut leaves ds = O(2^-9 |dp|) where the exact ds is 0, e.g. for a
//      query with a single unmasked key) and writes it; a second walk forms
//      ds and accumulates dq;
//   2. dk/dv, one block per (b, h, 64-key tile), looping over query tiles
//      and reading D_i.
// Both recompute s, a and the murmur3 keep mask from q, k, the bias, the lse
// and the per-head seed, bit for bit as the forward does.  q, k, v are read
// in place through their row strides (views of the fused QKV projection);
// dO, dq, dk, dv are contiguous (B, S, H*D).
// bf16: mma.sync m16n8k16 as in the forward, four warps of 16 rows; tiles in
// padded shared memory, A fragments read from it per k-step.  fp32: FMA on the
// CUDA cores, 256 threads, each owning a 4 x 4 block of the score tile and a
// 4 x D/16 block of the output.

// c[j] (j < 8): the 16 x 64 product of the warp's 16 rows of X (padded
// tile, row pitch D + 8) with the 64 rows of Y, contracted over D.
template <int D>
__device__ __forceinline__ void mma_rows_by_rows(float (&c)[kBK / 8][4],
                                                 const __nv_bfloat16* Xw,
                                                 const __nv_bfloat16* Y, int g,
                                                 int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a[4] = {ld32(Xw + g * LD + kk * 16 + 2 * t),
                           ld32(Xw + (g + 8) * LD + kk * 16 + 2 * t),
                           ld32(Xw + g * LD + kk * 16 + 8 + 2 * t),
                           ld32(Xw + (g + 8) * LD + kk * 16 + 8 + 2 * t)};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const __nv_bfloat16* yr = Y + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_16816(c[j], a, ld32(yr), ld32(yr + 8));
    }
  }
}

// o += P Z: P is a 16 x 64 fp32 accumulator tile (the layout c of
// mma_rows_by_rows), rounded to bf16 as the A operand; Z is a padded
// (64, D) tile.
template <int D>
__device__ __forceinline__ void mma_acc_by_tile(float (&o)[D / 8][4],
                                                const float (&p)[kBK / 8][4],
                                                const __nv_bfloat16* Z, int g,
                                                int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* zr = Z + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* zc = zr + n * 8;
      mma_16816(o[n], pa, ld_pair(zc, zc + LD), ld_pair(zc + 8 * LD, zc + 9 * LD));
    }
  }
}

template <int D>
constexpr int bwd_mma_smem_bytes() {
  return 4 * kBQ * (D + 8) * 2 + 2 * kBQ * 4;  // four bf16 tiles, lse and D_i
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
packed_attention_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ key_bias,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                            int S, int H, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, uint32_t seed, uint32_t thr,
                            float inv_keep, int dropout, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  constexpr int KT = kBK / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* dOs = Qs + kBQ * LD;
  __nv_bfloat16* Ks = dOs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long o_ss = static_cast<long long>(H) * D;
  const long long o_sb = o_ss * S;
  const long long row_bh = (static_cast<long long>(b) * H + h) * S;
  const float* bias = key_bias + static_cast<long long>(b) * S;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);

  load_tile<D>(Qs, q + b * q_sb + h * D, q_ss, q0, S, tid);
  load_tile<D>(dOs, dout + b * o_sb + h * D, o_ss, q0, S, tid);
  const __nv_bfloat16* Qw = Qs + (warp * 16) * LD;
  const __nv_bfloat16* dOw = dOs + (warp * 16) * LD;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float ls[2] = {rows[0] < S ? lse[row_bh + rows[0]] : 0.f,
                       rows[1] < S ? lse[row_bh + rows[1]] : 0.f};

  float dl[2] = {0.f, 0.f};  // pass 0: D_i = sum_j a_eff dp over the lane's keys
  float acc_dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc_dq[n][0] = acc_dq[n][1] = acc_dq[n][2] = acc_dq[n][3] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < S; k0 += kBK) {
      __syncthreads();  // the previous tile's K/V reads are done
      load_tile<D>(Ks, k + b * k_sb + h * D, k_ss, k0, S, tid);
      load_tile<D>(Vs, v + b * v_sb + h * D, v_ss, k0, S, tid);
      __syncthreads();

      float sc[KT][4], dp[KT][4];
      mma_rows_by_rows<D>(sc, Qw, Ks, g, t);
      mma_rows_by_rows<D>(dp, dOw, Vs, g, t);
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
            const float a = ok ? expf(x * sm_scale + kb - ls[r]) : 0.f;
            const float dpv = dp[j][2 * r + e];
            float a_eff = a, da = dpv;
            if (dropout) {
              const bool keep = keep_bit(static_cast<uint32_t>(rows[r]),
                                         static_cast<uint32_t>(key), hseed, thr);
              a_eff = keep ? a * inv_keep : 0.f;
              da = keep ? dpv * inv_keep : 0.f;
            }
            if (pass == 0)
              dl[r] = fmaf(a_eff, dpv, dl[r]);
            else
              x = a * (da - dl[r]) * sm_scale;  // ds
          }
        }
      }
      if (pass == 1) mma_acc_by_tile<D>(acc_dq, sc, Ks, g, t);
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
        dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
        if (rows[r] < S && t == 0) delta[row_bh + rows[r]] = dl[r];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    __nv_bfloat16* drow = dq + b * o_sb + rows[r] * o_ss + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) =
          pack_bf16(acc_dq[n][2 * r], acc_dq[n][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
packed_attention_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ key_bias,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int S, int H,
                             long long q_sb, long long q_ss, long long k_sb,
                             long long k_ss, long long v_sb, long long v_ss,
                             uint32_t seed, uint32_t thr, float inv_keep,
                             int dropout, float sm_scale) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  constexpr int QT = kBQ / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Vs = Ks + kBK * LD;
  __nv_bfloat16* Qs = Vs + kBK * LD;
  __nv_bfloat16* dOs = Qs + kBQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kBQ * LD);
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long o_ss = static_cast<long long>(H) * D;
  const long long o_sb = o_ss * S;
  const long long row_bh = (static_cast<long long>(b) * H + h) * S;
  const float* bias = key_bias + static_cast<long long>(b) * S;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);

  load_tile<D>(Ks, k + b * k_sb + h * D, k_ss, k0, S, tid);
  load_tile<D>(Vs, v + b * v_sb + h * D, v_ss, k0, S, tid);
  const __nv_bfloat16* Kw = Ks + (warp * 16) * LD;
  const __nv_bfloat16* Vw = Vs + (warp * 16) * LD;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float kb[2] = {keys[0] < S ? bias[keys[0]] : 0.f,
                       keys[1] < S ? bias[keys[1]] : 0.f};

  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
    acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += kBQ) {
    __syncthreads();  // the previous tile's Q/dO reads are done
    load_tile<D>(Qs, q + b * q_sb + h * D, q_ss, q0, S, tid);
    load_tile<D>(dOs, dout + b * o_sb + h * D, o_ss, q0, S, tid);
    if (tid < kBQ) {
      const int s = q0 + tid;
      lse_s[tid] = s < S ? lse[row_bh + s] : 0.f;
      dl_s[tid] = s < S ? delta[row_bh + s] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are this warp's keys, columns the queries.
    float st[QT][4], pt[QT][4];
    mma_rows_by_rows<D>(st, Kw, Qs, g, t);
    mma_rows_by_rows<D>(pt, Vw, dOs, g, t);
#pragma unroll
    for (int j = 0; j < QT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = j * 8 + 2 * t + e;
        const int query = q0 + qi;
        const float lq = lse_s[qi], dq_i = dl_s[qi];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = query < S && keys[r] < S;
          const float a = ok ? expf(st[j][2 * r + e] * sm_scale + kb[r] - lq) : 0.f;
          float a_eff = a, da = pt[j][2 * r + e];
          if (dropout) {
            const bool keep = keep_bit(static_cast<uint32_t>(query),
                                       static_cast<uint32_t>(keys[r]), hseed, thr);
            a_eff = keep ? a * inv_keep : 0.f;
            da = keep ? da * inv_keep : 0.f;
          }
          st[j][2 * r + e] = a * (da - dq_i) * sm_scale;  // ds^T
          pt[j][2 * r + e] = a_eff;                        // a_eff^T
        }
      }
    }
    mma_acc_by_tile<D>(acc_dv, pt, dOs, g, t);
    mma_acc_by_tile<D>(acc_dk, st, Qs, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S) continue;
    const long long off = b * o_sb + keys[r] * o_ss + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(acc_dk[n][2 * r], acc_dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
    }
  }
}

// ---- fp32 backward: FMA on the CUDA cores ---------------------------------

constexpr int kBwdThreads = 256;  // 16 x 16 threads over a 64 x 64 tile

template <int D>
constexpr int bwd_fp32_smem_floats() {
  // four (64, D + 1) tiles, two 64 x 65 score tiles, lse and D_i
  return 4 * kBQ * (D + 1) + 2 * kBQ * (kBK + 1) + 2 * kBQ;
}

// Copies a (64, D) fp32 tile of rows [r0, r0 + 64) into shared memory with
// row pitch D + 1 (conflict-free column walks); rows at or beyond S are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int r0, int S,
                                              int tid) {
  for (int i = tid; i < kBQ * D; i += kBwdThreads) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * (D + 1) + c] = s < S ? src[s * row_stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
packed_attention_bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ key_bias,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse, float* __restrict__ dq,
                             float* __restrict__ delta, int S, int H, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss,
                             long long v_sb, long long v_ss, uint32_t seed,
                             uint32_t thr, float inv_keep, int dropout,
                             float sm_scale) {
  constexpr int P = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int CT = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * P;
  float* Ks = dOs + kBQ * P;
  float* Vs = Ks + kBK * P;
  float* dS = Vs + kBK * P;  // kBQ x PS
  float* lse_s = dS + kBQ * PS;
  float* dl_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long o_ss = static_cast<long long>(H) * D;
  const long long o_sb = o_ss * S;
  const long long row_bh = (static_cast<long long>(b) * H + h) * S;
  const float* bias = key_bias + static_cast<long long>(b) * S;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);

  load_tile_f32<D>(Qs, q + b * q_sb + h * D, q_ss, q0, S, tid);
  load_tile_f32<D>(dOs, dout + b * o_sb + h * D, o_ss, q0, S, tid);
  if (tid < kBQ) lse_s[tid] = q0 + tid < S ? lse[row_bh + q0 + tid] : 0.f;

  float dl[4] = {0.f, 0.f, 0.f, 0.f};  // pass 0: partial D_i of the thread's rows
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < S; k0 += kBK) {
      __syncthreads();  // the previous tile's reads are done
      load_tile_f32<D>(Ks, k + b * k_sb + h * D, k_ss, k0, S, tid);
      load_tile_f32<D>(Vs, v + b * v_sb + h * D, v_ss, k0, S, tid);
      __syncthreads();
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty * 4 + i) * P + d];
          ov[i] = dOs[(ty * 4 + i) * P + d];
          kv[i] = Ks[(tx + 16 * i) * P + d];
          vv[i] = Vs[(tx + 16 * i) * P + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
            dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
          }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        const bool ok = key < S;
        const float kb = ok ? bias[key] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          const float a = ok ? expf(sc[i][c] * sm_scale + kb - lse_s[r]) : 0.f;
          float a_eff = a, da = dp[i][c];
          if (dropout) {
            const bool keep = keep_bit(static_cast<uint32_t>(q0 + r),
                                       static_cast<uint32_t>(key), hseed, thr);
            a_eff = keep ? a * inv_keep : 0.f;
            da = keep ? dp[i][c] * inv_keep : 0.f;
          }
          if (pass == 0)
            dl[i] = fmaf(a_eff, dp[i][c], dl[i]);
          else
            dS[r * PS + tx + 16 * c] = a * (da - dl_s[r]) * sm_scale;
        }
      }
      if (pass == 0) continue;
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = dS[(ty * 4 + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float kv = Ks[kk * P + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
        }
      }
    }
    if (pass == 0) {
      // Sum over the 16 threads (tx) that share the rows: one half-warp.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], off);
        const int r = ty * 4 + i;
        if (tx == 0) {
          dl_s[r] = dl[i];
          if (q0 + r < S) delta[row_bh + q0 + r] = dl[i];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    float* drow = dq + b * o_sb + s * o_ss + h * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) drow[tx + 16 * c] = acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
packed_attention_bwd_dkv_fp32(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ key_bias,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int S, int H, long long q_sb,
                              long long q_ss, long long k_sb, long long k_ss,
                              long long v_sb, long long v_ss, uint32_t seed,
                              uint32_t thr, float inv_keep, int dropout,
                              float sm_scale) {
  constexpr int P = D + 1;
  constexpr int PS = kBQ + 1;
  constexpr int CT = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * P;
  float* Qs = Vs + kBK * P;
  float* dOs = Qs + kBQ * P;
  float* Pt = dOs + kBQ * P;  // a_eff^T: kBK x PS
  float* dSt = Pt + kBK * PS;  // ds^T
  float* lse_s = dSt + kBK * PS;
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long o_ss = static_cast<long long>(H) * D;
  const long long o_sb = o_ss * S;
  const long long row_bh = (static_cast<long long>(b) * H + h) * S;
  const float* bias = key_bias + static_cast<long long>(b) * S;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);

  load_tile_f32<D>(Ks, k + b * k_sb + h * D, k_ss, k0, S, tid);
  load_tile_f32<D>(Vs, v + b * v_sb + h * D, v_ss, k0, S, tid);
  float kb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    kb[i] = key < S ? bias[key] : 0.f;
  }
  float acc_dk[4][CT], acc_dv[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kBQ) {
    __syncthreads();  // the previous tile's reads are done
    load_tile_f32<D>(Qs, q + b * q_sb + h * D, q_ss, q0, S, tid);
    load_tile_f32<D>(dOs, dout + b * o_sb + h * D, o_ss, q0, S, tid);
    if (tid < kBQ) {
      const int s = q0 + tid;
      lse_s[tid] = s < S ? lse[row_bh + s] : 0.f;
      dl_s[tid] = s < S ? delta[row_bh + s] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * P + d];
        vv[i] = Vs[(ty * 4 + i) * P + d];
        qv[i] = Qs[(tx + 16 * i) * P + d];
        ov[i] = dOs[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
          dpt[i][c] = fmaf(vv[i], ov[c], dpt[i][c]);
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = tx + 16 * c;
      const int query = q0 + qi;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int key = k0 + r;
        const bool ok = query < S && key < S;
        const float a = ok ? expf(st[i][c] * sm_scale + kb[i] - lse_s[qi]) : 0.f;
        float a_eff = a, da = dpt[i][c];
        if (dropout) {
          const bool keep = keep_bit(static_cast<uint32_t>(query),
                                     static_cast<uint32_t>(key), hseed, thr);
          a_eff = keep ? a * inv_keep : 0.f;
          da = keep ? da * inv_keep : 0.f;
        }
        Pt[r * PS + qi] = a_eff;
        dSt[r * PS + qi] = a * (da - dl_s[qi]) * sm_scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pr[4], sr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Pt[(ty * 4 + i) * PS + qq];
        sr[i] = dSt[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float ov = dOs[qq * P + tx + 16 * c];
        const float qv = Qs[qq * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][c] = fmaf(pr[i], ov, acc_dv[i][c]);
          acc_dk[i][c] = fmaf(sr[i], qv, acc_dk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
    const long long off = b * o_sb + key * o_ss + h * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      dk[off + tx + 16 * c] = acc_dk[i][c];
      dv[off + tx + 16 * c] = acc_dv[i][c];
    }
  }
}

// Launches the dq pass (which writes D_i) and then the dk/dv pass.
template <typename T, int kThreadsT, int kSmem>
cudaError_t launch_bwd(void (*dq_kernel)(const T*, const T*, const T*, const float*,
                                         const T*, const float*, T*, float*,
                                         int, int, long long, long long, long long,
                                         long long, long long, long long, uint32_t,
                                         uint32_t, float, int, float),
                       void (*dkv_kernel)(const T*, const T*, const T*, const float*,
                                          const T*, const float*, const float*, T*, T*,
                                          int, int, long long, long long, long long,
                                          long long, long long, long long, uint32_t,
                                          uint32_t, float, int, float),
                       const void* q, const void* k, const void* v,
                       const void* key_bias, const void* dout,
                       const void* lse, void* dq, void* dk, void* dv, void* delta,
                       int B, int S, int H, long long q_sb, long long q_ss,
                       long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                       uint32_t seed, uint32_t thr, float inv_keep, int dropout,
                       float sm_scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* kbt = static_cast<const float*>(key_bias);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  dq_kernel<<<grid, kThreadsT, kSmem, stream>>>(
      qt, kt, vt, kbt, dot, lt, static_cast<T*>(dq), dl,
      S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, seed, thr, inv_keep, dropout,
      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreadsT, kSmem, stream>>>(
      qt, kt, vt, kbt, dot, lt, dl, static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, seed, thr, inv_keep, dropout, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels).
// q/k/v as for vt_attention_fwd; dout (the output's gradient), dq, dk, dv
// are contiguous (B, S, H*D); lse is the forward's (B*H, S) fp32 lse; delta
// is (B*H, S) fp32 scratch for D_i.
extern "C" int vt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* key_bias, const void* dout,
                                const void* lse, void* dq,
                                void* dk, void* dv, void* delta, int B, int S,
                                int H, int D, long long q_sb, long long q_ss,
                                long long k_sb, long long k_ss, long long v_sb,
                                long long v_ss, int dtype, unsigned int seed,
                                unsigned int thr, float inv_keep, int dropout,
                                float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VT_ATTN_BWD(T, DD, THREADS, SMEM, DQK, DKVK)                                 \
  launch_bwd<T, THREADS, SMEM>(DQK<DD>, DKVK<DD>, q, k, v, key_bias, dout,       \
                                   lse, dq, dk, dv, delta, B, S, H, q_sb, q_ss,      \
                                   k_sb, k_ss, v_sb, v_ss, seed, thr, inv_keep,      \
                                   dropout, sm_scale, st)
  if (dtype == 0 && D == 64)
    return VT_ATTN_BWD(float, 64, kBwdThreads, bwd_fp32_smem_floats<64>() * 4,
                       packed_attention_bwd_dq_fp32, packed_attention_bwd_dkv_fp32);
  if (dtype == 0 && D == 128)
    return VT_ATTN_BWD(float, 128, kBwdThreads, bwd_fp32_smem_floats<128>() * 4,
                       packed_attention_bwd_dq_fp32, packed_attention_bwd_dkv_fp32);
  if (dtype == 1 && D == 64)
    return VT_ATTN_BWD(__nv_bfloat16, 64, kMmaThreads, bwd_mma_smem_bytes<64>(),
                       packed_attention_bwd_dq_mma, packed_attention_bwd_dkv_mma);
  if (dtype == 1 && D == 128)
    return VT_ATTN_BWD(__nv_bfloat16, 128, kMmaThreads, bwd_mma_smem_bytes<128>(),
                       packed_attention_bwd_dq_mma, packed_attention_bwd_dkv_mma);
#undef VT_ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

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
