// Attention for Hopper (sm_90a): forward (K1f, K4f, K5f) and, further down,
// backward (K1b, K4b, K5b).
//
// The fused self-attention kernels (K1, K4) and the flash kernels (K5) share
// one set of device bodies.  Every kernel takes the query length SQ and the
// key length SK separately; K1 and K4 pass SQ = SK = S (self-attention), K5
// any pair (both multiples of 128 at its gate; the kernels themselves take
// any length and are not sized by it).  The entries differ in the
// backward's D_i (see the backward's note): K1b/K4b sum it in the dq kernel,
// K5b reads the rowsum(out * dO) that its pre-pass kernel writes.
//
// Replaces: visitron_tpu/ops/attention.py:_fused_packed_fwd_kernel, reached
// through _fused_packed_forward (the Pallas call of fused_attention_packed),
// and _fused_fwd_kernel, reached through _fused_forward (fused_attention on
// (B, H, S, D)).  The two TPU kernels compute the same function with the same
// dropout head id (b*H + h); they differ only in the layout of their
// operands.  Here one set of kernels serves both: every operand is addressed
// through its own (batch, head, sequence) element strides (AttnStrides), with
// the head dim contiguous.  The packed (B, S, H*D) layout has head stride D;
// a (B, H, S, D) view of the packed QKV projection has the same strides, and
// a contiguous (B, H, S, D) tensor has head stride S*D.
// Same function: for each (batch b, head h) of q/k/v,
//   s = (q_h k_h^T) / sqrt(D) + key_bias[b]   (fp32)
//   a = softmax(s) over full rows             (fp32)
//   a = where(keep(q, k), a, 0) / (1 - rate)  (optional hash dropout)
//   out_h = a.astype(v.dtype) @ v_h           (fp32 accumulation)
// plus, on request, lse = m + log(l) per row as (B*H, S) fp32.
// K5f (visitron_tpu/ops/attention.py:_fwd_kernel, reached through
// _flash_forward, the Pallas call of flash_attention) computes the same
// function with Q and K lengths of their own: p = exp(s - m) unnormalised,
// dropped, rounded to v's dtype for the PV product, out = acc / l and
// lse = m + log(l), both guarded where l == 0.  It is the same body: the TPU
// flash kernel's 128 x 128 blocks are an online softmax over key blocks too,
// and the mask hashes absolute coordinates, so any tiling gives its bits.
//
// What bounds the forward on an H100 (bf16, 12 heads of 64): at K1's serving
// shape (B 64, S 256) the bytes: q, k, v and out once each are 101 MB, 0.0301
// ms at 3.35 TB/s, against 12.9 GFLOP, 0.0130 ms at 989 TFLOP/s.  At K4's
// pretraining shape (B 16, S 768) and K5's long-context shape (B 16, S 1024)
// the operations: 29.0 and 51.5 GFLOP, 0.0293 and 0.0521 ms, against 75 and
// 101 MB.  Beside the products every score element costs one exponential,
// and at D 64 the SM's 16 exponentials a cycle take as long as the 4 D = 256
// product operations of the element at 4096 a cycle: the exponentials of one
// block have to run while other blocks' products do.  At rate > 0 each
// element also costs the murmur3 tail (two multiplies, four shifts and xors,
// a compare), which the integer units take longer over than the products.
//
// Design against what the TPU kernel relied on: the Pallas kernel keeps a
// whole (S, S) fp32 score matrix per head in VMEM (1 MB at S = 512), which no
// SM has.  Here one block takes one (b, h, 64-row query tile) and walks
// 64-wide K/V tiles with an online max/sum (flash-style), which is the same
// function as the full-row softmax.  Rows are read in place through each
// operand's strides, so q/k/v may be strided views of the fused QKV
// projection with no split or transpose copies.  Dropout recomputes the TPU
// kernel's murmur3 position hash over the absolute (query, key) indices of
// the head, so masks match it bit for bit; l counts every probability, kept
// or not, as there.  The unnormalised probabilities are rounded to v's dtype
// before the PV product (the TPU kernel rounds the normalised ones: the two
// differ at the dtype's rounding level).
//
// Two instantiations:
//   * bf16, built for Hopper (attention_fwd_wgmma): a block is two
//     warpgroups, each owning 64 query rows, sharing one stream of K/V tiles
//     (half the copies and L2 reads per query of one warpgroup a block).
//     S = Q K^T runs on wgmma m64n64k16 with both operands from shared
//     memory, Q resident and K streamed, both K-major (this measured faster
//     than Q's A fragments held in registers, which cost 16 of the 128
//     registers a thread); O += P V takes P from registers (the score
//     accumulators' layout is the A-fragment layout) and V through wgmma's
//     transpose bit.  O (64 x D fp32 a warpgroup) and S live in registers.
//     K/V tiles stream through a three-stage cp.async ring in the 128-byte
//     swizzle, one barrier a tile: tile i + 1's copy is in flight while tile
//     i's products and exponentials run, and tile i's PV batch runs on into
//     tile i + 1's barrier.  log2 e is folded into the score scale and the
//     key bias, so an element costs one FMA, one subtraction and one
//     ex2.approx; the running max works in log2 units and the lse is
//     converted back once per row.  The key bias (times log2 e) and each
//     key's hash term are staged once per tile in shared memory, each row's
//     hash term is computed once.  Two blocks share an SM at D 64 (one at
//     D 128); there is no warp specialisation, so one block's exponentials
//     run beside the other's products.
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
// visitron_tpu/ops/attention.py:_keep_mask, in native uint32 arithmetic:
// keep_tail(mix16(x)) for x = (r * 0x9E3779B1) ^ (c * 0x85EBCA77) ^ seed.
// The first step, mix16, distributes over ^, so a kernel may apply it to the
// row term (with the seed) and the column term once each and pass keep_tail
// the ^ of the two.
__device__ __forceinline__ uint32_t mix16(uint32_t x) { return x ^ (x >> 16); }

__device__ __forceinline__ bool keep_tail(uint32_t x, uint32_t thr) {
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thr;
}

__device__ __forceinline__ bool keep_bit(uint32_t r, uint32_t c, uint32_t seed,
                                         uint32_t thr) {
  return keep_tail(mix16((r * 0x9E3779B1u) ^ (c * 0x85EBCA77u) ^ seed), thr);
}

// Element strides of one operand seen as (B, H, S, D); D is contiguous.
struct Strides {
  long long b, h, s;
};
struct AttnStrides {
  Strides q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ long long head_off(const Strides& t, int b, int h) {
  return b * t.b + h * t.h;
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
attention_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ key_bias,
                          float* __restrict__ out, float* __restrict__ lse, int SQ,
                          int SK, int H, AttnStrides st, uint32_t seed, uint32_t thr,
                          float inv_keep, int dropout, float sm_scale) {
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

  const float* bias = key_bias + static_cast<long long>(b) * SK;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  // This block's head: every operand from here on is its (S, D) slice.
  q += head_off(st.q, b, h);
  k += head_off(st.k, b, h);
  v += head_off(st.v, b, h);
  out += head_off(st.o, b, h);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * DP + d] = s < SQ ? q[s * st.q.s + d] : 0.f;
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

  for (int k0 = 0; k0 < SK; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool ok = s < SK;
      Ks[r * DP + d] = ok ? k[s * st.k.s + d] : 0.f;
      Vs[r * D + d] = ok ? v[s * st.v.s + d] : 0.f;
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
    const float b0 = c0 < SK ? bias[c0] : 0.f;
    const float b1 = c1 < SK ? bias[c1] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s0 = c0 < SK ? sc[r][0] * sm_scale + b0 : -INFINITY;
      const float s1 = c1 < SK ? sc[r][1] * sm_scale + b1 : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);  // finite: key k0 < SK is in every tile
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
    if (s >= SQ) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];  // the TPU kernels' l == 0 guard
    const float inv = 1.f / lr;
    float* orow = out + s * st.o.s + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) orow[t] = o[r][t] * inv;
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * H + h) * SQ + s] = m[r] + logf(lr);
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const void* key_bias, void* out, void* lse, int B, int SQ,
                        int SK, int H, const AttnStrides& st, uint32_t seed,
                        uint32_t thr, float inv_keep, int dropout, float sm_scale,
                        cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SQ + kBQ - 1) / kBQ, H, B);
  attention_fwd_fp32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<float*>(out), static_cast<float*>(lse), SQ, SK, H, st, seed, thr,
      inv_keep, dropout, sm_scale);
  return cudaGetLastError();
}

// ---- bf16: shared by the forward and the backward --------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Threads of a warpgroup, which owns 64 rows of a tile (a backward block is
// one warpgroup).
constexpr int kWgThreads = 128;

// Two bf16 values as one fragment register: `lo` in the low half (the
// smaller column index), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies and orders them before wgmma's reads; the
// tiles are the block's once it has passed a barrier.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies rows [r0, r0 + 64) of an (S, D) bf16 operand with row stride
// `stride` (elements) into a 128-byte-swizzled tile at shared address `dst`:
// D / 64 column blocks of 64 rows x 128 bytes, 16-byte chunk c of row r at
// c ^ (r % 8).  Rows at or beyond S are zero-filled (their source address is
// row S - 1, of which no byte is read).  The block's NT threads share it.
template <int D, int NT>
__device__ __forceinline__ void cp_tile(uint32_t dst, const __nv_bfloat16* src,
                                        long long stride, int r0, int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < 64 * CPR / NT; ++j) {
    const int ci = tid + j * NT;
    const int row = ci / CPR, cc = ci % CPR, s = r0 + row;
    const uint32_t off = (cc >> 3) * (64 * 128) + row * 128 + (((cc & 7) ^ (row & 7)) << 4);
    cp_async16(dst + off, src + static_cast<long long>(min(s, S - 1)) * stride + cc * 8,
               s < S ? 16 : 0);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`.
// K-major operands (the contracted dim contiguous) ignore `lead`; MN-major
// ones (wgmma's transpose bit) take the bytes between 64-column blocks.
// Either way 8-row groups are 1024 bytes apart.  Tile bases are 1024-byte
// aligned, so the base-offset field stays 0 where a k-step starts 32, 64 or
// 96 bytes into a row.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous product, which it cannot see: applied to the accumulators and
// A fragments before each wgmma_fence (else ptxas finds their definitions
// inside the product batch and serialises it) and after each wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define VT_ACC32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define VT_ACC32_OPS(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),            \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])

// d (64 x 64 fp32; overwritten unless `acc`) += A B^T over one k-step of 16:
// A and B from shared memory, both K-major.  Thread (warp w, lane) holds
// d[4j + 2h + e] = row 16w + lane/4 + 8h, column 8j + 2(lane%4) + e.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VT_ACC32_OPS(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64 fp32) += A B over one k-step of 16: A from registers (the
// m16n8k16 A fragment of the warp's 16 rows), B from shared memory,
// MN-major (rows along the contracted dim).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VT_ACC32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The 64 x 64 fp32 tile x (wgmma_ss's layout) rounded to bf16 as the A
// fragments of four k-steps (columns 16kk .. 16kk + 15).
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// d[cb] += F Z for the 64-row streamed tile Z (64 x D, at `tile`) and the
// fragments F of a 64 x 64 computed tile: four k-steps along Z's rows, one
// n64 product per 64-column block.
template <int NCB>
__device__ __forceinline__ void wgmma_frags_by_tile(float (&d)[NCB][32],
                                                    const uint32_t (&f)[4][4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      wgmma_rs(d[cb], f[kk], gmma_desc(tile + cb * 8192 + kk * 2048, 8192));
}

// The streamed tiles' ring: the copy of tile i + 1 goes to the stage that
// tile i - 2 used, whose products the warpgroup has waited for (the last
// product batch of tile i - 1 may still be reading its stage).
constexpr int kStages = 3;

// ---- bf16 forward: wgmma ----------------------------------------------------

// Warpgroups of a forward block, each owning 64 query rows.  They share the
// K/V ring, which halves the tile copies and L2 reads per query against a
// block of one warpgroup (measured faster on an H100, PERF.md).
constexpr int kFwdWarpgroups = 2;
constexpr int kFwdThreads = kFwdWarpgroups * kWgThreads;
constexpr int kFwdRows = 64 * kFwdWarpgroups;

// The forward's shared memory: slack for aligning the tiles to 1024 bytes,
// the ring of (K, V) tile pairs, the warpgroups' Q tiles, and two words of
// streamed per-key values for each of the 64 keys of a stage.
template <int D>
constexpr int fwd_wgmma_smem_bytes() {
  return 1024 + kStages * (2 * 64 * D * 2 + 2 * 64 * 4) + kFwdWarpgroups * 64 * D * 2;
}

// One block per (b, h, 128 queries), walking the key tiles.  Two blocks
// share an SM at D 64 (128 registers a thread), one at D 128.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kFwdThreads, D == 64 ? 2 : 1)
attention_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ key_bias, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int SQ, int SK, int H, AttnStrides st,
                    uint32_t seed, uint32_t thr, float inv_keep, float sm_scale) {
  constexpr int NCB = D / 64;
  constexpr int TILE = 64 * D * 2;  // bytes of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // stage s: K, V
  const uint32_t sQ = ring + kStages * 2 * TILE;  // warpgroup w's rows at sQ + w TILE
  // Per stage and key of the tile: the bias (times log2 e), then the key's
  // hash term mix16(key * 0x85EBCA77).
  float* kb_s = reinterpret_cast<float*>(smem_raw + (sQ + kFwdWarpgroups * TILE - raw));
  uint32_t* km_s = reinterpret_cast<uint32_t*>(kb_s + kStages * 64);

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wl = (tid >> 5) & 3;  // the warp in its warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* bias = key_bias + static_cast<long long>(b) * SK;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  const float scale2 = sm_scale * kLog2e;
  // This block's head: every operand from here on is its (S, D) slice.
  q += head_off(st.q, b, h);
  k += head_off(st.k, b, h);
  v += head_off(st.v, b, h);
  out += head_off(st.o, b, h);

#pragma unroll
  for (int w = 0; w < kFwdWarpgroups; ++w)
    cp_tile<D, kFwdThreads>(sQ + w * TILE, q, st.q.s, q0 + 64 * w, SQ, tid);
  cp_tile<D, kFwdThreads>(ring, k, st.k.s, 0, SK, tid);
  cp_tile<D, kFwdThreads>(ring + TILE, v, st.v.s, 0, SK, tid);
  cp_async_commit();
  if (tid < 64) {
    kb_s[tid] = tid < SK ? bias[tid] * kLog2e : -INFINITY;
    if (kDropout) km_s[tid] = mix16(static_cast<uint32_t>(tid) * 0x85EBCA77u);
  }
  const uint32_t sQw = sQ + wg * TILE;
  const int rows[2] = {q0 + 64 * wg + 16 * wl + g, q0 + 64 * wg + 16 * wl + g + 8};
  uint32_t rmix[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rmix[r] = mix16((static_cast<uint32_t>(rows[r]) * 0x9E3779B1u) ^ hseed);

  // m2: the running row maxima in log2 units; l: this thread's part of the
  // row sums (its 16 keys of each tile), summed over the row's 4 lanes at
  // the end.
  float o[NCB][32], s[32];
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) o[cb][i] = 0.f;
    s[i] = 0.f;
  }

  const int nk = (SK + 63) / 64;
  // A do-while: nk >= 1, and a path that skipped the loop would leave the
  // accumulators defined by plain moves before the final wait, for which
  // ptxas serialises every product batch.
  int i = 0, stage = 0;
  do {
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    const uint32_t sK = ring + stage * 2 * TILE, sV = sK + TILE;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; tile i - 2's stage is free
    float kb_next = 0.f;
    const int kn = (i + 1) * 64;
    if (i + 1 < nk) {
      const uint32_t nK = ring + next * 2 * TILE;
      cp_tile<D, kFwdThreads>(nK, k, st.k.s, kn, SK, tid);
      cp_tile<D, kFwdThreads>(nK + TILE, v, st.v.s, kn, SK, tid);
      if (tid < 64) kb_next = kn + tid < SK ? bias[kn + tid] * kLog2e : -INFINITY;
    }
    cp_async_commit();

    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(sQw + ko, 16), gmma_desc(sK + ko, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();  // also the previous tile's PV batch
    reg_fence(s);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);

    // s = q.k * scale * log2 e + bias * log2 e (-inf past SK); row maxima
    // over the 4 lanes of a row.
    const float* kbs = kb_s + stage * 64;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(kbs + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          x = fmaf(x, scale2, e ? kb.y : kb.x);
          mx[r] = fmaxf(mx[r], x);
        }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m2[r], mx[r]);  // finite: key 64i < SK is in every tile
      corr[r] = ex2(m2[r] - m_new);
      m2[r] = m_new;
      l[r] *= corr[r];
    }
    const uint32_t* kms = km_s + stage * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint2 km = make_uint2(0u, 0u);
      if (kDropout) km = *reinterpret_cast<const uint2*>(kms + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          const float p = ex2(x - m2[r]);
          l[r] += p;
          x = kDropout ? p * (keep_tail(rmix[r] ^ (e ? km.y : km.x), thr) ? inv_keep : 0.f)
                       : p;
        }
    }
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[cb][j] *= corr[(j >> 1) & 1];

    // O += P V with P rounded to bf16, waited for by the next tile's wait.
    uint32_t f[4][4];
    to_frags(f, s);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);
    reg_fence(f);
    wgmma_fence();
    wgmma_frags_by_tile<NCB>(o, f, sV);
    wgmma_commit();
    if (i + 1 < nk && tid < 64) {
      kb_s[next * 64 + tid] = kb_next;
      if (kDropout) km_s[next * 64 + tid] = mix16(static_cast<uint32_t>(kn + tid) * 0x85EBCA77u);
    }
    stage = next;
  } while (++i < nk);
  wgmma_wait();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= SQ) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];  // the TPU kernels' l == 0 guard
    const float inv = 1.f / lr;
    __nv_bfloat16* orow = out + rows[r] * st.o.s + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + cb * 64 + 8 * j) =
            pack_bf16(o[cb][4 * j + 2 * r] * inv, o[cb][4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * H + h) * SQ + rows[r]] = m2[r] * kLn2 + logf(lr);
  }
}

template <int D, bool kDropout>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             const void* key_bias, void* out, void* lse, int B, int SQ,
                             int SK, int H, const AttnStrides& st, uint32_t seed,
                             uint32_t thr, float inv_keep, float sm_scale,
                             cudaStream_t stream) {
  constexpr int smem = fwd_wgmma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_wgmma<D, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  attention_fwd_wgmma<D, kDropout>
      <<<dim3((SQ + kFwdRows - 1) / kFwdRows, H, B), kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<bf16*>(out), static_cast<float*>(lse),
      SQ, SK, H, st, seed, thr, inv_keep, sm_scale);
  return cudaGetLastError();
}

// ============================================================================
// Backward (K1b, K4b, K5b).
//
// Replaces: visitron_tpu/ops/attention.py:_fused_packed_bwd_kernel, reached
// through _fused_packed_bwd_rule, and _fused_bwd_kernel, reached through
// _fused_bwd_rule (fused_attention's VJP).  Same function, per (b, h), with the lse
// that the forward wrote:
//   a    = exp(s - lse)                  (s as in the forward, fp32)
//   dp   = dO v^T                        (fp32)
//   a_eff, da = where(keep, a, 0)/(1-r), where(keep, dp, 0)/(1-r)
//   dv   = a_eff.astype(dtype)^T dO
//   D_i  = sum_j a_eff_ij dp_ij
//   ds   = (a * (da - D_i) * scale).astype(dtype)
//   dq   = ds k,  dk = ds^T q            (fp32 accumulation, stored in dtype)
// The key bias gets no gradient.
// K5b (visitron_tpu/ops/attention.py:_bwd_dkv_kernel and _bwd_dq_kernel,
// reached through _flash_bwd_rule) computes the same with Q and K lengths of
// their own and one difference: D_i = rowsum(out * dO) in fp32 from the
// rounded output, which the rule computes in XLA outside its two Pallas
// kernels.  Here a pre-pass kernel (attention_bwd_di) reads out and dO and
// writes it before the two main kernels.  Given D_i, the dq kernel skips its
// first walk, so K5b runs 7 S x S x D products per head (the TPU kernels' 7;
// 5 are the minimum) and K1b/K4b 9.
//
// What bounds it on an H100: at the NDH train shape (K1b: B 64, S 256,
// 12 x 64, bf16) the bytes: reading q, k, v, dO and the lse and writing dq,
// dk, dv takes 0.0528 ms at 3.35 TB/s against 0.0326 ms for the 5 minimum
// products at the bf16 tensor-core rate.  From about S 512 on it is the
// operations (K4b at B 16, S 768: 72.5 GFLOP, 0.0733 ms; K5b at S 1024:
// 128.8 GFLOP, 0.1303 ms).  Beside the products, every score element costs
// one exp2, a dozen scalar operations and, at rate > 0, the murmur3 hash,
// which the tensor-core work has to cover.
//
// Design against what the TPU kernel relied on: the Pallas kernel holds the
// whole (S, S) score matrix of a head in VMEM and produces dq, dk and dv in
// one program.  No SM has room for that, and blocks cannot carry sums across
// the grid, so the work is split flash-style into two launches that need no
// atomics (results are the same run to run):
//   1. dq, one block per (b, h, 64-query tile), Q and dO resident in shared
//      memory, K and V streaming: for K1b/K4b a first walk over the key tiles
//      sums D_i = sum_j a_eff dp (the fused TPU kernels' formula, not the
//      flash shortcut rowsum(dO * out): with out rounded to bf16 that shortcut
//      leaves ds = O(2^-9 |dp|) where the exact ds is 0, e.g. for a query with
//      a single unmasked key) and writes it; for K5b D_i comes in; a second
//      walk forms ds and accumulates dq;
//   2. dk/dv, one block per (b, h, 64-key tile), K and V resident, the Q,
//      dO, lse and D_i tiles streaming.
// Both recompute s, a and the murmur3 keep mask from q, k, the bias, the lse
// and the per-head seed, bit for bit as the forward does.  Every operand is
// addressed through its own strides: q, k, v are views of the fused QKV
// projection, dO is what autograd hands back, dq, dk, dv are allocated
// (B, S, H, D) by the wrapper.  Nothing is sized by the lengths.
//
// bf16, built for Hopper (sm_90a):
//   * Products on wgmma.  A block is one warpgroup, which owns the 64 rows of
//     its resident tile.  S = Q K^T and dP = dO V^T in the dq
//     kernel, S^T = K Q^T and dP^T = V dO^T in the dk/dv kernel read both
//     operands from shared memory.  dq += dS K, dv += P^T dO and dk += dS^T Q
//     take the computed tile from registers (the accumulator layout of one
//     product is the A-fragment layout of the next) and the streamed tile
//     through wgmma's transpose bit: no operand is copied transposed.
//   * Tiles sit in shared memory in the 128-byte swizzle that wgmma reads
//     (64-column blocks of 128-byte rows; 16-byte chunk c of row r at
//     c ^ (r % 8)), written by cp.async 16-byte copies.  The streamed tiles go
//     through a three-stage ring, one barrier a tile: the copy of tile i + 1
//     is in flight while the products and exponentials of tile i run, and
//     the last product batch of tile i runs on into tile i + 1's barrier.
//     cp.async rather than TMA: q, k and v are strided views that change
//     every call, and cp.async needs no tensor map encoded on the host per
//     operand and call (nor libcuda), while a tile is 8-16 KB, a
//     few copy instructions a thread.
//   * exp2 on pre-scaled operands: log2(e) is folded into the score scale,
//     the key bias and the lse (each converted once per row or tile), so a
//     score element costs one FMA, one subtraction and one ex2.approx.
//   * Ragged tiles cost nothing per element: rows past a length are
//     zero-filled by the copies, and the key bias / lse of those rows are
//     -inf / +inf, so their probabilities are exactly 0.  Any length is taken
//     (the gates admit multiples of 128).
//   * The exponentials of one block overlap the products of the others: at
//     D 64 three blocks share an SM (168 registers a thread), which measured
//     faster on an H100 than two warpgroups sharing the streamed tiles in a
//     block of 256 threads (PERF.md); there is no warp specialisation.
// fp32 (a tight reference on the card): FMA on the CUDA cores, 256 threads,
// each owning a 4 x 4 block of the score tile and a 4 x D/16 block of the
// output.

// The shared-memory layout of both main kernels: two resident (64, D)
// tiles, the ring of pairs of streamed (64, D) tiles, three words of
// streamed per-row values for each of the 64 rows of a stage, and slack for
// aligning the tiles to 1024 bytes.
template <int D>
constexpr int bwd_wgmma_smem_bytes() {
  return 1024 + 2 * 64 * D * 2 + kStages * (2 * 64 * D * 2 + 3 * 64 * 4);
}

// dq (and, for K1b/K4b, D_i): one block per (b, h, 64 queries).
template <int D, bool kDropout>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : 1)
attention_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ key_bias,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ delta, int delta_given, int SQ, int SK, int H,
                       AttnStrides st, uint32_t seed, uint32_t thr, float inv_keep,
                       float sm_scale) {
  constexpr int NCB = D / 64;
  constexpr int TILE = 64 * D * 2;  // bytes of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + TILE, ring = base + 2 * TILE;  // stage s: K, V
  // Per stage and key of the tile: the bias (times log2 e), then the key's
  // hash term mix16(key * 0x85EBCA77).
  float* kb_s = reinterpret_cast<float*>(smem_raw + (ring + kStages * 2 * TILE - raw));
  uint32_t* km_s = reinterpret_cast<uint32_t*>(kb_s + kStages * 64);

  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wl = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long row_bh = (static_cast<long long>(b) * H + h) * SQ;
  const float* bias = key_bias + static_cast<long long>(b) * SK;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  const float scale2 = sm_scale * kLog2e;
  // This block's head: every operand from here on is its (S, D) slice.
  q += head_off(st.q, b, h);
  k += head_off(st.k, b, h);
  v += head_off(st.v, b, h);
  dout += head_off(st.dout, b, h);
  dq += head_off(st.dq, b, h);

  cp_tile<D, kWgThreads>(sQ, q, st.q.s, q0, SQ, tid);
  cp_tile<D, kWgThreads>(sdO, dout, st.dout.s, q0, SQ, tid);
  cp_tile<D, kWgThreads>(ring, k, st.k.s, 0, SK, tid);
  cp_tile<D, kWgThreads>(ring + TILE, v, st.v.s, 0, SK, tid);
  cp_async_commit();
  if (tid < 64) {
    kb_s[tid] = tid < SK ? bias[tid] * kLog2e : -INFINITY;
    km_s[tid] = mix16(static_cast<uint32_t>(tid) * 0x85EBCA77u);
  }

  const int rows[2] = {q0 + 16 * wl + g, q0 + 16 * wl + g + 8};
  float lse2[2], dl[2];
  uint32_t rmix[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < SQ;
    lse2[r] = ok ? lse[row_bh + rows[r]] * kLog2e : INFINITY;
    dl[r] = ok && delta_given ? delta[row_bh + rows[r]] : 0.f;
    rmix[r] = mix16((static_cast<uint32_t>(rows[r]) * 0x9E3779B1u) ^ hseed);
  }
  float acc[NCB][32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) acc[cb][i] = 0.f;
    s[i] = dp[i] = 0.f;
  }

  // Key tiles, walked once (K5b) or twice (K1b/K4b: D_i, then dq).
  const int nk = (SK + 63) / 64;
  const int n = delta_given ? nk : 2 * nk;
  // A do-while: n >= 1, and a path that skipped the loop would leave the
  // accumulators defined by plain moves before the final wait, for which
  // ptxas serialises every product batch.
  int i = 0, stage = 0;
  do {
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    const int k0 = (i < nk ? i : i - nk) * 64;
    const bool pass0 = !delta_given && i < nk;
    const uint32_t sK = ring + stage * 2 * TILE, sV = sK + TILE;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; tile i - 2's stage is free
    float kb_next = 0.f;
    const int kn = (i + 1 < nk ? i + 1 : i + 1 - nk) * 64;
    if (i + 1 < n) {
      const uint32_t nK = ring + next * 2 * TILE;
      cp_tile<D, kWgThreads>(nK, k, st.k.s, kn, SK, tid);
      cp_tile<D, kWgThreads>(nK + TILE, v, st.v.s, kn, SK, tid);
      if (tid < 64) kb_next = kn + tid < SK ? bias[kn + tid] * kLog2e : -INFINITY;
    }
    cp_async_commit();

    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(sQ + ko, 16), gmma_desc(sK + ko, 16), kk > 0);
      wgmma_ss(dp, gmma_desc(sdO + ko, 16), gmma_desc(sV + ko, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();  // also the previous tile's dq batch
    reg_fence(s);
    reg_fence(dp);

    const float* kbs = kb_s + stage * 64;
    const uint32_t* kms = km_s + stage * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(kbs + 8 * j + 2 * t);
      const uint2 km = *reinterpret_cast<const uint2*>(kms + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          const float a = ex2(fmaf(x, scale2, e ? kb.y : kb.x) - lse2[r]);
          const float dpv = dp[4 * j + 2 * r + e];
          float a_eff = a, da = dpv;
          if (kDropout) {
            const float m = keep_tail(rmix[r] ^ (e ? km.y : km.x), thr) ? inv_keep : 0.f;
            a_eff = a * m;
            da = dpv * m;
          }
          if (pass0)
            dl[r] = fmaf(a_eff, dpv, dl[r]);
          else
            x = a * (da - dl[r]) * sm_scale;  // ds
        }
      }
    }
    if (pass0) {
      if (i == nk - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
          dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
          if (rows[r] < SQ && t == 0) delta[row_bh + rows[r]] = dl[r];
        }
      }
    } else {
      uint32_t f[4][4];
      to_frags(f, s);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) reg_fence(acc[cb]);
      reg_fence(f);
      wgmma_fence();
      wgmma_frags_by_tile<NCB>(acc, f, sK);  // dq += ds k, waited for by the next tile
      wgmma_commit();
    }
    if (i + 1 < n && tid < 64) {
      kb_s[next * 64 + tid] = kb_next;
      km_s[next * 64 + tid] = mix16(static_cast<uint32_t>(kn + tid) * 0x85EBCA77u);
    }
    stage = next;
  } while (++i < n);
  wgmma_wait();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) reg_fence(acc[cb]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= SQ) continue;
    __nv_bfloat16* drow = dq + rows[r] * st.dq.s + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(drow + cb * 64 + 8 * j) =
            pack_bf16(acc[cb][4 * j + 2 * r], acc[cb][4 * j + 2 * r + 1]);
  }
}

// dk and dv: one block per (b, h, 64 keys), walking the query tiles.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : 1)
attention_bwd_dkv_wgmma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ key_bias,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int SQ, int SK, int H, AttnStrides st, uint32_t seed, uint32_t thr,
                        float inv_keep, float sm_scale) {
  constexpr int NCB = D / 64;
  constexpr int TILE = 64 * D * 2;  // bytes of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + TILE, ring = base + 2 * TILE;  // stage s: Q, dO
  // Per stage and query of the tile: the lse (times log2 e), D_i, and the
  // query's hash term mix16(query * 0x9E3779B1 ^ seed).
  float* stats = reinterpret_cast<float*>(smem_raw + (ring + kStages * 2 * TILE - raw));
  uint32_t* qm_s = reinterpret_cast<uint32_t*>(stats + kStages * 128);

  const int k0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wl = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long row_bh = (static_cast<long long>(b) * H + h) * SQ;
  const float* bias = key_bias + static_cast<long long>(b) * SK;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  const float scale2 = sm_scale * kLog2e;
  // This block's head: every operand from here on is its (S, D) slice.
  q += head_off(st.q, b, h);
  k += head_off(st.k, b, h);
  v += head_off(st.v, b, h);
  dout += head_off(st.dout, b, h);
  dk += head_off(st.dk, b, h);
  dv += head_off(st.dv, b, h);

  cp_tile<D, kWgThreads>(sK, k, st.k.s, k0, SK, tid);
  cp_tile<D, kWgThreads>(sV, v, st.v.s, k0, SK, tid);
  cp_tile<D, kWgThreads>(ring, q, st.q.s, 0, SQ, tid);
  cp_tile<D, kWgThreads>(ring + TILE, dout, st.dout.s, 0, SQ, tid);
  cp_async_commit();
  if (tid < 64) {
    stats[tid] = tid < SQ ? lse[row_bh + tid] * kLog2e : INFINITY;
    qm_s[tid] = mix16((static_cast<uint32_t>(tid) * 0x9E3779B1u) ^ hseed);
  } else {
    stats[tid] = tid - 64 < SQ ? delta[row_bh + tid - 64] : 0.f;
  }

  // Rows of the transposed tiles are this thread's keys, columns the queries.
  const int keys[2] = {k0 + 16 * wl + g, k0 + 16 * wl + g + 8};
  float kb2[2];
  uint32_t kmix[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kb2[r] = keys[r] < SK ? bias[keys[r]] * kLog2e : -INFINITY;
    kmix[r] = mix16(static_cast<uint32_t>(keys[r]) * 0x85EBCA77u);
  }
  float acc_dk[NCB][32], acc_dv[NCB][32], s[32], dp[32];  // s, dp: S^T and dP^T
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) acc_dk[cb][i] = acc_dv[cb][i] = 0.f;
    s[i] = dp[i] = 0.f;
  }

  const int nq = (SQ + 63) / 64;
  int i = 0, stage = 0;
  do {  // nq >= 1 (see the dq kernel)
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    const int q0 = i * 64;
    const uint32_t sQ = ring + stage * 2 * TILE, sdO = sQ + TILE;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; tile i - 2's stage is free
    float stat_next = 0.f;
    const int qn = q0 + 64;
    if (i + 1 < nq) {
      const uint32_t nQ = ring + next * 2 * TILE;
      cp_tile<D, kWgThreads>(nQ, q, st.q.s, qn, SQ, tid);
      cp_tile<D, kWgThreads>(nQ + TILE, dout, st.dout.s, qn, SQ, tid);
      if (tid < 64)
        stat_next = qn + tid < SQ ? lse[row_bh + qn + tid] * kLog2e : INFINITY;
      else
        stat_next = qn + tid - 64 < SQ ? delta[row_bh + qn + tid - 64] : 0.f;
    }
    cp_async_commit();

    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss(s, gmma_desc(sK + ko, 16), gmma_desc(sQ + ko, 16), kk > 0);
      wgmma_ss(dp, gmma_desc(sV + ko, 16), gmma_desc(sdO + ko, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();  // also the previous tile's dk/dv batch
    reg_fence(s);
    reg_fence(dp);

    const float* ls = stats + stage * 128;
    const uint32_t* qms = qm_s + stage * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 di = *reinterpret_cast<const float2*>(ls + 64 + 8 * j + 2 * t);
      const uint2 qm = *reinterpret_cast<const uint2*>(qms + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          float& y = dp[4 * j + 2 * r + e];
          const float a = ex2(fmaf(x, scale2, kb2[r]) - (e ? lq.y : lq.x));
          float a_eff = a, da = y;
          if (kDropout) {
            const float m = keep_tail((e ? qm.y : qm.x) ^ kmix[r], thr) ? inv_keep : 0.f;
            a_eff = a * m;
            da = y * m;
          }
          x = a * (da - (e ? di.y : di.x)) * sm_scale;  // ds^T
          y = a_eff;                                    // a_eff^T
        }
      }
    }
    uint32_t fp[4][4], fs[4][4];
    to_frags(fp, dp);
    to_frags(fs, s);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      reg_fence(acc_dv[cb]);
      reg_fence(acc_dk[cb]);
    }
    reg_fence(fp);
    reg_fence(fs);
    // dv += a_eff^T dO, dk += ds^T q: waited for by the next tile's products.
    wgmma_fence();
    wgmma_frags_by_tile<NCB>(acc_dv, fp, sdO);
    wgmma_frags_by_tile<NCB>(acc_dk, fs, sQ);
    wgmma_commit();
    if (i + 1 < nq) {
      stats[next * 128 + tid] = stat_next;
      if (tid < 64)
        qm_s[next * 64 + tid] = mix16((static_cast<uint32_t>(qn + tid) * 0x9E3779B1u) ^ hseed);
    }
    stage = next;
  } while (++i < nq);
  wgmma_wait();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
    reg_fence(acc_dv[cb]);
    reg_fence(acc_dk[cb]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= SK) continue;
    __nv_bfloat16* dkr = dk + keys[r] * st.dk.s + 2 * t;
    __nv_bfloat16* dvr = dv + keys[r] * st.dv.s + 2 * t;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + cb * 64 + 8 * j) =
            pack_bf16(acc_dk[cb][4 * j + 2 * r], acc_dk[cb][4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvr + cb * 64 + 8 * j) =
            pack_bf16(acc_dv[cb][4 * j + 2 * r], acc_dv[cb][4 * j + 2 * r + 1]);
      }
  }
}

// Eight consecutive elements as fp32 (bf16: one 16-byte load).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = p[i];
}

// K5b's D_i = rowsum(out * dO) in fp32 (B*H, SQ), as _flash_bwd_rule computes
// di from the rounded output: D / 8 lanes a row, 8 elements each.
template <typename T, int D>
__global__ void __launch_bounds__(256)
attention_bwd_di(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ di, int SQ, int H, long long rows, AttnStrides st) {
  constexpr int L = D / 8;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / L;
  const int c = (threadIdx.x % L) * 8;
  float acc = 0.f;
  if (row < rows) {
    const int s = static_cast<int>(row % SQ);
    const int bh = static_cast<int>(row / SQ);
    const int b = bh / H, h = bh % H;
    float x[8], y[8];
    load8(out + head_off(st.o, b, h) + s * st.o.s + c, x);
    load8(dout + head_off(st.dout, b, h) + s * st.dout.s + c, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && threadIdx.x % L == 0) di[row] = acc;
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
attention_bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ key_bias,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse, float* __restrict__ dq,
                             float* __restrict__ delta, int delta_given, int SQ,
                             int SK, int H, AttnStrides st, uint32_t seed, uint32_t thr,
                             float inv_keep, int dropout, float sm_scale) {
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
  const long long row_bh = (static_cast<long long>(b) * H + h) * SQ;
  const float* bias = key_bias + static_cast<long long>(b) * SK;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  // This block's head: every operand from here on is its (S, D) slice.
  q += head_off(st.q, b, h);
  k += head_off(st.k, b, h);
  v += head_off(st.v, b, h);
  dout += head_off(st.dout, b, h);
  dq += head_off(st.dq, b, h);

  load_tile_f32<D>(Qs, q, st.q.s, q0, SQ, tid);
  load_tile_f32<D>(dOs, dout, st.dout.s, q0, SQ, tid);
  if (tid < kBQ) {
    const bool ok = q0 + tid < SQ;
    lse_s[tid] = ok ? lse[row_bh + q0 + tid] : 0.f;
    if (delta_given) dl_s[tid] = ok ? delta[row_bh + q0 + tid] : 0.f;  // K5b
  }

  float dl[4] = {0.f, 0.f, 0.f, 0.f};  // pass 0: partial D_i of the thread's rows
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  for (int pass = delta_given ? 1 : 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < SK; k0 += kBK) {
      __syncthreads();  // the previous tile's reads are done
      load_tile_f32<D>(Ks, k, st.k.s, k0, SK, tid);
      load_tile_f32<D>(Vs, v, st.v.s, k0, SK, tid);
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
        const bool ok = key < SK;
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
          if (q0 + r < SQ) delta[row_bh + q0 + r] = dl[i];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= SQ) continue;
    float* drow = dq + s * st.dq.s;
#pragma unroll
    for (int c = 0; c < CT; ++c) drow[tx + 16 * c] = acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dkv_fp32(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ key_bias,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int SQ, int SK, int H,
                              AttnStrides st, uint32_t seed, uint32_t thr,
                              float inv_keep, int dropout, float sm_scale) {
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
  const long long row_bh = (static_cast<long long>(b) * H + h) * SQ;
  const float* bias = key_bias + static_cast<long long>(b) * SK;
  const uint32_t hseed = seed ^ (static_cast<uint32_t>(b * H + h) * 0xC2B2AE3Du);
  // This block's head: every operand from here on is its (S, D) slice.
  q += head_off(st.q, b, h);
  k += head_off(st.k, b, h);
  v += head_off(st.v, b, h);
  dout += head_off(st.dout, b, h);
  dk += head_off(st.dk, b, h);
  dv += head_off(st.dv, b, h);

  load_tile_f32<D>(Ks, k, st.k.s, k0, SK, tid);
  load_tile_f32<D>(Vs, v, st.v.s, k0, SK, tid);
  float kb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    kb[i] = key < SK ? bias[key] : 0.f;
  }
  float acc_dk[4][CT], acc_dv[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int q0 = 0; q0 < SQ; q0 += kBQ) {
    __syncthreads();  // the previous tile's reads are done
    load_tile_f32<D>(Qs, q, st.q.s, q0, SQ, tid);
    load_tile_f32<D>(dOs, dout, st.dout.s, q0, SQ, tid);
    if (tid < kBQ) {
      const int s = q0 + tid;
      lse_s[tid] = s < SQ ? lse[row_bh + s] : 0.f;
      dl_s[tid] = s < SQ ? delta[row_bh + s] : 0.f;
    }
    __syncthreads();
    float sc_t[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc_t[i][c] = dpt[i][c] = 0.f;
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
          sc_t[i][c] = fmaf(kv[i], qv[c], sc_t[i][c]);
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
        const bool ok = query < SQ && key < SK;
        const float a = ok ? expf(sc_t[i][c] * sm_scale + kb[i] - lse_s[qi]) : 0.f;
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
    if (key >= SK) continue;
    float* dkr = dk + key * st.dk.s;
    float* dvr = dv + key * st.dv.s;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      dkr[tx + 16 * c] = acc_dk[i][c];
      dvr[tx + 16 * c] = acc_dv[i][c];
    }
  }
}

// fp32: launches the dq pass (which writes D_i unless it is given) and then
// the dk/dv pass: one block per 64 queries, then one per 64 keys.
template <typename T, int kThreadsT, int kSmem>
cudaError_t launch_bwd(void (*dq_kernel)(const T*, const T*, const T*, const float*,
                                         const T*, const float*, T*, float*, int, int,
                                         int, int, AttnStrides, uint32_t, uint32_t,
                                         float, int, float),
                       void (*dkv_kernel)(const T*, const T*, const T*, const float*,
                                          const T*, const float*, const float*, T*, T*,
                                          int, int, int, AttnStrides, uint32_t,
                                          uint32_t, float, int, float),
                       const void* q, const void* k, const void* v,
                       const void* key_bias, const void* dout,
                       const void* lse, void* dq, void* dk, void* dv, void* delta,
                       int delta_given, int B, int SQ, int SK, int H,
                       const AttnStrides& st, uint32_t seed, uint32_t thr,
                       float inv_keep, int dropout, float sm_scale,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* kbt = static_cast<const float*>(key_bias);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  dq_kernel<<<dim3((SQ + kBQ - 1) / kBQ, H, B), kThreadsT, kSmem, stream>>>(
      qt, kt, vt, kbt, dot, lt, static_cast<T*>(dq), dl, delta_given, SQ, SK, H, st,
      seed, thr, inv_keep, dropout, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3((SK + kBK - 1) / kBK, H, B), kThreadsT, kSmem, stream>>>(
      qt, kt, vt, kbt, dot, lt, dl, static_cast<T*>(dk), static_cast<T*>(dv), SQ, SK,
      H, st, seed, thr, inv_keep, dropout, sm_scale);
  return cudaGetLastError();
}

// bf16: the dq kernel (which writes D_i unless it is given), then the dk/dv
// kernel; one block per 64 queries, then one per 64 keys.
template <int D, bool kDropout>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* key_bias, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* delta, int delta_given,
                             int B, int SQ, int SK, int H, const AttnStrides& st,
                             uint32_t seed, uint32_t thr, float inv_keep, float sm_scale,
                             cudaStream_t stream) {
  constexpr int smem = bwd_wgmma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_wgmma<D, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_wgmma<D, kDropout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using bf16 = __nv_bfloat16;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const float* kbt = static_cast<const float*>(key_bias);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  attention_bwd_dq_wgmma<D, kDropout>
      <<<dim3((SQ + 63) / 64, H, B), kWgThreads, smem, stream>>>(
          qt, kt, vt, kbt, dot, lt, static_cast<bf16*>(dq), dl, delta_given, SQ, SK, H, st,
          seed, thr, inv_keep, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_wgmma<D, kDropout>
      <<<dim3((SK + 63) / 64, H, B), kWgThreads, smem, stream>>>(
          qt, kt, vt, kbt, dot, lt, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), SQ,
          SK, H, st, seed, thr, inv_keep, sm_scale);
  return cudaGetLastError();
}

// K5b's pre-pass: di = rowsum(out * dO) into `di` (B*H, SQ).
template <typename T, int D>
cudaError_t launch_di(const void* out, const void* dout, void* di, int B, int SQ, int H,
                      const AttnStrides& st, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * SQ;
  constexpr int rows_per_block = 256 / (D / 8);
  attention_bwd_di<T, D><<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
                           256, 0, stream>>>(static_cast<const T*>(out),
                                             static_cast<const T*>(dout),
                                             static_cast<float*>(di), SQ, H, rows, st);
  return cudaGetLastError();
}

// strides: 24 element strides, (batch, head, sequence) of q, k, v, out,
// dout, dq, dk, dv in that order (the forward reads the first four).
AttnStrides read_strides(const long long* s) {
  AttnStrides st;
  Strides* t[8] = {&st.q, &st.k, &st.v, &st.o, &st.dout, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 8; ++i) *t[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  return st;
}

// out == nullptr (K1b/K4b): the dq kernel sums D_i into `delta`; otherwise
// (K5b) the pre-pass writes rowsum(out * dO) there first.
int attention_bwd(const void* q, const void* k, const void* v, const void* key_bias,
                  const void* dout, const void* lse, const void* out, void* dq, void* dk,
                  void* dv, void* delta, int B, int SQ, int SK, int H, int D,
                  const long long* strides, int dtype, unsigned int seed,
                  unsigned int thr, float inv_keep, int dropout, float sm_scale,
                  void* stream) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const AttnStrides st = read_strides(strides);
  const int delta_given = out != nullptr;
  if (delta_given) {
    const cudaError_t err =
        dtype == 0 ? (D == 64 ? launch_di<float, 64> : launch_di<float, 128>)(
                         out, dout, delta, B, SQ, H, st, stream_)
                   : (D == 64 ? launch_di<__nv_bfloat16, 64> : launch_di<__nv_bfloat16, 128>)(
                         out, dout, delta, B, SQ, H, st, stream_);
    if (err != cudaSuccess) return err;
  }
#define VT_ATTN_BWD(DD)                                                              \
  launch_bwd<float, kBwdThreads, bwd_fp32_smem_floats<DD>() * 4>(                    \
      attention_bwd_dq_fp32<DD>, attention_bwd_dkv_fp32<DD>, q, k, v, key_bias, dout, \
      lse, dq, dk, dv, delta, delta_given, B, SQ, SK, H, st, seed, thr, inv_keep,     \
      dropout, sm_scale, stream_)
#define VT_ATTN_BWD_WGMMA(DD, DROP)                                                 \
  launch_bwd_wgmma<DD, DROP>(q, k, v, key_bias, dout, lse, dq, dk, dv, delta,        \
                             delta_given, B, SQ, SK, H, st, seed, thr, inv_keep,     \
                             sm_scale, stream_)
  if (dtype == 0) return D == 64 ? VT_ATTN_BWD(64) : VT_ATTN_BWD(128);
  if (D == 64) return dropout ? VT_ATTN_BWD_WGMMA(64, true) : VT_ATTN_BWD_WGMMA(64, false);
  return dropout ? VT_ATTN_BWD_WGMMA(128, true) : VT_ATTN_BWD_WGMMA(128, false);
#undef VT_ATTN_BWD
#undef VT_ATTN_BWD_WGMMA
}

int attention_fwd(const void* q, const void* k, const void* v, const void* key_bias,
                  void* out, void* lse, int B, int SQ, int SK, int H, int D,
                  const long long* strides, int dtype, unsigned int seed,
                  unsigned int thr, float inv_keep, int dropout, float sm_scale,
                  void* stream) {
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const AttnStrides st = read_strides(strides);
#define VT_ATTN_LAUNCH(FN, DD)                                                     \
  FN<DD>(q, k, v, key_bias, out, lse, B, SQ, SK, H, st, seed, thr, inv_keep,       \
         dropout, sm_scale, stream_)
  if (dtype == 0 && D == 64) return VT_ATTN_LAUNCH(launch_fp32, 64);
  if (dtype == 0 && D == 128) return VT_ATTN_LAUNCH(launch_fp32, 128);
#undef VT_ATTN_LAUNCH
  // The bf16 body walks at least one key tile.
  if (dtype != 1 || (D != 64 && D != 128) || SK < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define VT_ATTN_FWD_WGMMA(DD, DROP)                                                   \
  launch_fwd_wgmma<DD, DROP>(q, k, v, key_bias, out, lse, B, SQ, SK, H, st, seed, thr, \
                             inv_keep, sm_scale, stream_)
  if (D == 64) return dropout ? VT_ATTN_FWD_WGMMA(64, true) : VT_ATTN_FWD_WGMMA(64, false);
  return dropout ? VT_ATTN_FWD_WGMMA(128, true) : VT_ATTN_FWD_WGMMA(128, false);
#undef VT_ATTN_FWD_WGMMA
}

}  // namespace

// The C entries.  dtype: 0 = float32 (FMA kernels), 1 = bfloat16
// (tensor-core kernels).  Every operand is (B, H, S, D) through its strides
// (see read_strides), with D contiguous.  bf16 q, k, v and dout rows (and
// K5b's out) are read as 16-byte vectors and the forward's out, dq, dk, dv
// written as 4-byte pairs: base pointers 16-byte aligned, input strides
// multiples of 8, output strides even.  lse is (B*H, S) fp32, written by the
// forward when not null and read by the backward.

// K1b / K4b: self-attention (S queries and keys); delta is (B*H, S) fp32
// scratch into which the dq kernel sums D_i.
extern "C" int vt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* key_bias, const void* dout,
                                const void* lse, void* dq,
                                void* dk, void* dv, void* delta, int B, int S,
                                int H, int D, const long long* strides, int dtype,
                                unsigned int seed, unsigned int thr, float inv_keep,
                                int dropout, float sm_scale, void* stream) {
  return attention_bwd(q, k, v, key_bias, dout, lse, nullptr, dq, dk, dv, delta, B, S, S,
                       H, D, strides, dtype, seed, thr, inv_keep, dropout, sm_scale, stream);
}

// K1f / K4f: self-attention (S queries and keys).
extern "C" int vt_attention_fwd(const void* q, const void* k, const void* v,
                                const void* key_bias, void* out, void* lse,
                                int B, int S, int H, int D, const long long* strides,
                                int dtype, unsigned int seed, unsigned int thr,
                                float inv_keep, int dropout, float sm_scale,
                                void* stream) {
  return attention_fwd(q, k, v, key_bias, out, lse, B, S, S, H, D, strides, dtype,
                       seed, thr, inv_keep, dropout, sm_scale, stream);
}

// K5f: SQ queries against SK keys; key_bias is (B, SK) fp32.
extern "C" int vt_flash_fwd(const void* q, const void* k, const void* v,
                            const void* key_bias, void* out, void* lse, int B, int SQ,
                            int SK, int H, int D, const long long* strides, int dtype,
                            unsigned int seed, unsigned int thr, float inv_keep,
                            int dropout, float sm_scale, void* stream) {
  return attention_fwd(q, k, v, key_bias, out, lse, B, SQ, SK, H, D, strides, dtype,
                       seed, thr, inv_keep, dropout, sm_scale, stream);
}

// K5b: SQ queries against SK keys; out is the forward's output, read through
// its strides; di is (B*H, SQ) fp32 scratch into which the pre-pass writes
// rowsum(out * dO), read by both main kernels.
extern "C" int vt_flash_bwd(const void* q, const void* k, const void* v,
                            const void* key_bias, const void* dout, const void* lse,
                            const void* out, void* di, void* dq, void* dk, void* dv, int B,
                            int SQ, int SK, int H, int D, const long long* strides,
                            int dtype, unsigned int seed, unsigned int thr, float inv_keep,
                            int dropout, float sm_scale, void* stream) {
  return attention_bwd(q, k, v, key_bias, dout, lse, out, dq, dk, dv, di, B, SQ, SK, H, D,
                       strides, dtype, seed, thr, inv_keep, dropout, sm_scale, stream);
}
