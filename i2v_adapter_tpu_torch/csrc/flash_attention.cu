// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/attention.py::_flash_kernel_t (launched by
// _flash_forward_t through flash_attention(transposed_io=True)).
//
// Computes o = softmax(q k^T * scale) v per (query batch, head) with an
// online softmax in fp32 over key tiles, in the log2 domain (exp2 of scores
// scaled by scale*log2(e)).  The I2V cross-frame sites pass kv_repeat = F:
// query batch bq reads key/value batch bq / kv_repeat, so every frame of a
// clip attends to its first frame's K/V without a broadcast copy.
// static_max != 0 replaces the running max by that fixed log2-space offset
// (the TPU kernel's static_max): rows whose scores all underflow go NaN.
// For bf16 inputs p is rounded to bf16 before p.v, as the TPU kernel's
// p.astype(v.dtype) does; the row sum uses the unrounded p.
// When lse is given (training), each row also writes its log2-space
// logsumexp, fp32 (Bq*H, Nq): static_max + log2(l) under the static offset,
// m + log2(l) otherwise -- the statistic the backward (flash_attention_bwd.cu)
// recomputes the probabilities from.  Serving passes no lse.
//
// What bounds it here: operations.  At the 512px sites (N = 4096/1024/256,
// D = 40/80/160, 8 heads, 32 frame-evals) a call does 4*B*H*N*N*D flops on
// a few MB of inputs, far above the card's ridge point, so the flops must
// run on the tensor cores.  Two paths:
//
// * bf16 (every UNet site): mma.sync m16n8k16 tiles, see
//   flash_fwd_mma_kernel below.  It needs 16-byte rows (head dim and
//   strides multiples of 8, aligned bases); other bf16 inputs are refused.
//   wgmma/TMA pipelining is later work.
// * fp32: scalar fp32 FMAs (about 67 TFLOP/s peak), the exact reference
//   path of the card tests.
//
// Scalar (fp32) design: one CTA of 128 threads per (q tile, batch*head).  G threads share
// a query row (G = 1/2/4 for D = 40/80/160), each holding DT <= 40 of its
// dims of q and of the accumulator in registers, so no site spills; the G
// partial dot products meet through warp shuffles.  K and V tiles of 64 keys
// are staged in shared memory as fp32 (80 KB at D = 160, above the 48 KB
// static limit, hence the dynamic-size attribute) and read as float4
// broadcasts.  Both paths read inputs through their strides, so the
// projections' (B, N, H, D) views need no permute copy; only the head dim
// must be contiguous.  Ragged Nq and Nk are masked in the kernel, never padded in
// device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int KC = 8;    // keys per online-softmax chunk
constexpr float NEG_BIG = -1e30f;

template <int DT>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int nq, int nk, int heads, int d, int G,
    int kv_repeat,
    long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh,
    long long svb, long long svn, long long svh,
    long long sob, long long son, long long soh,
    float scale_log2, float static_max) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DP = G * DT;            // head dim padded per tile row
  float* ks = smem;                 // [BK][DP]
  float* vs = smem + BK * DP;       // [BK][DP]

  const int tid = threadIdx.x;
  const int rows = THREADS / G;
  const int row = blockIdx.x * rows + tid / G;
  const int d0 = (tid % G) * DT;
  const int bh = blockIdx.y;
  const int bq = bh / heads;
  const int h = bh - bq * heads;
  const int bkv = bq / kv_repeat;
  const bool row_ok = row < nq;

  float qr[DT], acc[DT];
  const float* qp = q + bq * sqb + (long long)(row_ok ? row : 0) * sqn + h * sqh;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int dd = d0 + c;
    qr[c] = (row_ok && dd < d) ? qp[dd] : 0.f;
    acc[c] = 0.f;
  }
  float m = NEG_BIG, l = 0.f;
  const float* kp = k + bkv * skb + h * skh;
  const float* vp = v + bkv * svb + h * svh;
  const bool use_static = static_max != 0.f;

  for (int kt = 0; kt < nk; kt += BK) {
    __syncthreads();
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int j = i / DP;
      const int dd = i - j * DP;
      const int key = kt + j;
      const bool ok = key < nk && dd < d;
      ks[i] = ok ? kp[(long long)key * skn + dd] : 0.f;
      vs[i] = ok ? vp[(long long)key * svn + dd] : 0.f;
    }
    __syncthreads();
    const int nvalid = min(BK, nk - kt);
    for (int j0 = 0; j0 < nvalid; j0 += KC) {
      float s[KC];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + jj) * DP + d0);
        float a = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < DT / 4; ++c4) {
          const float4 kk = kr[c4];
          a = fmaf(qr[4 * c4 + 0], kk.x, a);
          a = fmaf(qr[4 * c4 + 1], kk.y, a);
          a = fmaf(qr[4 * c4 + 2], kk.z, a);
          a = fmaf(qr[4 * c4 + 3], kk.w, a);
        }
        s[jj] = a;
      }
      for (int off = 1; off < G; off <<= 1) {
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off);
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        s[jj] = (kt + j0 + jj < nk) ? s[jj] * scale_log2 : NEG_BIG;
      }
      if (use_static) {
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          s[jj] = exp2f(s[jj] - static_max);
          l += s[jj];
        }
      } else {
        float mc = s[0];
#pragma unroll
        for (int jj = 1; jj < KC; ++jj) mc = fmaxf(mc, s[jj]);
        const float m_new = fmaxf(m, mc);
        const float alpha = exp2f(m - m_new);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[c] *= alpha;
        m = m_new;
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          s[jj] = exp2f(s[jj] - m);
          l += s[jj];
        }
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float p = s[jj];
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * DP + d0);
#pragma unroll
        for (int c4 = 0; c4 < DT / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }

  if (row_ok) {
    float* op = o + bq * sob + (long long)row * son + h * soh;
    const float inv = 1.f / l;  // l == 0 (all scores underflowed) gives NaN rows
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      if (d0 + c < d) op[d0 + c] = acc[c] * inv;
    }
    if (lse != nullptr && tid % G == 0) {
      lse[(long long)bh * nq + row] = (use_static ? static_max : m) + log2f(l);
    }
  }
}

template <int DT>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bq, int nq,
           int nk, int heads, int d, int G, int kv_repeat, const long long* st,
           float scale_log2, float static_max, cudaStream_t stream) {
  const int rows = THREADS / G;
  const size_t smem = 2u * BK * G * DT * sizeof(float);
  auto kern = flash_fwd_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + rows - 1) / rows, bq * heads);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, nq, nk, heads, d, G, kv_repeat,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale_log2, static_max);
  return (int)cudaGetLastError();
}

int dispatch(int dt, const void* q, const void* k, const void* v, void* o, float* lse, int bq,
             int nq, int nk, int heads, int d, int G, int kv_repeat,
             const long long* st, float scale_log2, float static_max,
             cudaStream_t stream) {
  switch (dt) {
    case 8: return launch<8>(q, k, v, o, lse, bq, nq, nk, heads, d, G, kv_repeat, st, scale_log2, static_max, stream);
    case 16: return launch<16>(q, k, v, o, lse, bq, nq, nk, heads, d, G, kv_repeat, st, scale_log2, static_max, stream);
    case 24: return launch<24>(q, k, v, o, lse, bq, nq, nk, heads, d, G, kv_repeat, st, scale_log2, static_max, stream);
    case 32: return launch<32>(q, k, v, o, lse, bq, nq, nk, heads, d, G, kv_repeat, st, scale_log2, static_max, stream);
    case 40: return launch<40>(q, k, v, o, lse, bq, nq, nk, heads, d, G, kv_repeat, st, scale_log2, static_max, stream);
    default: return -2;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// Each warp owns 16 query rows; the CTA stages its Q tile once and then
// 64-key K tiles ([key][d]) and transposed V tiles ([d][key]) in shared
// memory, rows padded by 8 elements so the 32-bit fragment loads of a warp
// hit 32 different banks.  S = Q K^T lands in registers in the mma C layout,
// which is also the A layout of P for P V (the FlashAttention-2 register
// reuse), so P never touches shared memory.  Row max and row sum are
// reduced over the 4 lanes that share a row.  Used when the head dim is a
// multiple of 8 (padded to 16 with zeros) up to 160 and every row starts on
// a 16-byte boundary, which holds at every UNet site.
// ---------------------------------------------------------------------------

constexpr int MMA_BKV = 64;

template <int DP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int nq, int nk, int heads, int d, int kv_repeat,
    long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh,
    long long svb, long long svn, long long svh,
    long long sob, long long son, long long soh,
    float scale_log2, float static_max) {
  constexpr int BQ = WARPS * 16;
  constexpr int RS = DP + 8;        // Q / K smem row stride (elements)
  constexpr int VS = MMA_BKV + 8;   // V^T smem row stride
  constexpr int C8 = DP / 8;        // 16-byte chunks per row
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [BQ][RS]
  __nv_bfloat16* ks = qs + BQ * RS;                                // [BKV][RS]
  __nv_bfloat16* vt = ks + MMA_BKV * RS;                           // [DP][VS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int bq = bh / heads;
  const int h = bh - bq * heads;
  const int bkv = bq / kv_repeat;
  const int q0 = blockIdx.x * BQ;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  const __nv_bfloat16* qb = q + bq * sqb + h * sqh;
  for (int i = tid; i < BQ * C8; i += WARPS * 32) {
    const int r = i / C8, c = (i - r * C8) * 8;
    uint4 val = zero;
    if (q0 + r < nq && c < d) val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * sqn + c);
    *reinterpret_cast<uint4*>(qs + r * RS + c) = val;
  }
  __syncthreads();
  uint32_t qf[DP / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    qf[kk][0] = ld32(qs + r0 * RS + kk * 16 + 2 * t);
    qf[kk][1] = ld32(qs + (r0 + 8) * RS + kk * 16 + 2 * t);
    qf[kk][2] = ld32(qs + r0 * RS + kk * 16 + 8 + 2 * t);
    qf[kk][3] = ld32(qs + (r0 + 8) * RS + kk * 16 + 8 + 2 * t);
  }

  float oacc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  const bool use_static = static_max != 0.f;
  const __nv_bfloat16* kb = k + bkv * skb + h * skh;
  const __nv_bfloat16* vb = v + bkv * svb + h * svh;

  for (int kt = 0; kt < nk; kt += MMA_BKV) {
    __syncthreads();
    for (int i = tid; i < MMA_BKV * C8; i += WARPS * 32) {
      const int key = i / C8, c = (i - key * C8) * 8;
      uint4 kv = zero, vv = zero;
      if (kt + key < nk && c < d) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(kt + key) * skn + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(kt + key) * svn + c);
      }
      *reinterpret_cast<uint4*>(ks + key * RS + c) = kv;
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c + e) * VS + key] = pv[e];
    }
    __syncthreads();

    float s[MMA_BKV / 8][4];
#pragma unroll
    for (int n = 0; n < MMA_BKV / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * RS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_bf16(s[n], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
      }
    }
    // scale, mask keys past nk; e = 0,1 -> row g, e = 2,3 -> row g + 8
#pragma unroll
    for (int n = 0; n < MMA_BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = (kt + n * 8 + 2 * t + (e & 1) < nk) ? s[n][e] * scale_log2 : NEG_BIG;
      }
    }
    if (use_static) {
#pragma unroll
      for (int n = 0; n < MMA_BKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - static_max);
          l[e >> 1] += s[n][e];
        }
      }
    } else {
      float mt[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int n = 0; n < MMA_BKV / 8; ++n) {
        mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          oacc[n][2 * r] *= alpha;
          oacc[n][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < MMA_BKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }
      }
    }
    // O += P V, P rounded to bf16 (p.astype(v.dtype)) in the A layout
#pragma unroll
    for (int kk = 0; kk < MMA_BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vrow = vt + (n * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(oacc[n], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (row < nq) {
      if (lse != nullptr && t == 0) {
        lse[(long long)bh * nq + row] = (use_static ? static_max : m[r]) + log2f(l[r]);
      }
      const float inv = 1.f / l[r];  // l == 0 (all scores underflowed) gives NaN rows
      __nv_bfloat16* op = o + bq * sob + (long long)row * son + h * soh;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int dd = n * 8 + 2 * t;
        if (dd < d) {
          op[dd] = __float2bfloat16(oacc[n][2 * r] * inv);
          op[dd + 1] = __float2bfloat16(oacc[n][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bq, int nq,
               int nk, int heads, int d, int kv_repeat, const long long* st,
               float scale_log2, float static_max, cudaStream_t stream) {
  // 8 warps (128 query rows) halve the K/V re-reads where registers allow
  constexpr int WARPS = DP <= 96 ? 8 : 4;
  constexpr int BQ = WARPS * 16;
  const size_t smem = sizeof(__nv_bfloat16) *
      ((size_t)(BQ + MMA_BKV) * (DP + 8) + (size_t)DP * (MMA_BKV + 8));
  auto kern = flash_fwd_mma_kernel<DP, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + BQ - 1) / BQ, bq * heads);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, nq, nk, heads, d,
      kv_repeat, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale_log2, static_max);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bq, int nq,
                 int nk, int heads, int d, int kv_repeat, const long long* st,
                 float scale_log2, float static_max, cudaStream_t stream) {
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_mma<16>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 32: return launch_mma<32>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 48: return launch_mma<48>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 64: return launch_mma<64>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 80: return launch_mma<80>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 96: return launch_mma<96>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 128: return launch_mma<128>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 160: return launch_mma<160>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    default: return -2;
  }
}

// the tensor-core path needs 16-byte rows: d % 8 == 0, strides % 8 == 0,
// 16-byte-aligned bases, and a padded head dim it is instantiated for
bool mma_ok(const void* q, const void* k, const void* v, const void* o, int d,
            const long long* st) {
  const int dp = (d + 15) / 16 * 16;
  if (d % 8 != 0 || d > 160 || dp == 112 || dp == 144) return false;
  for (int i = 0; i < 12; ++i) {
    if (st[i] % 8 != 0) return false;
  }
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: null, or fp32 (bq*heads, nq)
// contiguous for the log2 logsumexp.  strides (in elements) of q, k, v, o in
// (batch, token, head) order; the head dim is contiguous.  Returns 0 or the
// CUDA error code of the launch; -1 bad dtype, -2 unsupported head dim,
// -3 grid too large, -4 bf16 rows the tensor-core path cannot read.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse_out, int dtype, int bq,
    int nq, int nk, int heads, int d, int kv_repeat,
    long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh,
    long long svb, long long svn, long long svh,
    long long sob, long long son, long long soh,
    float scale_log2, float static_max, void* stream) {
  int G = 1;
  while ((d + G - 1) / G > 40 && G < 32) G *= 2;
  const int dt = (((d + G - 1) / G) + 7) / 8 * 8;
  if (dt > 40) return -2;
  if ((long long)bq * heads > 65535) return -3;
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0)
    return dispatch(dt, q, k, v, o, lse, bq, nq, nk, heads, d, G, kv_repeat, st, scale_log2, static_max, s);
  if (dtype == 1)
    return mma_ok(q, k, v, o, d, st)
        ? dispatch_mma(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, s)
        : -4;
  return -1;
}
