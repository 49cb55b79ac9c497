// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launched by _flash_backward, chosen by
// _attention_bwd where the key count is >= 1024).
//
// Inputs: q (Bq, Nq, H, D), k/v (Bkv, Nk, H, D) read through their strides
// (Bq = Bkv * kv_repeat, clip-major, frame-minor), the forward's output o
// and g = dL/do in q's layout, and the forward's log2-space logsumexp lse
// (Bq*H, Nq) fp32.  Outputs dq (Bq, Nq, H, D) and dk/dv (Bkv, Nk, H, D),
// contiguous, in the input dtype.
//
// Math, tile by tile, with every sum in fp32:
//   s   = (q . k) * scale * log2(e)      -- as flash_attention.cu computes it
//   p   = exp2(s - lse)                  -- the forward's probabilities
//   ds' = p * (g . v - dsum),  dsum = rowsum(g * o)
//   dq  = (ds' . k) * scale,  dk = (ds'^T . q) * scale,  dv = p^T . g
// For bf16, ds' is rounded to bf16 before ds'.k and ds'^T.q, and p before
// p^T.g, at the points the TPU kernels round.  (The TPU kernels pre-scale q
// by scale*log2(e) in the input dtype; here the scale is applied to the fp32
// scores, as the forward kernel applies it, so p is recomputed from exactly
// the scores the forward normalised.)
//
// Three kernels per call, counted as one launch of K3:
// * a pre-pass writes (lse, dsum) per query row into the caller's scratch;
// * dq:   one CTA per (q tile, Bq*H), looping over key tiles;
// * dk/dv: one CTA per (key tile, Bkv*H), looping over kv_repeat x q tiles:
//   the cross-frame fan-in (every frame of a clip reads its first frame's
//   K/V) is reduced inside the CTA in registers, without atomics, so the
//   result is the same run to run.  The TPU's sequential grid carried these
//   sums in VMEM from one grid step to the next; the loop in the CTA carries
//   them in registers.
//
// What bounds it here: operations.  Five products of 2*Nq*Nk*D per
// (batch, head) on a few MB of inputs, far above the card's ridge point.
// Paths:
// * bf16 at D <= 96 (every training site: D = 40 at 256 px, 40 and 80 at
//   512 px): wgmma fed by TMA rings, see bwd_dq_wgmma_kernel below;
// * bf16 at D = 128 and 160: mma.sync m16n8k16 kernels with synchronous
//   staging (the second operands of ds'.k, ds'^T.q and p^T.g written
//   transposed into shared memory); at D = 160 the dk/dv CTA splits the
//   output columns in two halves (grid z) so its two fp32 accumulators do
//   not spill.  No site reaches them: D = 160 only occurs at 256 keys,
//   below the 1024 from which the model takes this backward.
// * fp32: scalar fp32 FMAs, the exact reference path of the card tests.
// bf16 needs 16-byte rows (head dim and strides multiples of 8, aligned
// bases).  Ragged Nq and Nk are masked in the kernels: padded keys get p = 0
// in dq, padded query rows get lse = +inf (so p = 0) and dsum = 0 in dk/dv,
// and contribute nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90_tiles.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh;
};

struct Shape {
  int nq, nk, heads, d, kv_repeat;
  int nq_pad;  // rows per (batch, head) of the (lse, dsum) pairs: nq rounded up to PAD_ROWS
};

// ---------------------------------------------------------------------------
// fp32 scalar path: G threads share a row, each holding DT of its dims.
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;
constexpr int SBK = 32;  // keys (dq) or query rows (dk/dv) per shared tile

template <int DT>
__device__ __forceinline__ float dot4(const float (&r)[DT], const float* srow) {
  const float4* p = reinterpret_cast<const float4*>(srow);
  float a = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < DT / 4; ++c4) {
    const float4 x = p[c4];
    a = fmaf(r[4 * c4 + 0], x.x, a);
    a = fmaf(r[4 * c4 + 1], x.y, a);
    a = fmaf(r[4 * c4 + 2], x.z, a);
    a = fmaf(r[4 * c4 + 3], x.w, a);
  }
  return a;
}

template <int DT>
__device__ __forceinline__ void axpy4(float (&acc)[DT], float s, const float* srow) {
  const float4* p = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int c4 = 0; c4 < DT / 4; ++c4) {
    const float4 x = p[c4];
    acc[4 * c4 + 0] = fmaf(s, x.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(s, x.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(s, x.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(s, x.w, acc[4 * c4 + 3]);
  }
}

__device__ __forceinline__ float group_sum(float x, int G) {
  for (int off = 1; off < G; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DT>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float2* __restrict__ ld, float* __restrict__ dq, Shape sh,
    int G, Strides st,
    float scale_log2, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DP = G * DT;
  float* ks = smem;             // [SBK][DP]
  float* vs = smem + SBK * DP;  // [SBK][DP]

  const int tid = threadIdx.x;
  const int row = blockIdx.x * (THREADS / G) + tid / G;
  const int d0 = (tid % G) * DT;
  const int bh = blockIdx.y;
  const int b = bh / sh.heads, h = bh - b * sh.heads;
  const int bkv = b / sh.kv_repeat;
  const bool row_ok = row < sh.nq;
  const int rr = row_ok ? row : 0;

  float qr[DT], gr[DT], acc[DT];
  const float* qp = q + b * st.qb + (long long)rr * st.qn + h * st.qh;
  const float* gp = g + b * st.gb + (long long)rr * st.gn + h * st.gh;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const bool ok = row_ok && d0 + c < sh.d;
    qr[c] = ok ? qp[d0 + c] : 0.f;
    gr[c] = ok ? gp[d0 + c] : 0.f;
    acc[c] = 0.f;
  }
  const float2 ld_r = row_ok ? ld[(long long)bh * sh.nq_pad + row] : make_float2(0.f, 0.f);
  const float lse_r = ld_r.x, dsum_r = ld_r.y;
  const float* kp = k + bkv * st.kb + h * st.kh;
  const float* vp = v + bkv * st.vb + h * st.vh;

  for (int kt = 0; kt < sh.nk; kt += SBK) {
    __syncthreads();
    for (int i = tid; i < SBK * DP; i += THREADS) {
      const int j = i / DP, dd = i - j * DP;
      const bool ok = kt + j < sh.nk && dd < sh.d;
      ks[i] = ok ? kp[(long long)(kt + j) * st.kn + dd] : 0.f;
      vs[i] = ok ? vp[(long long)(kt + j) * st.vn + dd] : 0.f;
    }
    __syncthreads();
    const int nvalid = min(SBK, sh.nk - kt);
    for (int j = 0; j < nvalid; ++j) {
      const float s = group_sum(dot4<DT>(qr, ks + j * DP + d0), G);
      const float dp = group_sum(dot4<DT>(gr, vs + j * DP + d0), G);
      const float p = exp2f(s * scale_log2 - lse_r);
      axpy4<DT>(acc, p * (dp - dsum_r), ks + j * DP + d0);
    }
  }
  if (row_ok) {
    float* op = dq + (((long long)b * sh.nq + row) * sh.heads + h) * sh.d;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      if (d0 + c < sh.d) op[d0 + c] = acc[c] * scale;
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float2* __restrict__ ld, float* __restrict__ dk,
    float* __restrict__ dv, Shape sh, int G, Strides st, float scale_log2, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DP = G * DT;
  float* qs = smem;                 // [SBK][DP]
  float* gs = qs + SBK * DP;        // [SBK][DP]
  float* lse_s = gs + SBK * DP;     // [SBK]
  float* dsum_s = lse_s + SBK;      // [SBK]

  const int tid = threadIdx.x;
  const int key = blockIdx.x * (THREADS / G) + tid / G;
  const int d0 = (tid % G) * DT;
  const int bh = blockIdx.y;
  const int bkv = bh / sh.heads, h = bh - bkv * sh.heads;
  const bool key_ok = key < sh.nk;
  const int kk = key_ok ? key : 0;

  float kr[DT], vr[DT], dka[DT], dva[DT];
  const float* kp = k + bkv * st.kb + (long long)kk * st.kn + h * st.kh;
  const float* vp = v + bkv * st.vb + (long long)kk * st.vn + h * st.vh;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const bool ok = key_ok && d0 + c < sh.d;
    kr[c] = ok ? kp[d0 + c] : 0.f;
    vr[c] = ok ? vp[d0 + c] : 0.f;
    dka[c] = dva[c] = 0.f;
  }
  const int nqt = (sh.nq + SBK - 1) / SBK;
  for (int t = 0; t < sh.kv_repeat * nqt; ++t) {
    const int b = bkv * sh.kv_repeat + t / nqt;
    const int q0 = (t % nqt) * SBK;
    const float* qp = q + b * st.qb + h * st.qh;
    const float* gp = g + b * st.gb + h * st.gh;
    __syncthreads();
    for (int i = tid; i < SBK * DP; i += THREADS) {
      const int j = i / DP, dd = i - j * DP;
      const bool ok = q0 + j < sh.nq && dd < sh.d;
      qs[i] = ok ? qp[(long long)(q0 + j) * st.qn + dd] : 0.f;
      gs[i] = ok ? gp[(long long)(q0 + j) * st.gn + dd] : 0.f;
    }
    for (int j = tid; j < SBK; j += THREADS) {  // padded rows carry lse = inf: p = 0
      const float2 v2 = ld[((long long)b * sh.heads + h) * sh.nq_pad + q0 + j];
      lse_s[j] = v2.x;
      dsum_s[j] = v2.y;
    }
    __syncthreads();
    for (int j = 0; j < SBK; ++j) {
      const float s = group_sum(dot4<DT>(kr, qs + j * DP + d0), G);
      const float dp = group_sum(dot4<DT>(vr, gs + j * DP + d0), G);
      const float p = exp2f(s * scale_log2 - lse_s[j]);
      axpy4<DT>(dva, p, gs + j * DP + d0);
      axpy4<DT>(dka, p * (dp - dsum_s[j]), qs + j * DP + d0);
    }
  }
  if (key_ok) {
    const long long off = (((long long)bkv * sh.nk + key) * sh.heads + h) * sh.d;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      if (d0 + c < sh.d) {
        dk[off + d0 + c] = dka[c] * scale;
        dv[off + d0 + c] = dva[c];
      }
    }
  }
}

template <int DT>
int launch_scalar(const void* q, const void* k, const void* v, const void* g,
                  const float2* ld, void* dq, void* dk, void* dv,
                  int bq, int bkv, Shape sh, int G, const Strides& st, float scale_log2,
                  float scale, cudaStream_t stream) {
  const int rows = THREADS / G;
  const int DP = G * DT;
  const size_t smem_dq = 2u * SBK * DP * sizeof(float);
  const size_t smem_kv = (2u * SBK * DP + 2u * SBK) * sizeof(float);
  auto kdq = bwd_dq_kernel<DT>;
  auto kkv = bwd_dkv_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  kdq<<<dim3((sh.nq + rows - 1) / rows, bq * sh.heads), THREADS, smem_dq, stream>>>(
      qf, kf, vf, gf, ld, static_cast<float*>(dq), sh, G, st, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((sh.nk + rows - 1) / rows, bkv * sh.heads), THREADS, smem_kv, stream>>>(
      qf, kf, vf, gf, ld, static_cast<float*>(dk), static_cast<float*>(dv), sh, G, st,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D = 128 and 160: mma.sync m16n8k16 (fragment layouts in mma_bf16.cuh).
// ---------------------------------------------------------------------------

constexpr int TILE = 64;  // keys per dq step, query rows per dk/dv step
constexpr int TS = TILE + 8;  // row stride of transposed tiles

// A fragment of rows [r0, r0+8) + 8 at column block kk from a [row][RS] tile
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int rs, int r0, int kk, int t) {
  a[0] = ld32(tile + r0 * rs + kk * 16 + 2 * t);
  a[1] = ld32(tile + (r0 + 8) * rs + kk * 16 + 2 * t);
  a[2] = ld32(tile + r0 * rs + kk * 16 + 8 + 2 * t);
  a[3] = ld32(tile + (r0 + 8) * rs + kk * 16 + 8 + 2 * t);
}

// Stage rows [r0, r0+n) of a (token, d) bf16 matrix into dst[row][rs],
// zero past nrows or d; with ``dt`` also the columns [c0, c0+dt_cols) of the
// same rows transposed into dt[col][TS].
__device__ __forceinline__ void stage(bf16* dst, int rs, bf16* dt, int c0, int dt_cols,
                                      const bf16* src, long long stride, int r0, int n, int nrows,
                                      int d, int dp, int tid, int nthreads) {
  const int c8 = dp / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < n * c8; i += nthreads) {
    const int r = i / c8, c = (i - r * c8) * 8;
    uint4 val = zero;
    if (r0 + r < nrows && c < d) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * rs + c) = val;
    if (dt != nullptr && c >= c0 && c < c0 + dt_cols) {
      const bf16* pv = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) dt[(c - c0 + e) * TS + r] = pv[e];
    }
  }
}

template <int DP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float2* __restrict__ ld, bf16* __restrict__ dq, Shape sh,
    Strides st, float scale_log2, float scale) {
  constexpr int BQ = WARPS * 16;
  constexpr int RS = DP + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // [BQ][RS]
  bf16* gs = qs + BQ * RS;                      // [BQ][RS]
  bf16* ks = gs + BQ * RS;                      // [TILE][RS]
  bf16* vs = ks + TILE * RS;                    // [TILE][RS]
  bf16* kt = vs + TILE * RS;                    // [DP][TS]  K^T

  const int tid = threadIdx.x, nthreads = WARPS * 32;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / sh.heads, h = bh - b * sh.heads;
  const int bkv = b / sh.kv_repeat;
  const int q0 = blockIdx.x * BQ;
  const int r0 = warp * 16 + gq;

  stage(qs, RS, nullptr, 0, 0, q + b * st.qb + h * st.qh, st.qn, q0, BQ, sh.nq, sh.d, DP, tid, nthreads);
  stage(gs, RS, nullptr, 0, 0, g + b * st.gb + h * st.gh, st.gn, q0, BQ, sh.nq, sh.d, DP, tid, nthreads);
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const float2 v2 = ld[(long long)bh * sh.nq_pad + min(row, sh.nq_pad - 1)];
    lse_r[r] = v2.x;
    dsum_r[r] = v2.y;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* kb = k + bkv * st.kb + h * st.kh;
  const bf16* vb = v + bkv * st.vb + h * st.vh;

  for (int k0 = 0; k0 < sh.nk; k0 += TILE) {
    __syncthreads();
    stage(ks, RS, kt, 0, DP, kb, st.kn, k0, TILE, sh.nk, sh.d, DP, tid, nthreads);
    stage(vs, RS, nullptr, 0, 0, vb, st.vn, k0, TILE, sh.nk, sh.d, DP, tid, nthreads);
    __syncthreads();

    // S = Q K^T and dP = G V^T for this warp's 16 rows x 64 keys
    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ag[4];
      load_a(aq, qs, RS, r0, kk, t);
      load_a(ag, gs, RS, r0, kk, t);
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        const bf16* krow = ks + (n * 8 + gq) * RS + kk * 16 + 2 * t;
        const bf16* vrow = vs + (n * 8 + gq) * RS + kk * 16 + 2 * t;
        mma_bf16(s[n], aq, ld32(krow), ld32(krow + 8));
        mma_bf16(dp[n], ag, ld32(vrow), ld32(vrow + 8));
      }
    }
    // ds' = p (dp - dsum), p = exp2(s - lse); keys past nk give p = 0
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p = key < sh.nk ? exp2f(s[n][e] * scale_log2 - lse_r[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dsum_r[e >> 1]);
      }
    }
    // dq += ds' K, ds' rounded to bf16 in the A layout, K^T rows as B
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const bf16* krow = kt + (n * 8 + gq) * TS + kk * 16 + 2 * t;
        mma_bf16(acc[n], da, ld32(krow), ld32(krow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= sh.nq) continue;
    bf16* op = dq + (((long long)b * sh.nq + row) * sh.heads + h) * sh.d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int dd = n * 8 + 2 * t;
      if (dd < sh.d) {
        *reinterpret_cast<__nv_bfloat162*>(op + dd) =
            __floats2bfloat162_rn(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
      }
    }
  }
}

// DO = output columns per CTA (DP, or DP / 2 at D = 160: grid z picks the half)
template <int DP, int DO, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float2* __restrict__ ld, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Shape sh, Strides st, float scale_log2, float scale) {
  constexpr int BK = WARPS * 16;
  constexpr int RS = DP + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* ks = reinterpret_cast<bf16*>(smem_u4);  // [BK][RS]
  bf16* vs = ks + BK * RS;                      // [BK][RS]
  bf16* qs = vs + BK * RS;                      // [TILE][RS]
  bf16* gs = qs + TILE * RS;                    // [TILE][RS]
  bf16* qt = gs + TILE * RS;                    // [DO][TS]  Q^T, this CTA's columns
  bf16* gt = qt + DO * TS;                      // [DO][TS]  G^T
  float* lse_s = reinterpret_cast<float*>(gt + DO * TS);  // [TILE]
  float* dsum_s = lse_s + TILE;                           // [TILE]

  const int tid = threadIdx.x, nthreads = WARPS * 32;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int bkv = bh / sh.heads, h = bh - bkv * sh.heads;
  const int key0 = blockIdx.x * BK;
  const int c0 = blockIdx.z * DO;
  const int r0 = warp * 16 + gq;

  stage(ks, RS, nullptr, 0, 0, k + bkv * st.kb + h * st.kh, st.kn, key0, BK, sh.nk, sh.d, DP, tid, nthreads);
  stage(vs, RS, nullptr, 0, 0, v + bkv * st.vb + h * st.vh, st.vn, key0, BK, sh.nk, sh.d, DP, tid, nthreads);
  float dka[DO / 8][4], dva[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int nqt = (sh.nq + TILE - 1) / TILE;
  for (int it = 0; it < sh.kv_repeat * nqt; ++it) {
    const int b = bkv * sh.kv_repeat + it / nqt;
    const int q0 = (it % nqt) * TILE;
    __syncthreads();
    stage(qs, RS, qt, c0, DO, q + b * st.qb + h * st.qh, st.qn, q0, TILE, sh.nq, sh.d, DP, tid, nthreads);
    stage(gs, RS, gt, c0, DO, g + b * st.gb + h * st.gh, st.gn, q0, TILE, sh.nq, sh.d, DP, tid, nthreads);
    for (int j = tid; j < TILE; j += nthreads) {  // padded rows carry lse = inf: p = 0
      const float2 v2 = ld[((long long)b * sh.heads + h) * sh.nq_pad + q0 + j];
      lse_s[j] = v2.x;
      dsum_s[j] = v2.y;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V G^T for this warp's 16 keys x 64 query rows
    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, ks, RS, r0, kk, t);
      load_a(av, vs, RS, r0, kk, t);
#pragma unroll
      for (int n = 0; n < TILE / 8; ++n) {
        const bf16* qrow = qs + (n * 8 + gq) * RS + kk * 16 + 2 * t;
        const bf16* grow = gs + (n * 8 + gq) * RS + kk * 16 + 2 * t;
        mma_bf16(s[n], ak, ld32(qrow), ld32(qrow + 8));
        mma_bf16(dp[n], av, ld32(grow), ld32(grow + 8));
      }
    }
    // p^T and ds'^T; the column index is the query row
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        const float p = exp2f(s[n][e] * scale_log2 - lse_s[j]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dsum_s[j]);
      }
    }
    // dv += p^T G, dk += ds'^T Q (A operands rounded to bf16, transposed tiles as B)
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DO / 8; ++n) {
        const bf16* grow = gt + (n * 8 + gq) * TS + kk * 16 + 2 * t;
        const bf16* qrow = qt + (n * 8 + gq) * TS + kk * 16 + 2 * t;
        mma_bf16(dva[n], pa, ld32(grow), ld32(grow + 8));
        mma_bf16(dka[n], da, ld32(qrow), ld32(qrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r0 + 8 * r;
    if (key >= sh.nk) continue;
    const long long off = (((long long)bkv * sh.nk + key) * sh.heads + h) * sh.d;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n) {
      const int dd = c0 + n * 8 + 2 * t;
      if (dd < sh.d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + dd) =
            __floats2bfloat162_rn(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + dd) =
            __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The (lse, dsum) pre-pass, part of every call: per query row the forward's
// logsumexp beside dsum = rowsum(g * o) in fp32, rows padded to PAD_ROWS
// per (batch, head) with lse = +inf and dsum = 0, so that a padded row's
// p = exp2(s - inf) is zero in every kernel without a mask.
// ---------------------------------------------------------------------------

constexpr int PAD_ROWS = 128;  // a multiple of every kernel's query tile

__device__ __forceinline__ float row_dot(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}
// bf16 rows are 16-byte aligned with d % 8 == 0 (checked by the entry point)
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; c += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c), y = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 xf = __bfloat1622float2(xp[j]), yf = __bfloat1622float2(yp[j]);
      acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
    }
  }
  return acc;
}

template <typename T>
__global__ void bwd_prep_kernel(const T* __restrict__ g, const T* __restrict__ o,
                                const float* __restrict__ lse, float2* __restrict__ ld, long long total,
                                Shape sh, long long sgb, long long sgn, long long sgh, long long sob,
                                long long son, long long soh) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long bh = idx / sh.nq_pad;
  const int row = (int)(idx - bh * sh.nq_pad);
  if (row >= sh.nq) {
    ld[idx] = make_float2(INFINITY, 0.f);
    return;
  }
  const long long b = bh / sh.heads, h = bh - b * sh.heads;
  const float dsum = row_dot(g + b * sgb + row * sgn + h * sgh, o + b * sob + row * son + h * soh, sh.d);
  ld[idx] = make_float2(lse[bh * sh.nq + row], dsum);
}

// ---------------------------------------------------------------------------
// bf16 at D <= 96 (every training site): wgmma fed by TMA rings, tile
// layouts, descriptors and register order as in sm90_tiles.cuh and the
// forward (flash_attention.cu).  Every tile is 64 rows (tokens) by DP.
//
// dq: one CTA of WQ warpgroups per (64 * WQ query rows, batch*head); each
// warpgroup's Q and dO stay in shared memory, K/V tiles stream through a
// ring of NS stages shared by the warpgroups.  Per key tile:
//   S = Q K^T, dP = dO V^T   wgmma m64n64k16, B = K / V K-major as stored;
//   dS = P (dP - dsum)       in registers, P = exp2(S * scale - lse);
//   dQ += dS K               wgmma m64nDPk16, A = dS in registers, B = K
//                            through the transpose bit.
// dk/dv: one CTA of WK warpgroups per (64 * WK keys, kv batch*head); each
// warpgroup's K and V stay, and the kv_repeat frames x query tiles stream
// through the ring (Q, dO and their (lse, dsum) pairs), so the cross-frame
// fan-in is summed in registers without atomics and the result is the same
// run to run.  Per step:
//   S^T = K Q^T, dP^T = V dO^T   B = Q / dO K-major as stored;
//   dV += P^T dO, dK += dS^T Q   A in registers, B through the transpose bit.
// Both loops are software-pipelined as the forward's: a step issues its
// score products with the previous step's accumulating products and runs
// its elementwise work while those run.
// ---------------------------------------------------------------------------

template <int DP>
struct BwdTile {
  static constexpr int R = 64;              // rows of every tile
  static constexpr int TILE = R * DP * 2;   // bytes of one tile
  static constexpr int NS = 4;              // ring stages
  static constexpr int LDB = 1024;          // bytes of a stage's (lse, dsum) pairs (512), aligned
  // warpgroups per CTA: dq 64 query rows each, sharing every K/V tile;
  // dk/dv 64 keys each, sharing every Q/dO tile (half the L2 traffic of one)
  static constexpr int WQ = 2;
  static constexpr int WK = 2;
  static constexpr size_t SMEM_DQ = 2u * WQ * TILE + 2u * NS * TILE + 8 * (NS + 1) + 1024;
  static constexpr size_t SMEM_DKV = 2u * WK * TILE + (size_t)NS * (2 * TILE + LDB) + 8 * (NS + 1) + 1024;
};

struct BwdMaps {
  CUtensorMap q, g, k, v;
  TileCoord cq, cg, ck, cv;
};

template <int DP>
__global__ void __launch_bounds__(BwdTile<DP>::WQ * 128, BwdTile<DP>::WQ == 1 ? 2 : 1) bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, TileCoord cq,
    TileCoord cg, TileCoord ck, TileCoord cv, const float2* __restrict__ ld, bf16* __restrict__ dq,
    Shape sh, float scale_log2, float scale) {
  using T = BwdTile<DP>;
  constexpr int R = T::R, TILE = T::TILE, NS = T::NS, WQ = T::WQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [WQ] Q tiles
  uint8_t* gs = qs + WQ * TILE;     // [WQ] dO tiles
  uint8_t* ks = gs + WQ * TILE;     // [NS] K tiles
  uint8_t* vs = ks + NS * TILE;     // [NS] V tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NS * TILE);  // [NS] K/V stages, [NS] Q + dO

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.y / sh.kv_repeat;
  const int bkv = kvh / sh.heads, h = kvh - bkv * sh.heads;
  const int b = bkv * sh.kv_repeat + (blockIdx.y - kvh * sh.kv_repeat);
  const int bh = b * sh.heads + h;
  const int q0 = blockIdx.x * WQ * R;
  const int r0 = q0 + wg * R;  // this warpgroup's first row
  const int ntiles = (sh.nk + R - 1) / R;

  if (tid == 0) {
    for (int i = 0; i <= NS; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_kv = [&](int tile) {
    const int slot = tile % NS;
    mbar_expect_tx(&bar[slot], 2 * TILE);
    tma_tile<DP, R>(ks + slot * TILE, &tk, &bar[slot], ck, tile * R, h, bkv);
    tma_tile<DP, R>(vs + slot * TILE, &tv, &bar[slot], cv, tile * R, h, bkv);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar[NS], 2 * WQ * TILE);
    for (int w = 0; w < WQ; ++w) {
      tma_tile<DP, R>(qs + w * TILE, &tq, &bar[NS], cq, q0 + w * R, h, b);
      tma_tile<DP, R>(gs + w * TILE, &tg, &bar[NS], cg, q0 + w * R, h, b);
    }
    for (int tile = 0; tile < NS - 1 && tile < ntiles; ++tile) load_kv(tile);
  }
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past nq read the padding (lse = inf)
    const float2 v2 = ld[(long long)bh * sh.nq_pad + r0 + warp * 16 + g + 8 * r];
    lse_r[r] = v2.x;
    dsum_r[r] = v2.y;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint64_t qdesc = smem_desc(qs + wg * TILE, 16, 8 * SLICE_ROW);
  const uint64_t gdesc = smem_desc(gs + wg * TILE, 16, 8 * SLICE_ROW);
  const uint64_t kdesc = smem_desc(ks, 16, 8 * SLICE_ROW);
  const uint64_t vdesc = smem_desc(vs, 16, 8 * SLICE_ROW);
  const uint64_t ktdesc = smem_desc(ks, R * SLICE_ROW, 8 * SLICE_ROW);  // K MN-major for dS K

  float s[R / 2], dp[R / 2];
  uint32_t da[R / 16][4];
  auto issue_scores = [&](int slot) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<R>(s, desc_add(qdesc, kk * R * SLICE_ROW), desc_add(kdesc, slot * TILE + kk * R * SLICE_ROW), kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<R>(dp, desc_add(gdesc, kk * R * SLICE_ROW), desc_add(vdesc, slot * TILE + kk * R * SLICE_ROW), kk);
    }
  };
  auto issue_dq = [&](int slot) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wgmma_rs_tb<DP>(acc, da[kk], desc_add(ktdesc, slot * TILE + kk * 16 * SLICE_ROW), 1);
    }
  };
  // ds' = p (dp - dsum), p = exp2(s * scale - lse); keys past nk give p = 0
  auto ds_tile = [&](int kbase) {
    const bool ragged = kbase + R > sh.nk;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      float p = exp2_ftz(fmaf(s[i], scale_log2, -lse_r[(i >> 1) & 1]));
      if (ragged && kbase + 8 * (i >> 2) + 2 * t + (i & 1) >= sh.nk) p = 0.f;
      s[i] = p * (dp[i] - dsum_r[(i >> 1) & 1]);
    }
  };

  mbar_wait(&bar[NS], 0);
  mbar_wait(&bar[0], 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_commit();
  wgmma_wait_all();
  keep(s);
  keep(dp);
  ds_tile(0);
  to_a_frags<R / 16>(da, s);  // ds' rounded to bf16 before ds'.k
  for (int it = 1; it < ntiles; ++it) {
    __syncthreads();  // tile it - 2 is done with: its stage is reloaded
    if (tid == 0 && it + NS - 2 < ntiles) load_kv(it + NS - 2);
    const int slot = it % NS;
    mbar_wait(&bar[slot], (it / NS) & 1);
    wgmma_fence();
    issue_scores(slot);
    wgmma_commit();
    issue_dq((it - 1) % NS);
    wgmma_commit();
    wgmma_wait_one();
    keep(s);
    keep(dp);
    ds_tile(it * R);
    wgmma_wait_all();
    keep(acc);
    keep(da);
    to_a_frags<R / 16>(da, s);
  }
  issue_dq((ntiles - 1) % NS);
  wgmma_commit();
  wgmma_wait_all();
  keep(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= sh.nq) continue;
    bf16* op = dq + (((long long)b * sh.nq + row) * sh.heads + h) * sh.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int dd = 8 * j + 2 * t;
      if (dd < sh.d) {
        *reinterpret_cast<uint32_t*>(op + dd) = pack_bf16x2(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(BwdTile<DP>::WK * 128, BwdTile<DP>::WK == 1 ? 2 : 1) bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, TileCoord cq,
    TileCoord cg, TileCoord ck, TileCoord cv, const float2* __restrict__ ld, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Shape sh, float scale_log2, float scale) {
  using T = BwdTile<DP>;
  constexpr int R = T::R, TILE = T::TILE, NS = T::NS, WK = T::WK, STAGE = 2 * TILE + T::LDB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [WK] K tiles
  uint8_t* vs = ks + WK * TILE;  // [WK] V tiles
  uint8_t* st = vs + WK * TILE;  // [NS] stages: Q tile, dO tile, (lse, dsum) pairs
  uint64_t* bar = reinterpret_cast<uint64_t*>(st + NS * STAGE);  // [NS] stages, [NS] K + V

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.y / sh.heads, h = blockIdx.y - bkv * sh.heads;
  const int key0 = (blockIdx.x * WK + wg) * R;  // this warpgroup's first key
  const int nqt = (sh.nq + R - 1) / R, steps = sh.kv_repeat * nqt;

  if (tid == 0) {
    for (int i = 0; i <= NS; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_step = [&](int step) {
    const int slot = step % NS;
    const int b = bkv * sh.kv_repeat + step / nqt, q0 = (step % nqt) * R;
    uint8_t* dst = st + slot * STAGE;
    mbar_expect_tx(&bar[slot], 2 * TILE + R * 8);
    tma_tile<DP, R>(dst, &tq, &bar[slot], cq, q0, h, b);
    tma_tile<DP, R>(dst + TILE, &tg, &bar[slot], cg, q0, h, b);
    bulk_load(dst + 2 * TILE, ld + ((long long)b * sh.heads + h) * sh.nq_pad + q0, R * 8, &bar[slot]);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar[NS], 2 * WK * TILE);
    for (int w = 0; w < WK; ++w) {
      tma_tile<DP, R>(ks + w * TILE, &tk, &bar[NS], ck, key0 + w * R, h, bkv);
      tma_tile<DP, R>(vs + w * TILE, &tv, &bar[NS], cv, key0 + w * R, h, bkv);
    }
    for (int step = 0; step < NS - 1 && step < steps; ++step) load_step(step);
  }
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint64_t kdesc = smem_desc(ks + wg * TILE, 16, 8 * SLICE_ROW);
  const uint64_t vdesc = smem_desc(vs + wg * TILE, 16, 8 * SLICE_ROW);
  const uint64_t qdesc = smem_desc(st, 16, 8 * SLICE_ROW);                     // + slot * STAGE
  const uint64_t gdesc = smem_desc(st + TILE, 16, 8 * SLICE_ROW);
  const uint64_t qtdesc = smem_desc(st, R * SLICE_ROW, 8 * SLICE_ROW);         // MN-major
  const uint64_t gtdesc = smem_desc(st + TILE, R * SLICE_ROW, 8 * SLICE_ROW);

  float s[R / 2], dp[R / 2];
  uint32_t pa[R / 16][4], da[R / 16][4];
  auto issue_scores = [&](int slot) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<R>(s, desc_add(kdesc, kk * R * SLICE_ROW), desc_add(qdesc, slot * STAGE + kk * R * SLICE_ROW), kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<R>(dp, desc_add(vdesc, kk * R * SLICE_ROW), desc_add(gdesc, slot * STAGE + kk * R * SLICE_ROW), kk);
    }
  };
  auto issue_dkv = [&](int slot) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      wgmma_rs_tb<DP>(dva, pa[kk], desc_add(gtdesc, slot * STAGE + kk * 16 * SLICE_ROW), 1);
      wgmma_rs_tb<DP>(dka, da[kk], desc_add(qtdesc, slot * STAGE + kk * 16 * SLICE_ROW), 1);
    }
  };
  // p^T and ds'^T; column j of the scores is query row j of the step, whose
  // (lse, dsum) pair sits at 8 * j bytes of the stage's pairs
  auto p_ds = [&](int slot) {
    const float4* pairs = reinterpret_cast<const float4*>(st + slot * STAGE + 2 * TILE);
#pragma unroll
    for (int jj = 0; jj < R / 8; ++jj) {
      const float4 v4 = pairs[4 * jj + t];  // rows 8jj + 2t, +1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const float lse = (e & 1) ? v4.z : v4.x, dsum = (e & 1) ? v4.w : v4.y;
        const float p = exp2_ftz(fmaf(s[i], scale_log2, -lse));
        s[i] = p;
        dp[i] = p * (dp[i] - dsum);
      }
    }
  };

  mbar_wait(&bar[NS], 0);
  mbar_wait(&bar[0], 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_commit();
  wgmma_wait_all();
  keep(s);
  keep(dp);
  p_ds(0);
  to_a_frags<R / 16>(pa, s);   // p rounded before p^T.g
  to_a_frags<R / 16>(da, dp);  // ds' rounded before ds'^T.q
  for (int it = 1; it < steps; ++it) {
    __syncthreads();  // step it - 2 is done with: its stage is reloaded
    if (tid == 0 && it + NS - 2 < steps) load_step(it + NS - 2);
    const int slot = it % NS;
    mbar_wait(&bar[slot], (it / NS) & 1);
    wgmma_fence();
    issue_scores(slot);
    wgmma_commit();
    issue_dkv((it - 1) % NS);
    wgmma_commit();
    wgmma_wait_one();
    keep(s);
    keep(dp);
    p_ds(slot);
    wgmma_wait_all();
    keep(dka);
    keep(dva);
    keep(pa);
    keep(da);
    to_a_frags<R / 16>(pa, s);
    to_a_frags<R / 16>(da, dp);
  }
  issue_dkv((steps - 1) % NS);
  wgmma_commit();
  wgmma_wait_all();
  keep(dka);
  keep(dva);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 16 + g + 8 * r;
    if (key >= sh.nk) continue;
    const long long off = (((long long)bkv * sh.nk + key) * sh.heads + h) * sh.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int dd = 8 * j + 2 * t;
      if (dd < sh.d) {
        *reinterpret_cast<uint32_t*>(dk + off + dd) = pack_bf16x2(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + dd) = pack_bf16x2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DP>
int launch_wgmma(const BwdMaps& m, const float2* ld, void* dq, void* dk, void* dv, int bq, int bkv,
                 Shape sh, float scale_log2, float scale, cudaStream_t stream) {
  using T = BwdTile<DP>;
  auto kdq = bwd_dq_wgmma_kernel<DP>;
  auto kkv = bwd_dkv_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM_DKV);
  if (err != cudaSuccess) return (int)err;
  kdq<<<dim3((sh.nq + T::WQ * T::R - 1) / (T::WQ * T::R), bq * sh.heads), T::WQ * 128, T::SMEM_DQ, stream>>>(
      m.q, m.g, m.k, m.v, m.cq, m.cg, m.ck, m.cv, ld, static_cast<bf16*>(dq), sh, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((sh.nk + T::WK * T::R - 1) / (T::WK * T::R), bkv * sh.heads), T::WK * 128, T::SMEM_DKV, stream>>>(
      m.q, m.g, m.k, m.v, m.cq, m.cg, m.ck, m.cv, ld, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

// bf16 at D = 128 and 160: the mma.sync kernels above
template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* g, const float2* ld,
               void* dq, void* dk, void* dv, int bq, int bkv, Shape sh,
               const Strides& st, float scale_log2, float scale, cudaStream_t stream) {
  constexpr int WQ = 4;                  // dq: 64 query rows per CTA
  constexpr int WK = 4;                  // dk/dv: 64 keys per CTA
  constexpr int DO = DP / 2;             // dk/dv output columns per CTA (grid z picks the half)
  constexpr int RS = DP + 8;
  const size_t smem_dq = sizeof(bf16) * ((size_t)(2 * WQ * 16 + 2 * TILE) * RS + (size_t)DP * TS);
  const size_t smem_kv = sizeof(bf16) * ((size_t)(2 * WK * 16 + 2 * TILE) * RS + 2u * DO * TS)
                         + 2u * TILE * sizeof(float);
  auto kdq = bwd_dq_mma_kernel<DP, WQ>;
  auto kkv = bwd_dkv_mma_kernel<DP, DO, WK>;
  cudaError_t err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(g);
  kdq<<<dim3((sh.nq + WQ * 16 - 1) / (WQ * 16), bq * sh.heads), WQ * 32, smem_dq, stream>>>(
      qb, kb, vb, gb, ld, static_cast<bf16*>(dq), sh, st, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((sh.nk + WK * 16 - 1) / (WK * 16), bkv * sh.heads, DP / DO), WK * 32, smem_kv, stream>>>(
      qb, kb, vb, gb, ld, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh, st, scale_log2, scale);
  return (int)cudaGetLastError();
}

int dispatch_bf16(int dp, const void* q, const void* k, const void* v, const void* g, const float2* ld,
                  void* dq, void* dk, void* dv, int bq, int bkv, Shape sh, const Strides& st,
                  float scale_log2, float scale, cudaStream_t s) {
  if (dp > 96) {
    switch (dp) {
      case 128: return launch_mma<128>(q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, st, scale_log2, scale, s);
      case 160: return launch_mma<160>(q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, st, scale_log2, scale, s);
      default: return -2;
    }
  }
  BwdMaps m;
  TileMap tm[4];
  if (!make_tile_map(&tm[0], q, sh.d, sh.nq, sh.heads, bq, st.qn, st.qh, st.qb, BwdTile<16>::R) ||
      !make_tile_map(&tm[1], g, sh.d, sh.nq, sh.heads, bq, st.gn, st.gh, st.gb, BwdTile<16>::R) ||
      !make_tile_map(&tm[2], k, sh.d, sh.nk, sh.heads, bkv, st.kn, st.kh, st.kb, BwdTile<16>::R) ||
      !make_tile_map(&tm[3], v, sh.d, sh.nk, sh.heads, bkv, st.vn, st.vh, st.vb, BwdTile<16>::R)) {
    return -4;
  }
  m.q = tm[0].map, m.g = tm[1].map, m.k = tm[2].map, m.v = tm[3].map;
  m.cq = TileCoord{tm[0].order}, m.cg = TileCoord{tm[1].order};
  m.ck = TileCoord{tm[2].order}, m.cv = TileCoord{tm[3].order};
  switch (dp) {
    case 16: return launch_wgmma<16>(m, ld, dq, dk, dv, bq, bkv, sh, scale_log2, scale, s);
    case 32: return launch_wgmma<32>(m, ld, dq, dk, dv, bq, bkv, sh, scale_log2, scale, s);
    case 48: return launch_wgmma<48>(m, ld, dq, dk, dv, bq, bkv, sh, scale_log2, scale, s);
    case 64: return launch_wgmma<64>(m, ld, dq, dk, dv, bq, bkv, sh, scale_log2, scale, s);
    case 80: return launch_wgmma<80>(m, ld, dq, dk, dv, bq, bkv, sh, scale_log2, scale, s);
    case 96: return launch_wgmma<96>(m, ld, dq, dk, dv, bq, bkv, sh, scale_log2, scale, s);
    default: return -2;
  }
}

int dispatch_scalar(int dt, const void* q, const void* k, const void* v, const void* g,
                    const float2* ld, void* dq, void* dk, void* dv, int bq,
                    int bkv, Shape sh, int G, const Strides& st, float scale_log2, float scale,
                    cudaStream_t s) {
  switch (dt) {
    case 8: return launch_scalar<8>(q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, G, st, scale_log2, scale, s);
    case 16: return launch_scalar<16>(q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, G, st, scale_log2, scale, s);
    case 24: return launch_scalar<24>(q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, G, st, scale_log2, scale, s);
    default: return -2;
  }
}

template <typename T>
int launch_prep(const void* g, const void* o, const void* lse, float2* ld, int bq, Shape sh,
                const Strides& st, long long sob, long long son, long long soh, cudaStream_t s) {
  const long long total = (long long)bq * sh.heads * sh.nq_pad;
  bwd_prep_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(o), static_cast<const float*>(lse), ld, total, sh,
      st.gb, st.gn, st.gh, sob, son, soh);
  return (int)cudaGetLastError();
}

}  // namespace

// Query rows per (batch, head) of the scratch the caller passes: nq rounded
// up to this, two floats each.
extern "C" int flash_attention_bwd_pad_rows() { return PAD_ROWS; }

// dtype: 0 = float32, 1 = bfloat16.  Strides (in elements) of q, k, v, o, g
// in (batch, token, head) order; the head dim is contiguous.  lse is fp32
// (bq*heads, nq) contiguous; scratch holds bq*heads*nq_pad float pairs
// (nq_pad = nq rounded up to flash_attention_bwd_pad_rows()); dq, dk, dv
// contiguous.  Launches the (lse, dsum) pre-pass, the dq and the dk/dv
// kernel on ``stream``.  Returns 0 or the CUDA error code; -1 bad dtype,
// -2 unsupported head dim, -3 grid too large, -4 bf16 rows the tensor-core
// path cannot read.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* g, const void* lse,
    void* scratch, void* dq, void* dk, void* dv, int dtype, int bq, int nq, int nk,
    int heads, int d, int kv_repeat, int nq_pad,
    long long sqb, long long sqn, long long sqh,
    long long skb, long long skn, long long skh,
    long long svb, long long svn, long long svh,
    long long sob, long long son, long long soh,
    long long sgb, long long sgn, long long sgh,
    float scale_log2, float scale, void* stream) {
  if ((long long)bq * heads > 65535) return -3;
  if (nq_pad < nq || nq_pad % PAD_ROWS != 0) return -3;
  const Strides st = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sgb, sgn, sgh};
  const Shape sh = {nq, nk, heads, d, kv_repeat, nq_pad};
  const int bkv = bq / kv_repeat;
  float2* ld = static_cast<float2*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    int G = 1;
    while ((d + G - 1) / G > 24 && G < 32) G *= 2;
    const int dt = (((d + G - 1) / G) + 7) / 8 * 8;
    if (dt > 24) return -2;
    const int err = launch_prep<float>(g, o, lse, ld, bq, sh, st, sob, son, soh, s);
    if (err != 0) return err;
    return dispatch_scalar(dt, q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, G, st, scale_log2, scale, s);
  }
  if (dtype != 1) return -1;
  const int dp = (d + 15) / 16 * 16;
  if (d % 8 != 0 || d > 160 || dp == 112 || dp == 144) return -4;
  const long long strides[15] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh, sgb, sgn, sgh};
  for (long long x : strides) {
    if (x % 8 != 0) return -4;
  }
  const void* ptrs[9] = {q, k, v, o, g, scratch, dq, dk, dv};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -4;
  }
  const int err = launch_prep<bf16>(g, o, lse, ld, bq, sh, st, sob, son, soh, s);
  if (err != 0) return err;
  return dispatch_bf16(dp, q, k, v, g, ld, dq, dk, dv, bq, bkv, sh, st, scale_log2, scale, s);
}
