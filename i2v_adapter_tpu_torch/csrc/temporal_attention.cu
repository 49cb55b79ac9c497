// Frame-axis (temporal) attention forward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/attention.py::_temporal_kernel_cs (launched
// by _temporal_flash_cs through temporal_attention).
//
// Computes, for q (B, Fq, S, C) and k/v (B, F, S, C) with heads as
// contiguous d-slices of C, per (b, s, head) and query frame: F dot products
// over d, a max-subtracted exp2 softmax over the key frames in fp32 and the
// weighted sum of v, written as (B, Fq, S, C).  Fq <= F <= 32, d even.
//
// What bounds it here: bytes.  The F x F attention per token is tiny
// (4*F*d flops per output element), so a call moves (Fq + 2F) input and Fq
// output frames of B*S*C elements and does little else: 64 frames x 2 x
// 4096 x 320 x 2 B = 335 MB per call at the 512px S = 4096, C = 320, F = 16,
// B = 2 site in bf16 (0.100 ms at 3.35 TB/s).  The design keeps enough of
// those bytes in flight, and spends few instructions per byte.
//
// bf16 (every UNet site): temporal_mma_kernel.
//
// * Tiles.  A tile is (batch, TS tokens, group of HG heads).  Each of its
//   (frame, token) rows is a run of HG*d contiguous channels, fetched by one
//   bulk copy (TMA) into shared memory.  The tile size is chosen by bytes
//   (about T_STAGE per tile), not by d, so the CTAs per SM do not fall as d
//   grows.  Rows are stored [token][frame], padded so that consecutive
//   frames of one token start in different 16-byte bank groups.
// * Persistent CTAs, one ring of T_NS tiles each, on mbarriers: one warp
//   issues the copies of tile j + T_NS - 1 before the CTA computes tile j, so
//   two tiles are in flight while one is computed.  Measured: rows of 320
//   channels and two CTAs per SM time best; a deeper ring that frees a slot
//   only two tiles after its stores, at 160-channel rows, was slower.
// * Tensor cores per (token, head).  One warp owns a (token, head) pair:
//   S = Q.K^T (Fq x F x d) is mma.sync m16n8k16 over d / 16 k-steps, with Q
//   and K read by ldmatrix from their [frame][channel] rows (Fq <= 16 is one
//   m-tile, F = 16 two n8-tiles, F = 32 four; d = 40 reads a 48-wide slice
//   whose last 8 columns are zeroed in Q's registers).  The softmax runs on
//   the accumulator registers with quad shuffles; normalised P is rounded
//   to bf16 A fragments (the plain version rounds P to v's dtype too), and
//   O = P.V reads V with ldmatrix.trans, 16 channels at a time.  Padded rows
//   and key frames are clamped reads; their scores are masked to -inf or
//   never stored.
// * Stores.  O overwrites the pair's own columns of its Q rows in shared
//   memory; once the tile is done, the rows go back by bulk copies.
//
// It needs d a multiple of 8, strides that are multiples of 8 and 16-byte
// aligned bases (16-byte runs).  Other bf16 inputs and every fp32 input take
// temporal_fwd_kernel: one thread per (query frame, token) walking all d
// channels on the FMA pipe from cp.async-staged slices (the exact reference
// path of the card tests).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// scalar path: fp32, and bf16 layouts the tensor-core path cannot read
// ---------------------------------------------------------------------------

// bytes of q/k/v slices per CTA: smaller slices keep more CTAs per SM in
// flight, which measured faster than fewer, larger ones
constexpr int SMEM_BUDGET = 32 * 1024;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 to_f2(float2 x) { return x; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) { return __bfloat1622float2(x); }
template <typename P> __device__ __forceinline__ P from_f2(float a, float b);
template <> __device__ __forceinline__ float2 from_f2<float2>(float a, float b) {
  return make_float2(a, b);
}
template <> __device__ __forceinline__ __nv_bfloat162 from_f2<__nv_bfloat162>(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// 4- or 8-byte global -> shared copy in flight without a register round
// trip; src_size 0 zero-fills (tokens past S)
__device__ __forceinline__ void cp_async(void* smem, const void* glob, int bytes, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(saddr), "l"(glob), "r"(valid ? 8 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(saddr), "l"(glob), "r"(valid ? 4 : 0));
  }
}

// copy nf frames x ts tokens x d channels (as pairs) between a (frame,
// token)-strided global slice and a [frame][token][ds] shared slice
template <typename T, bool TO_SHARED>
__device__ __forceinline__ void copy_slice(T* smem, T* glob, int nf, int ts, int d, int ds,
                                           int s0, int s_len, long long sf, long long ss) {
  using P = typename Pair<T>::type;
  const int d2 = d / 2;
  for (int i = threadIdx.x; i < nf * ts * d2; i += blockDim.x) {
    const int c = 2 * (i % d2);
    const int r = i / d2;
    const int t = r % ts;
    const int fr = r / ts;
    const int s = s0 + t;
    P* sp = reinterpret_cast<P*>(smem + (fr * ts + t) * ds + c);
    P* gp = reinterpret_cast<P*>(glob + fr * sf + (long long)min(s, s_len - 1) * ss + c);
    if (TO_SHARED) {
      cp_async(sp, gp, (int)sizeof(P), s < s_len);
    } else if (s < s_len) {
      *gp = *sp;
    }
  }
}

template <typename T, int FMAX>
__global__ void temporal_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int fq, int f, int s_len, int d, int ds, int ts,
    long long qsb, long long qsf, long long qss,
    long long ksb, long long ksf, long long kss,
    long long vsb, long long vsf, long long vss,
    long long osb, long long osf, long long oss, float scale_log2) {
  using P = typename Pair<T>::type;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // [fq][ts][ds], reused for the output
  T* ks = qs + fq * ts * ds;            // [f][ts][ds]
  T* vs = ks + f * ts * ds;             // [f][ts][ds]

  const int h = blockIdx.x;
  const int s0 = blockIdx.y * ts;
  const int b = blockIdx.z;
  const int c0 = h * d;

  copy_slice<T, true>(qs, const_cast<T*>(q) + b * qsb + c0, fq, ts, d, ds, s0, s_len, qsf, qss);
  copy_slice<T, true>(ks, const_cast<T*>(k) + b * ksb + c0, f, ts, d, ds, s0, s_len, ksf, kss);
  copy_slice<T, true>(vs, const_cast<T*>(v) + b * vsb + c0, f, ts, d, ds, s0, s_len, vsf, vss);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int t = threadIdx.x % ts;
  const int fr = threadIdx.x / ts;
  if (fr < fq) {
    T* qrow = qs + (fr * ts + t) * ds;
    float sc[FMAX];
#pragma unroll
    for (int g = 0; g < FMAX; ++g) sc[g] = 0.f;
    for (int c = 0; c < d; c += 2) {
      const float2 qv = to_f2(*reinterpret_cast<const P*>(qrow + c));
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < f) {
          const float2 kv = to_f2(*reinterpret_cast<const P*>(ks + (g * ts + t) * ds + c));
          sc[g] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, sc[g]));
        }
      }
    }
    float mx = -3.0e38f;
#pragma unroll
    for (int g = 0; g < FMAX; ++g) {
      if (g < f) {
        sc[g] *= scale_log2;
        mx = fmaxf(mx, sc[g]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < FMAX; ++g) {
      if (g < f) {
        sc[g] = exp2f(sc[g] - mx);
        sum += sc[g];
      }
    }
#pragma unroll
    for (int g = 0; g < FMAX; ++g) sc[g] = sc[g] / sum;
    // the q row belongs to this thread alone: overwrite it with the output
    for (int c = 0; c < d; c += 2) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int g = 0; g < FMAX; ++g) {
        if (g < f) {
          const float2 vv = to_f2(*reinterpret_cast<const P*>(vs + (g * ts + t) * ds + c));
          acc.x = fmaf(sc[g], vv.x, acc.x);
          acc.y = fmaf(sc[g], vv.y, acc.y);
        }
      }
      *reinterpret_cast<P*>(qrow + c) = from_f2<P>(acc.x, acc.y);
    }
  }
  __syncthreads();
  copy_slice<T, false>(qs, o + b * osb + c0, fq, ts, d, ds, s0, s_len, osf, oss);
}

template <typename T, int FMAX>
int launch(const void* q, const void* k, const void* v, void* o, int b, int fq,
           int f, int s_len, int d, int heads, const long long* st,
           float scale_log2, cudaStream_t stream) {
  const int ds = (d / 2) % 2 == 0 ? d + 2 : d;  // odd word stride per token row
  const int per_token = (fq + 2 * f) * ds * (int)sizeof(T);
  if (per_token > 227 * 1024) return -4;
  int ts = SMEM_BUDGET / per_token;
  if (ts > 32) ts = 32;
  if (ts < 1) ts = 1;  // one token per CTA, above the budget
  const size_t smem = (size_t)ts * per_token;
  auto kern = temporal_fwd_kernel<T, FMAX>;
  static SmemLimit limit;
  cudaError_t err = limit.raise(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((ts * fq + 31) / 32) * 32;
  if ((s_len + ts - 1) / ts > 65535) return -3;
  dim3 grid(heads, (s_len + ts - 1) / ts, b);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), fq, f, s_len, d, ds, ts, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int fq,
             int f, int s_len, int d, int heads, const long long* st,
             float scale_log2, cudaStream_t stream) {
  if (b > 65535) return -3;
  if (f <= 16) return launch<T, 16>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, stream);
  return launch<T, 32>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, stream);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------

constexpr int T_WARPS = 4;           // warps per CTA; warp 0 also issues the copies
constexpr int T_NS = 3;              // tiles in a CTA's ring
constexpr int T_STAGE = 32 * 1024;   // bytes a tile aims at
constexpr int T_MAX_ROW = 320;       // channels per row a head group aims at

struct TParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long st[12];  // q, k, v, o strides in elements: (batch, frame, token) each
  long long ntiles;
  int fq, f, s_len, d;
  int hg, nhg, ts, ntt;  // heads per group, groups, tokens per tile, token tiles
  int rs, kofs, vofs, stage;  // bytes: a row, K and V regions in a tile, a tile
  float scale_log2;
};

// shared -> global bulk copy, tracked per thread by bulk groups
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// all but the latest N of this thread's bulk store groups have read their
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// NF: key frames in groups of 16 (F <= 16 * NF); MQ: query m-tiles (Fq <= 16 * MQ)
template <int NF, int MQ>
__global__ void __launch_bounds__(T_WARPS * 32) temporal_mma_kernel(const TParams p) {
  extern __shared__ __align__(128) uint8_t tsm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tsm + T_NS * p.stage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows = p.fq + 2 * p.f;     // frames per token
  const int rbytes = 2 * p.hg * p.d;  // bytes of a row that a copy fills

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_NS; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const long long first = blockIdx.x, step = gridDim.x;
  const int nlocal = first < p.ntiles ? (int)((p.ntiles - first + step - 1) / step) : 0;
  struct Tile {
    int b, s0, nv, c0;  // batch, first token, valid tokens, first channel
  };
  auto decode = [&](int j) {
    const long long tile = first + (long long)j * step;
    const int hgi = (int)(tile % p.nhg);
    const long long r = tile / p.nhg;
    Tile t;
    t.s0 = (int)(r % p.ntt) * p.ts;
    t.b = (int)(r / p.ntt);
    t.nv = min(p.ts, p.s_len - t.s0);
    t.c0 = hgi * p.hg * p.d;
    return t;
  };
  // warp 0: the copies of local tile j into its slot
  auto issue = [&](int j, int slot) {
    const Tile t = decode(j);
    uint8_t* st = tsm + slot * p.stage;
    uint64_t* bar = &full[slot];
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)(t.nv * rows * rbytes));
    __syncwarp();
    for (int i = lane; i < t.nv * rows; i += 32) {
      const int fr = i / t.nv, tok = i - fr * t.nv;
      const __nv_bfloat16* src;
      uint8_t* dst;
      if (fr < p.fq) {
        src = p.q + t.b * p.st[0] + fr * p.st[1];
        dst = st + (tok * p.fq + fr) * p.rs;
      } else if (fr < p.fq + p.f) {
        const int ff = fr - p.fq;
        src = p.k + t.b * p.st[3] + ff * p.st[4];
        dst = st + p.kofs + (tok * p.f + ff) * p.rs;
      } else {
        const int ff = fr - p.fq - p.f;
        src = p.v + t.b * p.st[6] + ff * p.st[7];
        dst = st + p.vofs + (tok * p.f + ff) * p.rs;
      }
      const long long ss = fr < p.fq ? p.st[2] : fr < p.fq + p.f ? p.st[5] : p.st[8];
      bulk_load(dst, src + (t.s0 + tok) * ss + t.c0, rbytes, bar);
    }
  };

  if (warp == 0)
    for (int j = 0; j < T_NS - 1 && j < nlocal; ++j) issue(j, j);
  // zero the pad after every row: it is read (d = 40) and never copied
  const int pad = (p.rs - rbytes) / 16, nrows = p.stage / p.rs;
  for (int i = threadIdx.x; i < T_NS * nrows * pad; i += blockDim.x) {
    const int r = i / pad;
    *reinterpret_cast<uint4*>(tsm + (r / nrows) * p.stage + (r % nrows) * p.rs + rbytes +
                              (i - r * pad) * 16) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int kd = (p.d + 15) >> 4;  // 16-channel steps of a head
  int slot = 0, phase = 0;  // of tile j
  for (int j = 0; j < nlocal; ++j) {
    const int prev = slot == 0 ? T_NS - 1 : slot - 1;  // tile j - 1's, refilled now
    if (warp == 0) {
      bulk_wait_read<0>();  // the stores of tile j - 1 have read its slot
      __syncwarp();
      if (j + T_NS - 1 < nlocal) issue(j + T_NS - 1, prev);
    }
    const Tile t = decode(j);
    uint8_t* st = tsm + slot * p.stage;
    mbar_wait(&full[slot], phase);

    for (int pr = warp; pr < t.nv * p.hg; pr += T_WARPS) {
      const int tok = pr / p.hg, h = pr - tok * p.hg;
      uint8_t* qb = st + tok * p.fq * p.rs + h * p.d * 2;
      const uint32_t kb = smem_u32(st + p.kofs + tok * p.f * p.rs + h * p.d * 2);
      const uint32_t vb = smem_u32(st + p.vofs + tok * p.f * p.rs + h * p.d * 2);
      // ---- S = Q.K^T: rows past Fq and key frames past F read clamped rows
      uint32_t qa[MQ], ka[NF];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
        qa[mt] = smem_u32(qb) + min(mt * 16 + (lane & 15), p.fq - 1) * p.rs + (lane >> 4) * 16;
#pragma unroll
      for (int ng = 0; ng < NF; ++ng)
        ka[ng] = kb + min(ng * 16 + (lane & 7) + ((lane >> 4) << 3), p.f - 1) * p.rs + ((lane >> 3) & 1) * 16;
      float sc[MQ][2 * NF][4];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
        for (int n = 0; n < 2 * NF; ++n) sc[mt][n][0] = sc[mt][n][1] = sc[mt][n][2] = sc[mt][n][3] = 0.f;
      for (int kk = 0; kk < kd; ++kk) {
        uint32_t a[MQ][4];
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt) {
          ldsm_x4(a[mt], qa[mt] + kk * 32);
          if (kk * 16 + 8 >= p.d) a[mt][2] = a[mt][3] = 0u;  // columns past d (d = 40)
        }
#pragma unroll
        for (int ng = 0; ng < NF; ++ng) {
          uint32_t bk[4];
          ldsm_x4(bk, ka[ng] + kk * 32);
#pragma unroll
          for (int mt = 0; mt < MQ; ++mt) {
            mma_bf16(sc[mt][2 * ng], a[mt], bk[0], bk[1]);
            mma_bf16(sc[mt][2 * ng + 1], a[mt], bk[2], bk[3]);
          }
        }
      }
      // ---- softmax over the key frames, on the accumulators (row g: quad g)
      uint32_t pa[MQ][NF][4];
#pragma unroll
      for (int mt = 0; mt < MQ; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x[2 * NF][2];
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < 2 * NF; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n * 8 + 2 * t4 + e;
              x[n][e] = col < p.f ? sc[mt][n][2 * hh + e] * p.scale_log2 : -INFINITY;
              mx = fmaxf(mx, x[n][e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 2 * NF; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[n][e] = exp2f(x[n][e] - mx);
              sum += x[n][e];
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const float inv = 1.f / sum;
#pragma unroll
          for (int ng = 0; ng < NF; ++ng) {
            pa[mt][ng][hh] = pack_bf16(x[2 * ng][0] * inv, x[2 * ng][1] * inv);
            pa[mt][ng][2 + hh] = pack_bf16(x[2 * ng + 1][0] * inv, x[2 * ng + 1][1] * inv);
          }
        }
      }
      // ---- O = P.V, 16 channels at a time, into the pair's own Q columns
      uint32_t va[NF];
#pragma unroll
      for (int ng = 0; ng < NF; ++ng)
        va[ng] = vb + min(ng * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), p.f - 1) * p.rs + (lane >> 4) * 16;
      for (int ch = 0; ch < kd; ++ch) {
        float oc[MQ][2][4];
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n) oc[mt][n][0] = oc[mt][n][1] = oc[mt][n][2] = oc[mt][n][3] = 0.f;
#pragma unroll
        for (int ng = 0; ng < NF; ++ng) {
          uint32_t bv[4];
          ldsm_x4_t(bv, va[ng] + ch * 32);
#pragma unroll
          for (int mt = 0; mt < MQ; ++mt) {
            mma_bf16(oc[mt][0], pa[mt][ng], bv[0], bv[1]);
            mma_bf16(oc[mt][1], pa[mt][ng], bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MQ; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = mt * 16 + g + 8 * hh, col = ch * 16 + n * 8 + 2 * t4;
              if (row < p.fq && col < p.d)
                *reinterpret_cast<uint32_t*>(qb + row * p.rs + col * 2) =
                    pack_bf16(oc[mt][n][2 * hh], oc[mt][n][2 * hh + 1]);
            }
      }
    }
    fence_proxy_async();  // the O rows, written by this thread, to the bulk stores
    __syncthreads();
    if (warp == 0) {
      for (int i = lane; i < t.nv * p.fq; i += 32) {
        const int fr = i / t.nv, tok = i - fr * t.nv;
        bulk_store(p.o + t.b * p.st[9] + fr * p.st[10] + (t.s0 + tok) * p.st[11] + t.c0,
                   smem_u32(st + (tok * p.fq + fr) * p.rs), rbytes);
      }
      bulk_commit();
    }
    if (++slot == T_NS) {
      slot = 0;
      phase ^= 1;
    }
  }
  if (warp == 0) bulk_wait_read<0>();  // shared memory lives until the stores have read it
}

template <int NF, int MQ>
int launch_mma_t(const TParams& p, size_t smem, cudaStream_t stream) {
  auto kern = temporal_mma_kernel<NF, MQ>;
  // the resident CTAs for this shared-memory size, queried once per size
  // and device (the queries cost more host time than a small launch)
  static int cached_dev = -1, ctas = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T_WARPS * 32, smem);
    if (err != cudaSuccess) return (int)err;
    ctas = sms * (per_sm > 0 ? per_sm : 1);
    cached_dev = dev;
    cached_smem = smem;
  }
  const unsigned grid = (unsigned)(p.ntiles < ctas ? p.ntiles : ctas);
  kern<<<grid, T_WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// NOT_TAKEN when the tensor-core path cannot take these inputs, else 0 or
// the CUDA error of the launch
constexpr int NOT_TAKEN = -100;

int launch_mma(const void* q, const void* k, const void* v, void* o, int b, int fq, int f,
               int s_len, int d, int heads, const long long* st, float scale_log2,
               cudaStream_t stream) {
  if (d % 8 != 0) return NOT_TAKEN;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return NOT_TAKEN;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return NOT_TAKEN;
  // row bytes padded to an odd number of 16-byte units: the eight rows of an
  // ldmatrix (frames of one token) then fall in eight different bank groups
  auto row_bytes = [&](int hg) {
    const int rb = 2 * hg * d;
    return (rb / 16) % 2 == 0 ? rb + 16 : rb + 32;
  };
  const int frames = fq + 2 * f;
  int hg = heads;  // the most heads whose rows stay within T_MAX_ROW channels ...
  while (hg > 1 && (hg * d > T_MAX_ROW || heads % hg != 0)) --hg;
  while (hg > 1 && frames * row_bytes(hg) > T_STAGE) {  // ... and a token within a tile
    do --hg;
    while (heads % hg != 0);
  }
  TParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  for (int i = 0; i < 12; ++i) p.st[i] = st[i];
  p.fq = fq;
  p.f = f;
  p.s_len = s_len;
  p.d = d;
  p.hg = hg;
  p.nhg = heads / hg;
  p.rs = row_bytes(hg);
  const int per_token = frames * p.rs;
  p.ts = T_STAGE / per_token;
  if (p.ts < 1) p.ts = 1;
  if (p.ts > s_len) p.ts = s_len;
  p.ntt = (s_len + p.ts - 1) / p.ts;
  p.kofs = p.ts * fq * p.rs;
  p.vofs = p.ts * (fq + f) * p.rs;
  p.stage = (p.ts * per_token + 127) / 128 * 128;
  p.ntiles = (long long)b * p.ntt * p.nhg;
  p.scale_log2 = scale_log2;
  const size_t smem = (size_t)T_NS * p.stage + T_NS * sizeof(uint64_t);
  if (smem > 227 * 1024) return NOT_TAKEN;
  if (f > 16) return fq > 16 ? launch_mma_t<2, 2>(p, smem, stream) : launch_mma_t<2, 1>(p, smem, stream);
  return launch_mma_t<1, 1>(p, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides (in elements) of q, k, v, o in
// (batch, frame, token) order; channels are contiguous.  Returns 0 or the
// CUDA error code of the launch; -1 bad dtype, -2 unsupported frame counts,
// -3 grid too large, -4 shared memory too small for one token, -5 odd head
// dim, odd stride or unaligned base.
extern "C" int temporal_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int fq, int f, int s_len, int c, int heads,
    long long qsb, long long qsf, long long qss,
    long long ksb, long long ksf, long long kss,
    long long vsb, long long vsf, long long vss,
    long long osb, long long osf, long long oss,
    float scale_log2, void* stream) {
  if (f < 1 || f > 32 || fq < 1 || fq > f) return -2;
  const int d = c / heads;
  const long long st[12] = {qsb, qsf, qss, ksb, ksf, kss, vsb, vsf, vss, osb, osf, oss};
  const int pair_bytes = dtype == 0 ? 8 : 4;
  bool aligned = d % 2 == 0;
  for (int i = 0; i < 12; ++i) aligned = aligned && st[i] % 2 == 0;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs) aligned = aligned && reinterpret_cast<uintptr_t>(p) % pair_bytes == 0;
  if (!aligned) return -5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, s);
  if (dtype == 1) {
    const int err = launch_mma(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, s);
    if (err != NOT_TAKEN) return err;
    return dispatch<__nv_bfloat16>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, s);
  }
  return -1;
}
