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
// (4*F*d flops per output element), so a call moves (Fq + 2F) inputs and Fq
// outputs of B*S*C elements and does little else: about 168 MB per call at
// the 512px S = 4096, C = 320, F = 16, B = 2 site in bf16.
//
// Design: one CTA per (head, tile of TS tokens, batch), with the head index
// fastest so that neighbouring CTAs read the rest of each 32-byte sector
// from L2.  The CTA stages its q, k and v slices in shared memory in the
// input type with cp.async (the whole slice in flight at once, no register
// round trip), rows padded to an odd number of 32-bit words so that reads
// of different tokens hit different banks.  One thread per (query frame,
// token) keeps its F scores in registers and reads k and v as channel
// pairs; the output goes back through the thread's own q row to a
// coalesced store.  TS is chosen so the slices fit 32 KB; any S is accepted
// (no block-size rule).  Measured alternatives (several query frames per
// thread, larger slices) were slower: fewer CTAs in flight per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  if (f <= 16) return launch<T, 16>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, stream);
  return launch<T, 32>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, stream);
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
  if (b > 65535) return -3;
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
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, b, fq, f, s_len, d, heads, st, scale_log2, s);
  return -1;
}
