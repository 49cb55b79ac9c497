// GroupNorm of a channel-last tensor (N, P, C) -- statistics per (sample,
// group) over every position of the sample -- for Hopper (sm_90a), with the
// following SiLU and the output's abs-max optionally folded in; plain C
// interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/norms.py::group_norm_stats_matmul and
// group_norm_apply, which the JAX package leaves to XLA (it has no Pallas
// GroupNorm: on the TPU XLA fuses the norm into its neighbours), and, on the
// port's no-grad path, the plain composition ops/norms.py::group_norm_plain
// (an fp32 copy of x, var_mean and four fp32 passes: about nine launches and
// 48 bytes moved per bf16 element), with the SiLU pass after it and the
// int8 conv's abs-max read of that SiLU's output.
//
// What bounds it here: bytes.  A few operations per element against 2 bytes
// of bf16 read twice and written once: 6 bytes per element, 2.6 ms of HBM
// time per G elements at 3.35 TB/s.  The design moves those bytes and no
// others, in two launches on the caller's stream:
//
// * Statistics (group_norm_stats_kernel): grid (K chunks of positions, N
//   samples).  Every row holds all G groups (channel-last), so a CTA of
//   R x V threads reads R rows at a time, each thread one 16-byte vector of
//   channels at a fixed column (V vectors a row) with UNROLL loads in
//   flight, and keeps a Welford mean and M2 per channel.  The per-channel
//   states go to shared memory; one warp per group merges its channels'
//   states (Chan's pairwise update, then across the warp by shuffles) and
//   writes the chunk's (count, mean, M2) of every group.  No E[x^2] -
//   mean^2: the variance is as stable as the two-pass var_mean it replaces.
//   K follows the shape: the (K, N) grid is one wave of the CTAs the card
//   holds at once (group_norm_resident_ctas x SMs), so the 32-image spatial
//   norms, the 2-clip motion norm and the 16-frame decoder all fill it and
//   no last, part-filled wave is left (at 17 chunks a sample, 2.06 waves,
//   the 64x64x320 norm took 0.14 ms on an H100 against a 0.075 ms bound).
// * Apply (group_norm_apply_kernel): the same grid and rows, walked in
//   reverse so that it starts on the rows still in L2; each CTA merges its
//   sample's K partials per group in a fixed order (every CTA gets the same
//   statistics bit for bit), then computes y = (x - mean) * rstd * gamma +
//   beta in fp32 as the composition does -- each product and sum rounded on
//   its own (no FMA contraction), rstd = rsqrtf(M2 / n + eps) -- rounds y
//   to x's dtype where the composition rounds, optionally applies SiLU in
//   fp32 to that rounded value and rounds again (F.silu on a bf16 tensor),
//   and writes the result once.  With an abs-max slot given it also reduces
//   max |out| over the whole output: a per-CTA max of the values written,
//   then one atomicMax on the float's bit pattern (non-negative floats order
//   as unsigned integers; a NaN orders above inf, so it propagates as
//   aminmax's does).  The statistics launch zeroes the slot first, in the
//   same stream, so a captured CUDA graph replays it correctly.
//
// Nothing synchronises with the host or reads back to it; the wrapper
// allocates the output, the partials and the slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;   // R * V threads, rounded up to whole warps
constexpr int MAX_SLOT_CHANNELS = 4096;  // R * C per-channel states in shared memory
constexpr int MAX_GROUPS = 1024;
constexpr int STATS_UNROLL = 4;    // 16-byte loads in flight per thread
constexpr int APPLY_UNROLL = 2;    // fewer: the apply keeps 4 parameters per channel in registers

struct GnArgs {
  const void* x;
  void* out;
  const void* gamma;
  const void* beta;
  float* partials;       // (N, K, G, 3): count, mean, M2 of each chunk's positions
  unsigned* absmax;      // bit pattern of max |out|, or null
  long long rows;        // positions per sample
  int N, C, G, K, R, V;  // samples, channels, groups, chunks per sample, row slots, 16-byte vectors per row
  long long rows_per_chunk;
  int param_bf16;        // gamma and beta are bf16 (else fp32)
  float eps;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int VEC = 4;
  __device__ static void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ static float round(float y) { return y; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // a 32-bit word holds two bf16 values, the lower address in the low half
  __device__ static void unpack_word(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static void unpack(const uint4& u, float* v) {
    unpack_word(u.x, v);
    unpack_word(u.y, v + 2);
    unpack_word(u.z, v + 4);
    unpack_word(u.w, v + 6);
  }
  // v holds values already rounded to bf16: their low 16 bits are zero
  __device__ static unsigned pack_word(const float* v) {
    return (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xffff0000u);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(pack_word(v), pack_word(v + 2), pack_word(v + 4), pack_word(v + 6));
  }
  __device__ static float round(float y) { return __bfloat162float(__float2bfloat16_rn(y)); }
};

// Chan's update: (n, mean, m2) absorbs (nb, mb, m2b)
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  const float f = nb / nn;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nn;
}

// the warp's states merged into every lane (lane 0's is the one used)
__device__ __forceinline__ void warp_merge(float& n, float& mean, float& m2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    merge(n, mean, m2, nb, mb, m2b);
  }
}

template <typename T>
__device__ __forceinline__ void welford(const uint4& u, float& count, float* mean, float* m2) {
  constexpr int VEC = Io<T>::VEC;
  float v[VEC];
  Io<T>::unpack(u, v);
  count += 1.f;
  const float inv = 1.f / count;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float d = v[e] - mean[e];
    mean[e] += d * inv;
    m2[e] += d * (v[e] - mean[e]);
  }
}

__device__ __forceinline__ float load_param(const void* p, int c, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]) : static_cast<const float*>(p)[c];
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2) group_norm_stats_kernel(GnArgs a) {
  constexpr int VEC = Io<T>::VEC;
  __shared__ float s_mean[MAX_SLOT_CHANNELS], s_m2[MAX_SLOT_CHANNELS];
  __shared__ float s_count[MAX_THREADS];
  const int k = blockIdx.x, n = blockIdx.y, t = threadIdx.x;
  if (a.absmax != nullptr && k == 0 && n == 0 && t == 0) *a.absmax = 0u;
  const int j = t % a.V, r = t / a.V;
  if (r < a.R) {
    const long long row0 = (long long)k * a.rows_per_chunk;
    const long long row1 = min(row0 + a.rows_per_chunk, a.rows);
    const uint4* base = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + (long long)n * a.rows * a.C) + j;
    float count = 0.f, mean[VEC], m2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) mean[e] = m2[e] = 0.f;
    long long row = row0 + r;
    for (; row + (long long)(STATS_UNROLL - 1) * a.R < row1; row += (long long)STATS_UNROLL * a.R) {
      uint4 u[STATS_UNROLL];
#pragma unroll
      for (int q = 0; q < STATS_UNROLL; ++q) u[q] = __ldg(base + (row + (long long)q * a.R) * a.V);
#pragma unroll
      for (int q = 0; q < STATS_UNROLL; ++q) welford<T>(u[q], count, mean, m2);
    }
    for (; row < row1; row += a.R) welford<T>(__ldg(base + row * a.V), count, mean, m2);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s_mean[r * a.C + j * VEC + e] = mean[e];
      s_m2[r * a.C + j * VEC + e] = m2[e];
    }
    if (j == 0) s_count[r] = count;
  }
  __syncthreads();
  // one warp per group: its R x (C / G) channel states, then the warp's
  const int lane = t % 32, warps = blockDim.x / 32, cpg = a.C / a.G, entries = a.R * cpg;
  for (int g = t / 32; g < a.G; g += warps) {
    float gn = 0.f, gm = 0.f, gq = 0.f;
    for (int e = lane; e < entries; e += 32) {
      const int slot = e / cpg, c = slot * a.C + g * cpg + e % cpg;
      merge(gn, gm, gq, s_count[slot], s_mean[c], s_m2[c]);
    }
    warp_merge(gn, gm, gq);
    if (lane == 0) {
      float* p = a.partials + (((long long)n * a.K + k) * a.G + g) * 3;
      p[0] = gn;
      p[1] = gm;
      p[2] = gq;
    }
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS, 2) group_norm_apply_kernel(GnArgs a) {
  constexpr int VEC = Io<T>::VEC;
  __shared__ float s_gmean[MAX_GROUPS], s_grstd[MAX_GROUPS];
  __shared__ unsigned s_max[MAX_THREADS / 32];
  // chunks, and rows within a chunk, in the reverse of the statistics'
  // order: the rows read last are the likeliest to be in L2 still
  const int k = a.K - 1 - blockIdx.x, n = a.N - 1 - blockIdx.y, t = threadIdx.x;
  const int lane = t % 32, warp = t / 32, warps = blockDim.x / 32;
  // the sample's statistics: its chunks' partials merged per group, in the
  // same order in every CTA
  for (int g = warp; g < a.G; g += warps) {
    float gn = 0.f, gm = 0.f, gq = 0.f;
    for (int kk = lane; kk < a.K; kk += 32) {
      const float* p = a.partials + (((long long)n * a.K + kk) * a.G + g) * 3;
      merge(gn, gm, gq, p[0], p[1], p[2]);
    }
    warp_merge(gn, gm, gq);
    if (lane == 0) {
      s_gmean[g] = gm;
      s_grstd[g] = rsqrtf(gq / gn + a.eps);
    }
  }
  __syncthreads();
  unsigned vmax = 0u;
  const int j = t % a.V, r = t / a.V;
  if (r < a.R) {
    const int cpg = a.C / a.G;
    float mu[VEC], rs[VEC], w[VEC], b[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = j * VEC + e, g = c / cpg;
      mu[e] = s_gmean[g];
      rs[e] = s_grstd[g];
      w[e] = load_param(a.gamma, c, a.param_bf16);
      b[e] = load_param(a.beta, c, a.param_bf16);
    }
    const long long offset = (long long)n * a.rows * a.C;
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + offset) + j;
    uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + offset) + j;
    const long long row0 = (long long)k * a.rows_per_chunk;
    const long long row1 = min(row0 + a.rows_per_chunk, a.rows);
    auto apply = [&](const uint4& u) -> uint4 {
      float v[VEC];
      Io<T>::unpack(u, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[e], mu[e]), rs[e]), w[e]), b[e]);
        y = Io<T>::round(y);
        if (SILU) y = Io<T>::round(y / (1.f + expf(-y)));
        vmax = max(vmax, __float_as_uint(y) & 0x7fffffffu);
        v[e] = y;
      }
      return Io<T>::pack(v);
    };
    // this slot's rows row0 + r + i * R, i = cnt - 1 down to 0: last read,
    // first applied
    const long long left = row1 - row0 - r;
    long long i = (left > 0 ? (left + a.R - 1) / a.R : 0) - 1;
    const uint4* s0 = src + (row0 + r) * a.V;
    uint4* d0 = dst + (row0 + r) * a.V;
    const long long step = (long long)a.R * a.V;
    for (; i >= APPLY_UNROLL - 1; i -= APPLY_UNROLL) {
      uint4 u[APPLY_UNROLL];
#pragma unroll
      for (int q = 0; q < APPLY_UNROLL; ++q) u[q] = __ldg(s0 + (i - q) * step);
#pragma unroll
      for (int q = 0; q < APPLY_UNROLL; ++q) d0[(i - q) * step] = apply(u[q]);
    }
    for (; i >= 0; --i) d0[i * step] = apply(__ldg(s0 + i * step));
  }
  if (a.absmax != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) vmax = max(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
    if (lane == 0) s_max[warp] = vmax;
    __syncthreads();
    if (t == 0) {
      for (int i = 1; i < warps; ++i) vmax = max(vmax, s_max[i]);
      atomicMax(a.absmax, vmax);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int threads_of(int R, int V) { return (R * V + 31) / 32 * 32; }

template <typename T>
int resident_ctas(int threads) {
  int stats = 0, plain = 0, silu = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&stats, group_norm_stats_kernel<T>, threads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plain, group_norm_apply_kernel<T, false>, threads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&silu, group_norm_apply_kernel<T, true>, threads, 0);
  if (err != cudaSuccess) return -(int)err;
  return min(stats, min(plain, silu));
}

template <typename T>
int launch(const GnArgs& a, int N, int silu, cudaStream_t stream) {
  const dim3 grid(a.K, N);
  const int threads = threads_of(a.R, a.V);
  group_norm_stats_kernel<T><<<grid, threads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu)
    group_norm_apply_kernel<T, true><<<grid, threads, 0, stream>>>(a);
  else
    group_norm_apply_kernel<T, false><<<grid, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and out (N, rows, C) contiguous,
// 16-byte aligned; gamma, beta (C,) fp32 or bf16 (param_bf16); partials
// fp32 scratch of N * K * G * 3; absmax null or one fp32 (written as the
// bit pattern of max |out|).  K chunks of rows_per_chunk positions cover a
// sample; R rows at a time per CTA.  Returns 0 or the CUDA error code of a
// launch; -1 bad dtype, -3 sizes out of range, -4 C not a whole number of
// 16-byte vectors or bases not 16-byte aligned.
extern "C" int group_norm(const void* x, void* out, const void* gamma, const void* beta, void* partials,
                          void* absmax, int dtype, int param_bf16, int N, long long rows, int C, int G, int K,
                          long long rows_per_chunk, int R, float eps, int silu, void* stream) {
  if (dtype < 0 || dtype > 1) return -1;
  const int vec = dtype == 1 ? Io<__nv_bfloat16>::VEC : Io<float>::VEC;
  if (N <= 0 || N > 65535 || rows <= 0 || C <= 0 || G <= 0 || G > MAX_GROUPS || C % G != 0 || K <= 0 ||
      K > 65535 || rows_per_chunk <= 0 || (long long)K * rows_per_chunk < rows || R <= 0 || gamma == nullptr ||
      beta == nullptr || partials == nullptr)
    return -3;
  if (C % vec != 0 || !aligned16(x) || !aligned16(out)) return -4;
  const int V = C / vec;
  if ((long long)R * V > MAX_THREADS || (long long)R * C > MAX_SLOT_CHANNELS) return -3;
  GnArgs a;
  a.x = x;
  a.out = out;
  a.gamma = gamma;
  a.beta = beta;
  a.partials = static_cast<float*>(partials);
  a.absmax = static_cast<unsigned*>(absmax);
  a.rows = rows;
  a.N = N;
  a.C = C;
  a.G = G;
  a.K = K;
  a.R = R;
  a.V = V;
  a.rows_per_chunk = rows_per_chunk;
  a.param_bf16 = param_bf16;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(a, N, silu, st) : launch<float>(a, N, silu, st);
}

// CTAs of threads_of(R, V) threads that one SM holds at once for both
// launches (the fewer of the two), for the wrapper's grid: one wave of
// them fills the card.  Negative: minus the CUDA error, or -1 bad dtype.
extern "C" int group_norm_resident_ctas(int dtype, int R, int V) {
  if (dtype < 0 || dtype > 1) return -1;
  const int threads = threads_of(R, V);
  if (R <= 0 || V <= 0 || threads > MAX_THREADS) return -1;
  return dtype == 1 ? resident_ctas<__nv_bfloat16>(threads) : resident_ctas<float>(threads);
}
