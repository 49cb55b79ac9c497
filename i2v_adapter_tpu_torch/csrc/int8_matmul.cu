// (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, for Hopper (sm_90a), or
// its dequantised form y * (xs * ws[n]) + bias[n] in fp32 or bf16; plain C
// interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/profile_int8_dense.py::_int8_mm_kernel (the
// tiled int8 matmul behind int8_pallas in the int8 dense microbenchmark).
// The port also runs it on the serving path: the stride-2 UNet downsamplers'
// int8 convs are an int8 im2col (PyTorch) followed by this kernel with the
// dequantising epilogue (ops/int8.py).
//
// What bounds it here: at the tool's shapes with K = 320..640, bytes -- the
// int32 result is 4*M*N bytes against 2*M*N*K operations at the int8
// tensor-core rate, so the result's write is the larger time; at K >= 1280,
// operations.  The design keeps the tensor cores fed for the second and the
// output streaming for the first:
//
// * Operands by TMA.  For 8-bit types wgmma reads A and B K-major only (no
//   transpose bit) and TMA does not transpose bytes, so B arrives as the
//   (N, K) K-contiguous storage of the (K, N) operand: the wrapper passes the
//   transposed view when the caller's operand is stored so (the serving
//   path's quantised weights are), and packs it once per call otherwise.
//   A (128 x 128-byte) and B (BN x 128-byte) tiles, 128-byte swizzle, land
//   in a ring of NS stages on mbarriers; one producer warp keeps NS stages in
//   flight, the TMA zero fill covers the M, N and K tails.
// * Products: two consumer warpgroups, 64 rows each, four
//   wgmma.m64nBNk32.s32.s8.s8 per 128-byte stage, both operands from shared
//   memory; one stage's group stays in flight across the stage boundary
//   (wait depth 1), a stage is released by mbarrier arrival once both
//   warpgroups' products of it are done.
// * Persistent grid: one CTA per SM walks the output tiles (N fastest, so
//   neighbouring CTAs share A rows in L2).  The epilogue writes each
//   warpgroup's 64 rows in chunks of 32 columns into shared memory (swizzled
//   as the TMA store reads it: 128 bytes a row for 4-byte outputs, 64 for
//   bf16) and sends each chunk out with one TMA store; NB chunks per
//   warpgroup are in flight, so the stores of one tile drain while the
//   warpgroups are already in the next tile's main loop, whose stages the
//   producer warp has been loading meanwhile.  (Storing straight from the
//   registers left the int32 write of the byte-bound shapes at about half
//   the HBM rate.)
// * BN (256, 160 or 128) is chosen per call for the fewest padded columns
//   and idle SMs in the last wave.
//
// Sums: |sum| <= K * 127^2, exact in int32 for K < 133,000.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tiles.cuh"

namespace {

constexpr int BM = 128, BK = 128;          // rows of a tile; bytes (= int8 values) of K per stage
constexpr int CONSUMERS = 256;             // two warpgroups: the products
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup (one warp issues the TMA loads)
constexpr int MAX_NS = 8;
constexpr int NB = 2;           // epilogue chunks in flight per warpgroup
constexpr int EB = 64 * 128;    // bytes of one epilogue chunk buffer (64 rows x 32 columns)

struct MmParams {
  int M, K, N, nk, tiles_n, tiles, ns;
  int mode;  // 0 int32, 1 fp32, 2 bf16 (the dequantised result)
  const float* xs;    // 0-d activation scale (modes 1, 2)
  const float* ws;    // (N,) column scales (modes 1, 2)
  const float* bias;  // (N,) or null
};

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// all but the NB - 1 most recent store groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(NB - 1) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) int8_mm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                                                                    const __grid_constant__ CUtensorMap bmap,
                                                                    const __grid_constant__ CUtensorMap omap,
                                                                    const MmParams p) {
  constexpr int ABYTES = BM * BK, STAGE = ABYTES + BN * BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ebuf = sm + p.ns * STAGE;                                        // [2 warpgroups][NB][EB]
  uint64_t* full = reinterpret_cast<uint64_t*>(ebuf + 2 * NB * EB);        // [ns] stage landed
  uint64_t* empty = full + p.ns;                                            // [ns] stage released (8 warps)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < p.ns; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // ================= producer
    if (warp == CONSUMERS / 32 && lane == 0) {
      int slot = 0, ph = 0, it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.tiles_n) * BM, n0 = (tile % p.tiles_n) * BN;
        for (int kb = 0; kb < p.nk; ++kb, ++it) {
          if (it >= p.ns) mbar_wait(&empty[slot], ph ^ 1);
          uint8_t* st = sm + slot * STAGE;
          mbar_expect_tx(&full[slot], STAGE);
          tma_load_2d(st, &amap, &full[slot], kb * BK, m0);
          tma_load_2d(st + ABYTES, &bmap, &full[slot], kb * BK, n0);
          if (++slot == p.ns) {
            slot = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ================= consumers: the products and the epilogue
  const int wg = warp >> 2, t = lane & 3;
  const int row_in_wg = (warp & 3) * 16 + (lane >> 2);
  const float xs = p.mode != 0 ? *p.xs : 0.f;
  int acc[BN / 2];
  int slot = 0, ph = 0, prev = 0, chunk = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.tiles_n) * BM, n0 = (tile % p.tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kb = 0; kb < p.nk; ++kb) {
      mbar_wait(&full[slot], ph);
      wgmma_fence();
      const uint32_t a0 = smem_u32(sm + slot * STAGE) + wg * 64 * BK;
      const uint32_t b0 = smem_u32(sm + slot * STAGE + ABYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<BN>(acc, desc_sw128(a0 + 32 * kk), desc_sw128(b0 + 32 * kk));
      wgmma_commit();
      wgmma_wait_one();  // the previous stage's products are done
      if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = slot;
      if (++slot == p.ns) {
        slot = 0;
        ph ^= 1;
      }
    }
    wgmma_wait_all();
    keep(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: thread (g, t) of warp w holds rows 16w + g and 16w + g + 8,
    // columns 8j + 2t and 8j + 2t + 1 of each 8-column block j.  Chunk cc
    // (columns 32cc..32cc+31) goes to a buffer of 64 rows, 16-byte unit u of
    // row r stored at unit u ^ (r & 7) (128-byte rows, 4-byte outputs) or
    // u ^ ((r >> 1) & 3) (64-byte rows, bf16): the TMA store's swizzle.
    const int esize = p.mode == 2 ? 2 : 4;
#pragma unroll
    for (int cc = 0; cc < BN / 32; ++cc) {
      if (n0 + 32 * cc >= p.N) continue;  // the same for the whole warpgroup
      uint8_t* buf = ebuf + (wg * NB + chunk % NB) * EB;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * cc + jj, col = 8 * jj + 2 * t, n = n0 + 32 * cc + col;
        float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
        if (p.mode != 0) {  // the plain version's order: (xs * ws), y * that, + bias, each rounded
          s0 = n < p.N ? __fmul_rn(xs, p.ws[n]) : 0.f;
          s1 = n + 1 < p.N ? __fmul_rn(xs, p.ws[n + 1]) : 0.f;
          if (p.bias != nullptr) {
            b0 = n < p.N ? p.bias[n] : 0.f;
            b1 = n + 1 < p.N ? p.bias[n + 1] : 0.f;
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row_in_wg + 8 * hh, byte = col * esize;
          const int unit = esize == 4 ? ((byte >> 4) ^ (r & 7)) : ((byte >> 4) ^ ((r >> 1) & 3));
          uint8_t* dst = buf + r * 32 * esize + unit * 16 + (byte & 15);
          const int v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
          if (p.mode == 0) {
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
            continue;
          }
          float f0 = __fmul_rn(__int2float_rn(v0), s0), f1 = __fmul_rn(__int2float_rn(v1), s1);
          if (p.bias != nullptr) {
            f0 = __fadd_rn(f0, b0);
            f1 = __fadd_rn(f1, b1);
          }
          if (p.mode == 1) {
            *reinterpret_cast<float2*>(dst) = make_float2(f0, f1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(f0, f1);
          }
        }
      }
      fence_proxy_async();  // this thread's part of the chunk, to the TMA store's reads
      warpgroup_sync(wg);
      if ((tid & 127) == 0) {
        tma_store_2d(&omap, buf, n0 + 32 * cc, m0 + wg * 64);
        bulk_commit();
        bulk_wait_read();  // the buffer the next chunk writes is free again
      }
      warpgroup_sync(wg);
      ++chunk;
    }
  }
  if ((tid & 127) == 0) bulk_wait_all();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// a 2-D int8 map over rows of ``k`` contiguous bytes, boxes of 128 bytes x
// ``box_rows`` rows, 128-byte swizzle, zeros outside
bool make_map(CUtensorMap* map, EncodeTiledFn encode, const void* base, int k, int rows, int box_rows) {
  cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)k};
  cuuint32_t box[2] = {BK, (cuuint32_t)box_rows}, estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* x, const void* wt, void* out, int ldo, MmParams p, cudaStream_t stream) {
  constexpr int STAGE = BM * BK + BN * BK;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -6;
  CUtensorMap amap, bmap, omap;
  if (!make_map(&amap, encode, x, p.K, p.M, BM) || !make_map(&bmap, encode, wt, p.K, p.N, BN)) return -6;
  // the output (M rows of ldo elements, N of them real) in 32-column x
  // 64-row boxes, swizzled as the epilogue writes them
  const CUtensorMapDataType otype = p.mode == 0   ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                    : p.mode == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int esize = p.mode == 2 ? 2 : 4;
  cuuint64_t odims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.M}, ostr[1] = {(cuuint64_t)ldo * esize};
  cuuint32_t obox[2] = {32, 64}, oestr[2] = {1, 1};
  if (encode(&omap, otype, 2, out, odims, ostr, obox, oestr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             esize == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -6;
  p.nk = (p.K + BK - 1) / BK;
  p.tiles_n = (p.N + BN - 1) / BN;
  const long long tiles = (long long)((p.M + BM - 1) / BM) * p.tiles_n;
  if (tiles > 0x7fffffffLL) return -3;
  p.tiles = (int)tiles;
  p.ns = (227 * 1024 - 1024 - 2 * NB * EB - 2 * MAX_NS * 8) / STAGE;
  if (p.ns > MAX_NS) p.ns = MAX_NS;
  // stages, epilogue buffers, barriers, + slack to align the base to 1024 bytes
  const size_t smem = (size_t)p.ns * STAGE + 2 * NB * EB + 2 * p.ns * 8 + 1024;
  auto kern = int8_mm_wgmma_kernel<BN>;
  static SmemLimit limit;
  cudaError_t err = limit.raise(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  kern<<<grid, THREADS, smem, stream>>>(amap, bmap, omap, p);
  return (int)cudaGetLastError();
}

// the tile width with the most useful work per SM-wave: padded columns and
// the idle SMs of the last wave both count against it; a narrower tile
// reads more operand bytes per product, so it must win clearly
int pick_bn(int M, int N) {
  const int cand[3] = {256, 160, 128};
  const double pref[3] = {1.0, 0.97, 0.93};
  int best = 256;
  double best_score = -1.0;
  for (int i = 0; i < 3; ++i) {
    const long long tn = (N + cand[i] - 1) / cand[i];
    const long long tiles = (long long)((M + BM - 1) / BM) * tn;
    const long long waves = (tiles + sm_count() - 1) / sm_count();
    const double score = pref[i] * ((double)N / (double)(tn * cand[i])) *
                         ((double)tiles / (double)(waves * sm_count()));
    if (score > best_score) {
      best_score = score;
      best = cand[i];
    }
  }
  return best;
}

}  // namespace

// x (M, K) int8 row-major; wt (N, K) int8 row-major, the K-contiguous storage
// of the (K, N) operand; out (M, N) with rows ldo elements apart (ldo >= N,
// ldo * the element size a multiple of 16 bytes): int32 (mode 0), or the
// dequantised y * (xs * ws[n]) (+ bias[n]) as fp32 (mode 1) or bf16 (mode 2)
// with xs a device scalar, ws and bias (N,) fp32 (bias may be null).
// Returns 0 or the CUDA error code of the launch; -1 bad mode, -3 too large,
// -4 a layout the kernel cannot read or write (K not a multiple of 16, a
// bad ldo, a base not 16-byte aligned), -6 no tensor map.
extern "C" int int8_matmul(const void* x, const void* wt, void* out, int M, int K, int N, int ldo, int mode,
                           const void* xs, const void* ws, const void* bias, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return -3;
  if (mode < 0 || mode > 2 || (mode != 0 && (xs == nullptr || ws == nullptr))) return -1;
  if (K % 16 != 0 || ldo < N || (ldo * (mode == 2 ? 2 : 4)) % 16 != 0) return -4;
  const void* ptrs[3] = {x, wt, out};
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return -4;
  }
  MmParams p;
  p.M = M;
  p.K = K;
  p.N = N;
  p.mode = mode;
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_bn(M, N)) {
    case 256:
      return launch<256>(x, wt, out, ldo, p, st);
    case 160:
      return launch<160>(x, wt, out, ldo, p, st);
    default:
      return launch<128>(x, wt, out, ldo, p, st);
  }
}
