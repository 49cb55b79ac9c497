// 3x3 stride-1 SAME convolution of channel-last activations, optionally of
// silu(x*a + s), for Hopper (sm_90a); plain C interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/conv3x3.py::_conv3x3_kernel (launched by
// conv3x3_pallas through the conv3x3 and gn_silu_conv3x3 entries).
//
// Computes out[b,y,x,:] = bias + sum over the nine taps (dy,dx) of
// act(x[b,y+dy,x+dx,:]) . w[:, :, dy+1, dx+1]^T, where act(t) =
// silu(float(t)*a[b,:] + s[b,:]) rounded to x's dtype (GroupNorm-apply +
// SiLU folded into the conv's input read) or the identity when a and s are
// null.  A tap outside the image contributes zero: the padding is zero
// *after* the activation, not silu(s).  a and s are per sample, so every
// staged pixel looks up its own image's vectors.  fp32 accumulation, bias
// added in fp32, one rounding to x's dtype.
//
// Weights arrive in nn.Conv2d's own OIHW storage (Cout, C, 3, 3).  The fp32
// path reads them there; the bf16 path first repacks them per call into
// [tap][Cout][C] scratch (see below) and keeps no cache between calls.
//
// What bounds it here: operations.  A call does 2*B*H*W*9*C*Cout flops on
// x, the weights and the output; at every UNet site (B = 32 frame-evals,
// H = W = 64..8, C = 320..2560, Cout = 320..1280) that is hundreds of flops
// per byte, above the card's ridge point, so the products must run on the
// tensor cores.  Two paths:
//
// * bf16 (every UNet site): an implicit GEMM, M = B*H*W output pixels,
//   N = Cout, K = 9*C, on wgmma with a cp.async ring for the weights; see
//   conv3x3_mma_kernel.  It needs C and Cout multiples of 8 and 16-byte
//   aligned bases; other bf16 inputs are refused.  TMA, clusters and a
//   coalesced epilogue are later work.
// * fp32: a scalar tiled kernel (fp32 FMAs), the exact reference path of the
//   card tests.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: one CTA per (64 pixels, 64 output channels); for each tap and each
// block of 16 input channels the activated, border-masked pixels and the
// weights are staged in shared memory and every thread accumulates a 4x4
// block of outputs.
// ---------------------------------------------------------------------------

constexpr int F_TM = 64, F_TN = 64, F_TK = 16, F_THREADS = 256;

template <bool PRE>
__global__ void __launch_bounds__(F_THREADS) conv3x3_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ s,
    const float* __restrict__ w, const float* __restrict__ bias, float* __restrict__ out,
    int M, int H, int W, int C, int Cout) {
  __shared__ __align__(16) float As[F_TK][F_TM + 4];
  __shared__ __align__(16) float Bs[F_TK][F_TN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * F_TM, n0 = blockIdx.y * F_TN;
  const int ty = tid / 16, tx = tid % 16;
  const int sk = tid % 16, sr = tid / 16;  // staging: channel, first row
  int pm[4], py[4], px[4], pb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pm[j] = m0 + sr + 16 * j;
    px[j] = pm[j] % W;
    py[j] = (pm[j] / W) % H;
    pb[j] = pm[j] / (W * H);
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += F_TK) {
      const int c = c0 + sk;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = pm[j] < M && c < C && (unsigned)(py[j] + dy) < (unsigned)H &&
                        (unsigned)(px[j] + dx) < (unsigned)W;
        float v = 0.f;
        if (ok) {
          v = x[(long long)(pm[j] + dy * W + dx) * C + c];
          if (PRE) {
            const float t = v * a[(long long)pb[j] * C + c] + s[(long long)pb[j] * C + c];
            v = t / (1.f + expf(-t));
          }
        }
        As[sk][sr + 16 * j] = v;
        const int n = n0 + sr + 16 * j;
        Bs[sk][sr + 16 * j] = (n < Cout && c < C) ? w[((long long)n * C + c) * 9 + tap] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < F_TK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) out[(long long)m * Cout + n] = acc[i][j] + bias[n];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path: implicit GEMM on wgmma (m64n128k16, A fragments in
// registers, B through a shared-memory descriptor).
//
// One CTA of two warpgroups per (128 consecutive output pixels of the
// flattened (b, y, x) order, 128 output channels), each warpgroup 64 pixels
// by 128 channels, two CTAs per SM.  The K loop runs over (block of 32 input
// channels, tap) steps:
//
// * Per channel block the activated pixels [m0 - W - 1, m0 + 128 + W + 1)
//   are staged once (the prologue is applied here, each pixel with its own
//   image's a and s, so SiLU is computed once per staged element and not
//   once per tap).  Tap (dy, dx) of output pixel m is then row m + dy*W + dx
//   of the staged pixels whenever that tap lies inside the image (same
//   image, flattened order), so each tap's A fragments are shifted ldmatrix
//   reads of shared memory.  Taps outside the image are zeroed in the
//   fragment registers from a 9-bit validity mask that each thread keeps for
//   its two rows; whatever the shifted row holds there (a neighbouring row
//   or image) is never used.  A shifted start is why A goes through
//   registers: a wgmma shared-memory operand cannot start at any row.
// * Per step the 128 x 32 weight tile of that tap comes from the packed
//   weights (below) with cp.async into a ring of NS tiles, NS - 1 steps
//   ahead, laid out as wgmma reads a K-major operand.
// * wgmma is asynchronous: a step starts its products and then, while they
//   run, copies a later step's weights and stages a ninth of the next
//   channel block's pixels into the other of two buffers.  One
//   __syncthreads per step orders all of it.
//
// The staging is written for few instructions per step: every per-thread
// address is set up once and advanced by additions; a row -> image table
// (rowimg) replaces a division by H*W per item; a and s of the images a CTA
// touches are copied per channel block into shared memory with cp.async, two
// blocks ahead; the raw pixel load is started one step before the activation
// that uses it.  The kernel is still far from its bound (PERF.md has its
// times): a step of this loop takes several times as long as its four
// products, and where the rest goes is an open question.
//
// Packed weights: pack_weights_kernel rewrites the OIHW parameter as
// [tap][Cout][C] into scratch memory before every launch, so that a weight
// tile is 16-byte runs.  It runs per call and caches nothing: a changed or
// re-loaded parameter is simply read again (the copy moves 2 x the weights,
// 59 MB at 2560 -> 1280, and is part of the wrapper's measured time).
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, KS = BK + 8, THREADS = 256, NS = 4;
constexpr int ROWS_PER_PASS = THREADS / (BK / 8);  // patch rows one pass of the CTA stages

__device__ __forceinline__ float silu_fast(float t) { return __fdividef(t, 1.f + __expf(-t)); }

// Weight tiles in shared memory, as wgmma reads a K-major operand without
// swizzle: 8 (n) x 8 (k) core matrices of 128 contiguous bytes (row n % 8 at
// 16 * (n % 8)), neighbours in k B_LBO bytes apart, in n B_SBO bytes apart.
constexpr int B_LBO = 128, B_SBO = (BK / 8) * B_LBO, B_TILE = (BN / 8) * B_SBO;  // bytes

__device__ __forceinline__ uint64_t b_descriptor(const void* smem) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(B_LBO >> 4) << 16) | ((uint64_t)(B_SBO >> 4) << 32);
}

// keeps a register live (and untouched) up to this point of the program
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// acc (64 x 128 per warpgroup, 16 n8 tiles of 4 floats a thread) +=
// A (64 x 16, this warp's 16 rows in a[4], the mma A fragment layout) .
// B (16 x 128, from shared memory through its descriptor)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[16][4], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),
        "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]),
        "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),
        "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wp, long long pairs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) wp[tap * pairs + i] = w[i * 9 + tap];
}

// nimg: images a CTA's staged pixels can span, (PR + H*W - 1) / (H*W) + 1
template <bool PRE>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ s, const __nv_bfloat16* __restrict__ wp,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int M, int H, int W, int C, int Cout, int nimg) {
  extern __shared__ uint4 smem_u4[];
  const int PR = BM + 2 * W + 2;
  char* Bs = reinterpret_cast<char*>(smem_u4);                             // [NS] weight tiles
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(Bs + NS * B_TILE);  // [2][PR][KS]
  float* ASs = reinterpret_cast<float*>(As + 2 * PR * KS);  // [2][nimg][a: 32, s: 32]
  int* rowimg = reinterpret_cast<int*>(ASs + 2 * nimg * 2 * BK);  // [PR] image of a row, or -1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;  // warps 0-3 and 4-7 are the two warpgroups: 64 rows each
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HW = H * W;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int p_base = m0 - W - 1;
  const int img0 = (p_base > 0 ? p_base : 0) / HW;  // first image the staged pixels touch
  const int nchunks = (C + BK - 1) / BK, T = nchunks * 9;
  const int rows_per_step = (PR + 8) / 9;  // patch rows staged per step

  // validity of the nine taps for this thread's two rows (g and g + 8)
  uint32_t mask[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + row0 + g + 8 * hh;
    uint32_t mk = 0;
    if (m < M) {
      const int xx = m % W, yy = (m / W) % H;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        if ((unsigned)(yy + dy) < (unsigned)H && (unsigned)(xx + dx) < (unsigned)W) mk |= 1u << tap;
      }
    }
    mask[hh] = mk;
  }

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ---- staging, set up once per thread -----------------------------------
  // pixels: this thread stages 8 channels (seg) of patch rows rsub, rsub + 64, ...
  const int seg = tid & 3, rsub = tid >> 2;
  // a and s of channel block `chunk` for the images img0 .. img0 + nimg - 1
  auto stage_as = [&](int chunk, int buf) {
    if (!PRE) return;
    for (int i = tid; i < nimg * 16; i += THREADS) {
      const int img = i >> 4, q = i & 15;  // q: float4 index, 0-7 of a, 8-15 of s
      const int b = img0 + img, c = chunk * BK + (q & 7) * 4;
      float* d = ASs + ((buf * nimg + img) * 2 * BK) + q * 4;
      if ((long long)b * HW < M && c < C) {
        cp_async16(d, (q < 8 ? a : s) + (long long)b * C + c);
      } else {
        *reinterpret_cast<uint4*>(d) = zero;
      }
    }
  };
  // raw x of this thread's item in patch row `row`; false when it is zero
  auto load_raw = [&](int chunk, int row, uint4& raw) -> bool {
    const int p = p_base + row, c = chunk * BK + seg * 8;
    const bool ok = p >= 0 && p < M && c < C;
    raw = ok ? *reinterpret_cast<const uint4*>(x + (long long)p * C + c) : zero;
    return ok;
  };
  // activate and store it into the pixel buffer of its channel block
  auto store_item = [&](int chunk, int row, uint4 val, bool ok) {
    if (PRE && ok) {
      const float4* ap = reinterpret_cast<const float4*>(
          ASs + (((chunk & 1) * nimg + rowimg[row]) * 2 * BK) + seg * 8);
      const float4 a0 = ap[0], a1 = ap[1], s0 = ap[BK / 4], s1 = ap[BK / 4 + 1];
      const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float sf[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint32_t wd[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wd[j]));
        wd[j] = pack_bf16(silu_fast(f.x * af[2 * j] + sf[2 * j]),
                          silu_fast(f.y * af[2 * j + 1] + sf[2 * j + 1]));
      }
      val = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    *reinterpret_cast<uint4*>(As + ((chunk & 1) * PR + row) * KS + seg * 8) = val;
  };
  // weights: this thread copies 16 bytes of rows bn and bn + 64 of every tile
  const int bn = tid >> 2;
  const bool bn_ok[2] = {n0 + bn < Cout, n0 + bn + 64 < Cout};
  const __nv_bfloat16* bsrc[2];  // tap 0, channel block 0
  uint32_t bdst[2];              // byte offset inside a tile
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int n = bn + 64 * k;
    bsrc[k] = wp + (long long)(bn_ok[k] ? n0 + n : 0) * C + seg * 8;
    bdst[k] = (n >> 3) * B_SBO + seg * B_LBO + (n & 7) * 16;
  }
  const long long tap_stride = (long long)Cout * C;
  long long boff = 0;  // of the next tile to copy: btap * tap_stride + bchunk * BK
  int bst = 0, btap = 0, bchunk = 0, bslot = 0;
  auto stage_b = [&]() {
    if (bst < T) {
      char* dst = Bs + bslot * B_TILE;
      const bool c_ok = bchunk * BK + seg * 8 < C;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (bn_ok[k] && c_ok) {
          cp_async16(dst + bdst[k], bsrc[k] + boff);
        } else {
          *reinterpret_cast<uint4*>(dst + bdst[k]) = zero;
        }
      }
    }
    ++bst;
    boff += tap_stride;
    if (++btap == 9) {
      btap = 0;
      ++bchunk;
      boff += BK - 9 * tap_stride;
    }
    bslot = bslot + 1 == NS ? 0 : bslot + 1;
  };

  // ---- prologue: a/s of the first two channel blocks, the row -> image
  // table, the first block's pixels, the first NS - 1 weight tiles ------------
  stage_as(0, 0);
  if (nchunks > 1) stage_as(1, 1);
  cp_async_commit();
  for (int r = tid; r < PR; r += THREADS) {
    const int p = p_base + r;
    rowimg[r] = (p >= 0 && p < M) ? p / HW - img0 : -1;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int row = rsub; row < PR; row += ROWS_PER_PASS) {
    uint4 raw;
    const bool ok = load_raw(0, row, raw);
    store_item(0, row, raw, ok);
  }
  for (int st = 0; st < NS - 1; ++st) {
    stage_b();
    cp_async_commit();
  }
  // A thread's first item of a step is loaded one step ahead (raw, raw_ok), so
  // that the load's latency passes behind a whole step.
  const bool mine = rsub < rows_per_step;
  uint4 raw = zero;
  bool raw_ok = false;
  if (mine && nchunks > 1 && rsub < PR) raw_ok = load_raw(1, rsub, raw);

  int chunk = 0, tap = 0;
  for (int st = 0; st < T; ++st) {
    cp_async_wait<NS - 2>();
    fence_proxy_async();
    __syncthreads();
    // this step's products: A fragments from the shifted pixel rows, masked,
    // B through its descriptor; they run while the staging below proceeds
    uint32_t af[BK / 16][4];
    {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const __nv_bfloat16* a_lane = As + ((chunk & 1) * PR + W + 1 + dy * W + dx + row0 +
                                          (lane & 15)) * KS + (lane >> 4) * 8;
      const uint32_t v0 = ((mask[0] >> tap) & 1u) ? 0xffffffffu : 0u;
      const uint32_t v1 = ((mask[1] >> tap) & 1u) ? 0xffffffffu : 0u;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        ldmatrix_x4(af[kk], a_lane + kk * 16);
        af[kk][0] &= v0;
        af[kk][1] &= v1;
        af[kk][2] &= v0;
        af[kk][3] &= v1;
      }
      wgmma_fence();
      const uint64_t desc = b_descriptor(Bs + (st % NS) * B_TILE);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64n128k16(acc, af[kk], desc + ((kk * 2 * B_LBO) >> 4));
      }
      wgmma_commit();
    }

    stage_b();  // the tile of step st + NS - 1
    // a and s two channel blocks ahead, into the buffer whose block's pixels
    // were all staged before this block began
    if (tap == 1 && chunk + 2 < nchunks) stage_as(chunk + 2, chunk & 1);
    cp_async_commit();
    if (chunk + 1 < nchunks) {  // this step's share of the next channel block's pixels
      const int row = tap * rows_per_step + rsub;
      if (mine && row < PR) store_item(chunk + 1, row, raw, raw_ok);
      for (int r = rsub + ROWS_PER_PASS; r < rows_per_step; r += ROWS_PER_PASS) {  // a very wide image
        const int late_row = tap * rows_per_step + r;
        if (late_row < PR) {
          uint4 late;
          const bool ok = load_raw(chunk + 1, late_row, late);
          store_item(chunk + 1, late_row, late, ok);
        }
      }
    }
    {  // the next step's first item
      const int ntap = tap == 8 ? 0 : tap + 1, nchunk = tap == 8 ? chunk + 1 : chunk;
      const int row = ntap * rows_per_step + rsub;
      if (mine && nchunk + 1 < nchunks && row < PR) raw_ok = load_raw(nchunk + 1, row, raw);
    }
    wgmma_wait_all();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      keep(af[kk][0]);
      keep(af[kk][1]);
      keep(af[kk][2]);
      keep(af[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      keep(acc[j][0]);
      keep(acc[j][1]);
      keep(acc[j][2]);
      keep(acc[j][3]);
    }
    if (++tap == 9) {
      tap = 0;
      ++chunk;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + row0 + g + 8 * hh;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n < Cout) {
        const float b0 = __bfloat162float(bias[n]), b1 = __bfloat162float(bias[n + 1]);
        *reinterpret_cast<uint32_t*>(out + (long long)m * Cout + n) =
            pack_bf16(acc[j][2 * hh] + b0, acc[j][2 * hh + 1] + b1);
      }
    }
  }
}

template <bool PRE>
int launch_f32(const void* x, const void* a, const void* s, const void* w, const void* bias,
               void* out, int M, int H, int W, int C, int Cout, cudaStream_t stream) {
  dim3 grid((M + F_TM - 1) / F_TM, (Cout + F_TN - 1) / F_TN);
  if (grid.y > 65535) return -3;
  conv3x3_f32_kernel<PRE><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out),
      M, H, W, C, Cout);
  return (int)cudaGetLastError();
}

template <bool PRE>
int launch_mma(const void* x, const void* a, const void* s, const void* w, void* wpack,
               const void* bias, void* out, int M, int H, int W, int C, int Cout,
               cudaStream_t stream) {
  const int patch_rows = BM + 2 * W + 2;
  const int nimg = PRE ? (patch_rows + H * W - 1) / (H * W) + 1 : 0;
  const size_t smem = (size_t)NS * B_TILE + sizeof(__nv_bfloat16) * KS * 2 * patch_rows +
                      sizeof(float) * 2 * nimg * 2 * BK + sizeof(int) * patch_rows;
  if (smem > 227 * 1024) return -5;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  if (grid.y > 65535) return -3;
  const long long pairs = (long long)Cout * C;
  pack_weights_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wpack), pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = conv3x3_mma_kernel<PRE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // two CTAs per SM at the widest sites need most of the SM's shared memory
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(s), static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      M, H, W, C, Cout, nimg);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C) contiguous; a, s null
// or fp32 (B, C) contiguous; w (Cout, C, 3, 3) contiguous and bias (Cout,)
// in x's dtype; wpack scratch of 9*Cout*C elements (bf16 only, else null);
// out (B, H, W, Cout).  Returns 0 or the CUDA error code of
// the launch; -1 bad dtype, -3 too large, -4 bf16 channel counts or bases
// the tensor-core path cannot read, -5 image too wide for shared memory.
extern "C" int conv3x3_fwd(const void* x, const void* a, const void* s, const void* w,
                           void* wpack, const void* bias, void* out, int dtype, int B, int H, int W, int C,
                           int Cout, void* stream) {
  const long long m = (long long)B * H * W;
  if (m <= 0 || m > 0x7fffff00LL) return -3;
  const int M = (int)m;
  const bool pre = a != nullptr && s != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return pre ? launch_f32<true>(x, a, s, w, bias, out, M, H, W, C, Cout, st)
               : launch_f32<false>(x, a, s, w, bias, out, M, H, W, C, Cout, st);
  }
  if (dtype == 1) {
    if (C % 8 != 0 || Cout % 8 != 0 || wpack == nullptr || !aligned16(x) || !aligned16(wpack) ||
        !aligned16(out) ||
        (pre && (!aligned16(a) || !aligned16(s)))) {
      return -4;
    }
    return pre ? launch_mma<true>(x, a, s, w, wpack, bias, out, M, H, W, C, Cout, st)
               : launch_mma<false>(x, a, s, w, wpack, bias, out, M, H, W, C, Cout, st);
  }
  return -1;
}
