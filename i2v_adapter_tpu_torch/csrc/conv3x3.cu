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
//   N = Cout, K = 9*C, on wgmma with both operands in shared memory: the
//   activated pixels in a zero-bordered layout, so that each tap is a
//   shifted descriptor, and the weights by TMA; see conv3x3_wgmma_kernel.
//   It needs C and Cout multiples of 8 and 16-byte aligned bases; other
//   bf16 inputs are refused.
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
// bf16 tensor-core path: implicit GEMM on wgmma, both operands from shared
// memory, weights by TMA.
//
// Output positions live in a zero-bordered order: image b's row y, column x
// is q = (b*(H+1) + y + 1) * Wp + x + 1 with Wp = W + 2, so every image row
// has a zero column on each side and consecutive images a zero row between
// them.  Tap (dy, dx) of position q is then q + dy*Wp + dx, inside the image
// or on a zero, with no mask.  The GEMM runs over the bordered positions
// (M_b = (B*(H+1) + 1) * Wp, about (H+1)(W+2)/(HW) of B*H*W: 1.05 at
// H = 64, 1.41 at H = 8) and the epilogue drops the border ones.
//
// One CTA per (BM = 128 bordered positions, BN output channels), BN = 256
// where Cout is a multiple of 256 or at least 512, else 160.  Three roles:
//
// * Products: two consumer warpgroups of 64 positions each.  Per step
//   (block of 64 input channels, tap) four m64nBNk16 wgmma each, A and B
//   from shared memory; one step's group stays in flight across the step
//   boundary (wait depth 1); a weight slot is released by mbarrier arrival
//   once both warpgroups' products of its step are done, a pixel buffer
//   once those of its block's last step are.
// * Weights: one producer warp issues the TMA loads of the BN x 64 tile of
//   each step (128-byte swizzle) from the packed weights (below) into a
//   ring of NS slots on mbarriers, NS steps ahead.
// * Pixels: three stager warps fill, per channel block, the positions
//   [q0 - Wp - 1, q0 + BM + Wp + 1) as 8 planes of 8 channels, position p
//   of plane k at 16*p + k*plane.  That is wgmma's no-swizzle K-major layout
//   (core matrices of 8 positions x 16 bytes, SBO 128 B, LBO the plane), so
//   tap (dy, dx)'s A operand is the same buffer read through a descriptor
//   whose start moves by 16 bytes per position.  The raw pixels (and the
//   block's a and s) arrive by cp.async, channels past C zero-filled, and
//   are then activated in place: the prologue per staged pixel, with its own
//   image's a and s; border positions stay zero.  Three buffers (two for
//   very wide images) let the copies of block k fly while block k - 1 is
//   activated and block k - 2 multiplied.
//
// Epilogue: fp32 bias, one rounding, through shared memory to coalesced
// 16-byte stores of the real positions' rows.
//
// What bounds it, read from variants of this source with parts switched
// off (PERF.md): at C = 320-640 the activation by three warps is on the
// critical path; at C >= 1280 the products and the shared-memory traffic.
//
// Packed weights: pack_weights_kernel rewrites the OIHW parameter as
// [tap][Cout][C] into scratch memory before every launch, the tensor the
// TMA tiles are cut from (a 2-D map of C x 9*Cout).  It runs per call and
// caches nothing: a changed or re-loaded parameter is simply read again (the
// copy moves 2 x the weights, 59 MB at 2560 -> 1280, and is part of the
// wrapper's measured time).
// ---------------------------------------------------------------------------

constexpr int BM = 128, BK = 64;
constexpr int CONSUMERS = 256;           // two warpgroups: the products
constexpr int STAGERS = 96;              // three warps of the producer warpgroup: the pixels
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup (one warp issues the TMA loads)
constexpr int MAX_NS = 6;

// silu(t) = t * sigmoid(t) = h + h * tanh(h), h = t / 2: one MUFU op and two
// FMA-pipe ops (the division form takes two MUFU ops and three more); its
// error, a few units in 2^-11 of |t|, is below the bf16 rounding that follows
__device__ __forceinline__ float silu_fast(float t) {
  const float h = 0.5f * t;
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

// wgmma descriptors (desc_plain, desc_sw128), mbar_arrive and tma_load_2d
// are in sm90_tiles.cuh: a no-swizzle K-major operand for the pixels, and a
// 128-byte-swizzled K-major tile of 64-channel rows for the weights

// D (64 x N, f32, registers) += A (64 x 16) . B (16 x N), both from shared
// memory through descriptors, both K-major
template <int N>
__device__ void wgmma_ss_acc(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss_acc<160>(float (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_ss_acc<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
__device__ __forceinline__ void stager_sync() { asm volatile("bar.sync 2, 96;\n" ::: "memory"); }

// [tap][Cout][C] <- OIHW: a thread reads 8 neighbouring (n, c) pairs' 72
// contiguous values (9 x 16 bytes) and writes one 16-byte run per tap
__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wp, long long pairs) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= pairs) return;
  uint4 in[9];
  const uint4* src = reinterpret_cast<const uint4*>(w + i * 9);
#pragma unroll
  for (int k = 0; k < 9; ++k) in[k] = __ldg(src + k);
  const uint16_t* v = reinterpret_cast<const uint16_t*>(in);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = (uint32_t)v[(2 * e) * 9 + tap] | ((uint32_t)v[(2 * e + 1) * 9 + tap] << 16);
    *reinterpret_cast<uint4*>(wp + tap * pairs + i) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

struct ConvParams {
  const __nv_bfloat16* x;
  const float* a;
  const float* s;
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int B, H, W, C, Cout;
  int wp, np, nchunks, ns;  // bordered row, staged positions (odd), channel blocks, ring slots
  int na;                   // pixel buffers (blocks staged ahead + 1)
  int nimg;                 // images the staged positions can touch
  int abuf, as, tabs, bars;  // shared-memory offsets (bytes): pixel buffers, a/s, tables, barriers
};

template <int BN, bool PRE>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                                                                    const ConvParams p) {
  constexpr int SLOT = BN * BK * 2;  // bytes of one weight tile
  constexpr int OS = BN + 8;         // elements per row of the output tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sm;                                         // [ns][SLOT]
  uint8_t* abuf = sm + p.abuf;                                // [na][8][np][16 B]
  float* as_tab = reinterpret_cast<float*>(sm + p.as);        // [2][nimg][a: 64, s: 64] of a block
  int* pixtab = reinterpret_cast<int*>(sm + p.tabs);          // [np] pixel of a staged position, or -1
  int* imgtab = pixtab + p.np;                                // [np] its image, from the first one
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.bars);  // [ns] weight tile landed
  uint64_t* empty = full + p.ns;                              // [ns] slot released (8 warps)
  uint64_t* a_full = empty + p.ns;                            // [na] pixel buffer staged (96 threads)
  uint64_t* a_empty = a_full + p.na;                          // [na] pixel buffer released (8 warps)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int T = p.nchunks * 9;
  const int plane = p.np * 16, abytes = 8 * plane;
  const int img0 = max(q0 - p.wp - 1, 0) / p.wp / (p.H + 1);

  if (tid == 0) {
    for (int i = 0; i < p.ns; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    for (int i = 0; i < p.na; ++i) {
      mbar_init(&a_full[i], STAGERS);
      mbar_init(&a_empty[i], CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  for (int j = tid; j < p.np; j += THREADS) {
    const int q = q0 - p.wp - 1 + j;
    int pix = -1, img = 0;
    if (q >= 0) {
      const int r = q / p.wp, xx = q - r * p.wp - 1;
      const int b = r / (p.H + 1), yy = r - b * (p.H + 1) - 1;
      if (b < p.B && (unsigned)yy < (unsigned)p.H && (unsigned)xx < (unsigned)p.W) {
        pix = (b * p.H + yy) * p.W + xx;
        img = b - img0;
      }
    }
    pixtab[j] = pix;
    imgtab[j] = img;
  }
  // zero the pixel buffers: border positions are never copied
  for (int i = tid; i < p.na * abytes / 16; i += THREADS) reinterpret_cast<uint4*>(abuf)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // ================= producer warpgroup
    if (warp == CONSUMERS / 32) {  // ---- weight tiles by TMA, NS steps ahead
      if (lane == 0) {
        int slot = 0, ph = 0, chunk = 0, tap = 0;
        for (int st = 0; st < T; ++st) {
          if (st >= p.ns) mbar_wait(&empty[slot], ph ^ 1);
          mbar_expect_tx(&full[slot], SLOT);
          tma_load_2d(ring + slot * SLOT, &wmap, &full[slot], chunk * BK, tap * p.Cout + n0);
          if (++tap == 9) {
            tap = 0;
            ++chunk;
          }
          if (++slot == p.ns) {
            slot = 0;
            ph ^= 1;
          }
        }
      }
      return;
    }
    // ---- the stagers.  Item i of a channel block is position i / 8, plane
    // i % 8: eight neighbouring threads copy one position's 128 contiguous
    // bytes, and a thread always handles the same plane (STAGERS % 8 == 0),
    // so it keeps that plane's a and s of one image in registers.  With
    // three pixel buffers, iteration k puts block k's raw pixels (and a, s)
    // in flight before it activates block k - 1's, so the loads' latency
    // passes behind the activation; with two, block k's buffer is only
    // released once block k - 1 is activated, so the order is the reverse.
    const int u = tid - CONSUMERS - 32, pl = u & 7;
    auto issue = [&](int k) {
      if (k >= p.na) mbar_wait(&a_empty[k % p.na], ((k - p.na) / p.na) & 1);  // block k - na's products are done
      uint8_t* dst = abuf + (k % p.na) * abytes;
      if (PRE) {  // a and s of the images the positions touch, 16 bytes per copy
        stager_sync();  // no stager still activates block k - 2 from this a/s buffer
        float* as_k = as_tab + (k & 1) * p.nimg * 2 * BK;
        for (int e = u; e < p.nimg * 2 * BK / 4; e += STAGERS) {
          const int img = e / (2 * BK / 4), w = (e - img * (2 * BK / 4)) * 4, c = k * BK + (w & (BK - 1));
          const int b = img0 + img;
          const bool ok = b < p.B && c < p.C;
          cp_async16(as_k + e * 4, (w < BK ? p.a : p.s) + (ok ? (long long)b * p.C + c : 0), ok);
        }
      }
      // channels past C are zero-filled; border positions are never
      // written: they stay zero from the start
      const int c = k * BK + pl * 8;
      for (int i = u; i < p.np * 8; i += STAGERS) {
        const int pix = pixtab[i >> 3];
        if (pix >= 0)
          cp_async16(dst + pl * plane + (i >> 3) * 16, p.x + (long long)pix * p.C + (c < p.C ? c : 0),
                           c < p.C);
      }
      cp_async_commit();
    };
    auto activate = [&](int kb) {
      uint8_t* dst = abuf + (kb % p.na) * abytes;
      if (PRE) stager_sync();  // every stager's copies of block kb's a/s have landed
      if (PRE && kb * BK + pl * 8 < p.C) {
        const float* as_kb = as_tab + (kb & 1) * p.nimg * 2 * BK + pl * 8;
        int cur = -1;
        float af[8], sf[8];
        for (int i = u; i < p.np * 8; i += STAGERS) {
          const int j = i >> 3;
          if (pixtab[j] < 0) continue;
          const int img = imgtab[j];
          if (img != cur) {
            cur = img;
            const float4* av = reinterpret_cast<const float4*>(as_kb + img * 2 * BK);
            const float4 a0 = av[0], a1 = av[1], s0 = av[BK / 4], s1 = av[BK / 4 + 1];
            af[0] = a0.x, af[1] = a0.y, af[2] = a0.z, af[3] = a0.w, af[4] = a1.x, af[5] = a1.y, af[6] = a1.z,
            af[7] = a1.w;
            sf[0] = s0.x, sf[1] = s0.y, sf[2] = s0.z, sf[3] = s0.w, sf[4] = s1.x, sf[5] = s1.y, sf[6] = s1.z,
            sf[7] = s1.w;
          }
          uint4* slot16 = reinterpret_cast<uint4*>(dst + pl * plane + j * 16);
          const uint4 val = *slot16;
          uint32_t wd[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wd[e]));
            wd[e] = pack_bf16(silu_fast(fmaf(f.x, af[2 * e], sf[2 * e])),
                              silu_fast(fmaf(f.y, af[2 * e + 1], sf[2 * e + 1])));
          }
          *slot16 = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
      fence_proxy_async();  // this thread's pixels, to the products' reads
      mbar_arrive(&a_full[kb % p.na]);
    };
    for (int k = 0; k <= p.nchunks; ++k) {
      if (p.na >= 3) {
        if (k < p.nchunks) issue(k);
        if (k > 0) {
          if (k < p.nchunks) {
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          activate(k - 1);
        }
      } else {
        if (k > 0) {
          cp_async_wait<0>();
          activate(k - 1);
        }
        if (k < p.nchunks) issue(k);
      }
    }
    return;
  }

  // ================= consumers: the products
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // this warpgroup's first row of tap (0, 0) in the staged positions
  const uint32_t a_row0 = (uint32_t)(wg * 64 + p.wp + 1) * 16;
  int slot = 0, ph = 0, prev = 0, chunk = 0, tap = 0;
  for (int st = 0; st < T; ++st) {
    if (tap == 0) mbar_wait(&a_full[chunk % p.na], (chunk / p.na) & 1);  // this block's pixels are staged
    mbar_wait(&full[slot], ph);
    wgmma_fence();
    {
      const int shift = (tap / 3 - 1) * p.wp + (tap % 3 - 1);
      const uint32_t a0 = smem_u32(abuf + (chunk % p.na) * abytes) + a_row0 + shift * 16;
      const uint32_t b0 = smem_u32(ring + slot * SLOT);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_acc<BN>(acc, desc_plain(a0 + 2 * kk * plane, plane, 128), desc_sw128(b0 + 32 * kk));
    }
    wgmma_commit();
    wgmma_wait_one();  // the previous step's products are done
    if (lane == 0) {
      if (st > 0) mbar_arrive(&empty[prev]);
      if (tap == 0 && chunk > 0) mbar_arrive(&a_empty[(chunk - 1) % p.na]);  // the previous block's last step
    }
    prev = slot;
    if (++slot == p.ns) {
      slot = 0;
      ph ^= 1;
    }
    if (++tap == 9) {
      tap = 0;
      ++chunk;
    }
  }
  wgmma_wait_all();
  keep(acc);
  consumer_sync();  // every product is done: the ring and the pixel buffers are free

  // accumulators + bias -> bf16 [BM][OS] tile, then the real positions' rows out
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(sm);
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t, n = n0 + col;
    const float b0 = n < p.Cout ? __bfloat162float(p.bias[n]) : 0.f;
    const float b1 = n + 1 < p.Cout ? __bfloat162float(p.bias[n + 1]) : 0.f;
    *reinterpret_cast<uint32_t*>(ot + row * OS + col) = pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(ot + (row + 8) * OS + col) = pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  consumer_sync();
  const int cpr = min(BN, p.Cout - n0) / 8;  // 16-byte pieces per row
  for (int idx = tid; idx < BM * cpr; idx += CONSUMERS) {
    const int r = idx / cpr, c8 = idx - r * cpr;
    const int pix = pixtab[r + p.wp + 1];
    if (pix >= 0)
      *reinterpret_cast<uint4*>(p.out + (long long)pix * p.Cout + n0 + c8 * 8) =
          *reinterpret_cast<const uint4*>(ot + r * OS + c8 * 8);
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

template <int BN, bool PRE>
int launch_wgmma(const void* x, const void* a, const void* s, const void* w, void* wpack,
                 const void* bias, void* out, int B, int H, int W, int C, int Cout, cudaStream_t stream) {
  ConvParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.a = static_cast<const float*>(a);
  p.s = static_cast<const float*>(s);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cout = Cout;
  p.wp = W + 2;
  p.np = BM + 2 * p.wp + 2;
  p.np |= 1;  // odd: the eight planes of a position fall in eight bank groups
  p.nchunks = (C + BK - 1) / BK;
  const long long mb = ((long long)B * (H + 1) + 1) * p.wp;  // bordered positions
  if (mb + BM + 2LL * p.wp + 2 > 0x7fffff00LL) return -3;
  constexpr int SLOT = BN * BK * 2;
  p.nimg = min(p.np / ((H + 1) * p.wp) + 2, B);
  const int out_tile = BM * (BN + 8) * 2, buffer = 8 * p.np * 16;
  // three pixel buffers and the deepest ring that fit beside the a/s, tables
  // and barriers; else two
  size_t smem = 0;
  bool fits = false;
  for (p.na = 3; p.na >= 2 && !fits; --p.na) {
    for (p.ns = MAX_NS; p.ns >= 4 - (3 - p.na) * 2; --p.ns) {  // at least 4 slots beside 3 buffers
      p.abuf = p.ns * SLOT;
      p.as = max(p.abuf + p.na * buffer, out_tile);
      p.tabs = p.as + 2 * p.nimg * 2 * BK * 4;
      p.bars = (p.tabs + 2 * p.np * 4 + 7) / 8 * 8;
      smem = (size_t)p.bars + (2 * p.ns + 2 * p.na) * 8 + 1024;  // + slack to align the base to 1024 bytes
      if (smem <= 227 * 1024) {
        fits = true;
        break;
      }
    }
    if (fits) break;
  }
  if (!fits) return -5;
  dim3 grid((unsigned)((mb + BM - 1) / BM), (Cout + BN - 1) / BN);
  if (grid.y > 65535) return -3;

  // the packed weights as a 2-D tensor (C, 9 * Cout), 64 x BN boxes, 128-byte swizzle
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -6;
  CUtensorMap wmap;
  cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)9 * Cout}, strides[1] = {(cuuint64_t)C * 2};
  cuuint32_t box[2] = {BK, BN}, estr[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wpack, dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -6;

  const long long pairs = (long long)Cout * C;
  pack_weights_kernel<<<(unsigned)((pairs / 8 + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wpack), pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = conv3x3_wgmma_kernel<BN, PRE>;
  static SmemLimit limit;
  if ((err = limit.raise(kern, smem)) != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, stream>>>(wmap, p);
  return (int)cudaGetLastError();
}

template <bool PRE>
int launch_mma(const void* x, const void* a, const void* s, const void* w, void* wpack,
               const void* bias, void* out, int B, int H, int W, int C, int Cout, cudaStream_t stream) {
  // n256 where Cout is a multiple of 256 or wide enough that a last, partial
  // tile costs less than the extra activations of n160 tiles (measured at
  // Cout = 640: 0.59 vs 0.66 ms)
  if (Cout % 256 == 0 || Cout >= 512) return launch_wgmma<256, PRE>(x, a, s, w, wpack, bias, out, B, H, W, C, Cout, stream);
  return launch_wgmma<160, PRE>(x, a, s, w, wpack, bias, out, B, H, W, C, Cout, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, H, W, C) contiguous; a, s null
// or fp32 (B, C) contiguous; w (Cout, C, 3, 3) contiguous and bias (Cout,)
// in x's dtype (bf16: 16-byte aligned); wpack scratch of 9*Cout*C elements
// (bf16 only, else null);
// out (B, H, W, Cout).  Returns 0 or the CUDA error code of
// the launch; -1 bad dtype, -3 too large, -4 bf16 channel counts or bases
// the tensor-core path cannot read, -5 image too wide for shared memory, -6
// no tensor map for the packed weights.
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
    if (C % 8 != 0 || Cout % 8 != 0 || wpack == nullptr || !aligned16(x) || !aligned16(w) || !aligned16(wpack) ||
        !aligned16(out) ||
        (pre && (!aligned16(a) || !aligned16(s)))) {
      return -4;
    }
    return pre ? launch_mma<true>(x, a, s, w, wpack, bias, out, B, H, W, C, Cout, st)
               : launch_mma<false>(x, a, s, w, wpack, bias, out, B, H, W, C, Cout, st);
  }
  return -1;
}
