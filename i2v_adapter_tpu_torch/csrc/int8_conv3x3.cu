// int8 3x3 stride-1 SAME convolution of channel-last activations for Hopper
// (sm_90a), quantising the activation on the fly; plain C interface for
// ctypes.
//
// Replaces: i2v_adapter_tpu/models/layers.py::int8_conv at stride 1 (an XLA
// conv there: the JAX package has no Pallas kernel for it; the port's
// PyTorch has no int8 convolution on CUDA).
//
// Computes, for x (B, H, W, C) in bf16 or fp32, wq (Cout, 3, 3, C) int8 (the
// per-output-channel quantised weights, i.e. the (Cout, 9*C) K-major
// matrix), a device scalar xs and ws, bias (Cout,) fp32:
//
//   y[b,y,x,n] = sum over the nine taps (dy, dx) and c of
//                round(x[b,y+dy,x+dx,c] / xs) * wq[n, dy+1, dx+1, c]
//
// exactly in int32 (a tap outside the image contributes zero), then either
// the raw sums or y * (xs * ws[n]) + bias[n] rounded to x's dtype.  The
// quantised activation never reaches device memory: the stager warps divide
// by xs (the correctly rounded IEEE quotient, see quantize()) and round half
// to even (__float2int_rn) while they stage the pixels, so the values equal
// torch.round(x.float() / xs) bit for bit.  A second entry point quantises
// the weights of every site of a model in one grouped launch
// (int8_quantize_weights_grouped, one read of each parameter), once per
// weights version; only the abs-max (one read of x) runs before the launch.
//
// What bounds it here: operations at the UNet sites (2*B*H*W*9*C*Cout int8
// operations against x, the weights and the output read and written once:
// hundreds of operations per byte), bytes at the widest decoder sites
// (C = Cout = 128 at 512 x 512).  In practice the staging bounds it: each
// pixel is staged and quantised once per N tile and about twice for the
// halo rows, by three warps.  With __fdiv_rn per value the stagers took
// half of the kernel's time; the branch-free division in quantize() brought
// them to within 10 % of a variant that does not quantise at all (variants
// of this source timed on an H100, PERF.md).
//
// Design: K4's (csrc/conv3x3.cu) implicit GEMM with s8 in place of bf16.
// M = output positions, N = Cout, K = 9*C.
//
// * Positions in a zero-bordered order, so that each of the nine taps is the
//   same shared-memory buffer read through a descriptor moved by whole
//   16-byte rows: an image row of TW columns is stored with one neighbour
//   column each side (pitch P = TW + 2), and consecutive images with a zero
//   row between them.  Images up to 128 wide are one strip (TW = W; the
//   neighbour columns are zeros, as in K4); wider ones are cut into strips
//   of 128 columns, each a virtual image of its own whose neighbour columns
//   hold the next strip's pixels, so the staged halo stays two rows of at
//   most 130 positions whatever W is.  Tap (dy, dx) of position q is
//   q + dy*P + dx, inside the image, on a neighbour pixel or on a zero.
// * Per channel block of 128 (one 128-byte row of K per position): the
//   pixels [q0 - P - 1, q0 + BM + P + 1) as 8 planes of 16 channels in
//   wgmma's no-swizzle K-major layout (core matrices of 8 positions x 16
//   bytes: SBO 128 B, LBO the plane), filled by three stager warps, eight
//   16-channel loads in flight per thread; border positions and channels
//   past C are written as zeros.
// * Weights by TMA: a 3-D map (C, 9, Cout) over wq, boxes of 128 channels x
//   1 tap x BN rows, 128-byte swizzle, zero fill past C; one producer warp
//   keeps a ring of NS slots full on mbarriers.
// * Products: two consumer warpgroups of 64 positions, four
//   wgmma.m64nBNk32.s32.s8.s8 per (block, tap) step, both operands from
//   shared memory, wait depth 1, slots and pixel buffers released by
//   mbarrier arrival.
// * Persistent: one CTA per SM walks the work items (128 positions x BN
//   channels, N fastest so neighbouring CTAs read the same pixels from L2);
//   each role keeps its ring counters across items, so the stagers and the
//   weight warp run ahead into the next item while the consumers finish one.
// * Epilogue straight from the accumulators: rows that are real output
//   positions are stored (int32, or dequantised in the plain version's
//   order: xs * ws, times y, plus bias, each rounded, then one rounding);
//   the stores drain while the next item's products run.
//
// Sums: |sum| <= 9 * C * 127^2 = 3.7e8 at C = 2560, below 2^31.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tiles.cuh"

namespace {

constexpr int BM = 128, BK = 128;         // positions per CTA; channels (bytes) per block
constexpr int CONSUMERS = 256;            // two warpgroups: the products
constexpr int STAGERS = 96;               // three warps of the producer warpgroup: the pixels
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup (one warp issues the TMA loads)
constexpr int MAX_NS = 6;
constexpr int MAX_TW = 128;               // widest strip


struct ConvParams {
  const void* x;
  const float* xs;
  const float* ws;
  const float* bias;
  void* out;
  int mode;  // 0 int32, 1 fp32, 2 bf16
  int B, H, W, C, Cout;
  int tw, pitch, strips;         // strip width, bordered row, strips per image row
  int np, nchunks, ns, na;       // staged positions (odd), channel blocks, ring slots, pixel buffers
  int items, ntiles;             // work items (M tiles x N tiles), N tiles
  int abuf, tabs, bars;          // shared-memory offsets (bytes): pixel buffers, table, barriers
};

// The scale of one launch: xs and its correctly rounded reciprocal.
struct Scale {
  float s, r;
};

// round(v / xs) half to even, v / xs the IEEE (correctly rounded) quotient
// that torch.round(x.float() / xs) rounds.  The quotient is formed without
// __fdiv_rn's per-value range check and branch: q = RN(v * r) with r =
// RN(1 / xs) is within an ulp of v / xs, the remainder v - q * xs is then
// exact in one fma, and RN(q + remainder * r) is the correctly rounded
// quotient (Markstein's theorem; it needs r correctly rounded, which
// __frcp_rn gives, and no overflow or underflow of the remainder, which the
// range |v| <= 127 * xs, xs >= 1e-12 / 127 rules out -- a denormal v gives
// a quotient that rounds to 0 either way).
__device__ __forceinline__ int quantize(float v, Scale k) {
  const float q = __fmul_rn(v, k.r);
  const float e = __fmaf_rn(-q, k.s, v);
  return __float2int_rn(__fmaf_rn(e, k.r, q));
}

// four values -> four int8 in one 32-bit word
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, Scale k) {
  return (uint32_t)(quantize(a, k) & 0xff) | ((uint32_t)(quantize(b, k) & 0xff) << 8) |
         ((uint32_t)(quantize(c, k) & 0xff) << 16) | ((uint32_t)(quantize(d, k) & 0xff) << 24);
}

template <typename T>
struct Loader;
template <>
struct Loader<__nv_bfloat16> {  // 16 channels = 32 bytes
  uint4 r[2];
  __device__ __forceinline__ void load(const void* base, long long e) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + e);
    r[0] = __ldg(src);
    r[1] = __ldg(src + 1);
  }
  __device__ __forceinline__ uint4 quant(Scale k) const {
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(r);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f0 = __bfloat1622float2(v[2 * e]), f1 = __bfloat1622float2(v[2 * e + 1]);
      o[e] = quant4(f0.x, f0.y, f1.x, f1.y, k);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};
template <>
struct Loader<float> {  // 16 channels = 64 bytes
  float4 r[4];
  __device__ __forceinline__ void load(const void* base, long long e) {
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = __ldg(src + i);
  }
  __device__ __forceinline__ uint4 quant(Scale k) const {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = quant4(r[e].x, r[e].y, r[e].z, r[e].w, k);
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// the pixel of bordered position q (or -1), and whether it is an output of
// this strip (a real pixel in columns [0, TW) of its strip)
__device__ __forceinline__ int pixel_of(const ConvParams& p, int q, bool* is_out) {
  *is_out = false;
  if (q < 0) return -1;
  const int r = q / p.pitch, cc = q - r * p.pitch - 1;
  const int v = r / (p.H + 1), y = r - v * (p.H + 1) - 1;
  const int b = v / p.strips, s = v - b * p.strips;
  const int x = s * p.tw + cc;
  if (b >= p.B || (unsigned)y >= (unsigned)p.H || (unsigned)x >= (unsigned)p.W) return -1;
  *is_out = cc >= 0 && cc < p.tw;
  return (b * p.H + y) * p.W + x;
}

__device__ __forceinline__ void stager_sync() { asm volatile("bar.sync 1, 96;\n" ::: "memory"); }

// Persistent: each CTA walks the work items (M tile, N tile), N fastest, in
// steps of gridDim.x.  Every role keeps its ring counters across items, so
// the stagers fill the next item's pixel buffers and the producer warp its
// weight slots while the consumers still multiply or store the current one.
template <int BN, typename In>
__global__ void __launch_bounds__(THREADS, 1) int8_conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                                                                         const ConvParams p) {
  constexpr int SLOT = BN * BK;  // bytes of one weight tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sm;                                         // [ns][SLOT]
  uint8_t* abuf = sm + p.abuf;                                // [na][8][np][16 B]
  int* pixtab = reinterpret_cast<int*>(sm + p.tabs);          // [np] the stagers' item: pixel of a position, or -1
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.bars);  // [ns] weight tile landed
  uint64_t* empty = full + p.ns;                              // [ns] slot released (8 warps)
  uint64_t* a_full = empty + p.ns;                            // [na] pixel buffer staged (96 threads)
  uint64_t* a_empty = a_full + p.na;                          // [na] pixel buffer released (8 warps)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = p.nchunks * 9;
  const int plane = p.np * 16, abytes = 8 * plane;

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
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // ================= producer warpgroup
    if (warp == CONSUMERS / 32) {  // ---- weight tiles by TMA, NS steps ahead
      if (lane == 0) {
        int slot = 0, ph = 0, it = 0;
        for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
          const int n0 = (item % p.ntiles) * BN;
          for (int st = 0; st < T; ++st, ++it) {
            if (it >= p.ns) mbar_wait(&empty[slot], ph ^ 1);
            mbar_expect_tx(&full[slot], SLOT);
            tma_load_3d(ring + slot * SLOT, &wmap, &full[slot], (st / 9) * BK, st % 9, n0);
            if (++slot == p.ns) {
              slot = 0;
              ph ^= 1;
            }
          }
        }
      }
      return;
    }
    // ---- the stagers.  Item i of a channel block is position i / 8, plane
    // i % 8 (16 channels); a thread always handles the same plane
    // (STAGERS % 8 == 0).  BATCH items per round: every load is in flight
    // before the first is quantised.  Border positions and channels past C
    // are written as zeros.
    // eight 32-byte bf16 loads in flight per thread, four 64-byte fp32 ones
    // (eight spill at n128 / n160)
    constexpr int BATCH = sizeof(In) == 2 ? 8 : 4;
    const int u = tid - CONSUMERS - 32, pl = u & 7;
    const Scale sc = {*p.xs, __frcp_rn(*p.xs)};
    int kb = 0;  // channel blocks staged so far, over all items
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int q0 = (item / p.ntiles) * BM;
      stager_sync();  // every stager is done with the previous item's table
      for (int j = u; j < p.np; j += STAGERS) {
        bool is_out;
        pixtab[j] = pixel_of(p, q0 - p.pitch - 1 + j, &is_out);
      }
      stager_sync();
      for (int k = 0; k < p.nchunks; ++k, ++kb) {
        if (kb >= p.na) mbar_wait(&a_empty[kb % p.na], ((kb - p.na) / p.na) & 1);  // its products are done
        uint8_t* dst = abuf + (kb % p.na) * abytes + pl * plane;
        const int c = k * BK + pl * 16;
        const bool live = c < p.C;
        for (int i0 = u; i0 < p.np * 8; i0 += BATCH * STAGERS) {
          Loader<In> l[BATCH];
          int pix[BATCH];
#pragma unroll
          for (int e = 0; e < BATCH; ++e) {
            const int i = i0 + e * STAGERS;
            pix[e] = (live && i < p.np * 8) ? pixtab[i >> 3] : -1;
            if (pix[e] >= 0) l[e].load(p.x, (long long)pix[e] * p.C + c);
          }
#pragma unroll
          for (int e = 0; e < BATCH; ++e) {
            const int i = i0 + e * STAGERS;
            if (i < p.np * 8)
              *reinterpret_cast<uint4*>(dst + (i >> 3) * 16) = pix[e] >= 0 ? l[e].quant(sc) : make_uint4(0, 0, 0, 0);
          }
        }
        fence_proxy_async();  // this thread's pixels, to the products' reads
        mbar_arrive(&a_full[kb % p.na]);
      }
    }
    return;
  }

  // ================= consumers: the products and the epilogue
  const int wg = warp >> 2, t = lane & 3;
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  // this warpgroup's first row of tap (0, 0) in the staged positions
  const uint32_t a_row0 = (uint32_t)(wg * 64 + p.pitch + 1) * 16;
  const float xs = p.mode != 0 ? *p.xs : 0.f;
  int acc[BN / 2];
  int slot = 0, ph = 0, prev = 0, kb = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int q0 = (item / p.ntiles) * BM, n0 = (item % p.ntiles) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int tap = 0;
    for (int st = 0; st < T; ++st) {
      if (tap == 0) mbar_wait(&a_full[kb % p.na], (kb / p.na) & 1);  // this block's pixels are staged
      mbar_wait(&full[slot], ph);
      wgmma_fence();
      {
        const int shift = (tap / 3 - 1) * p.pitch + (tap % 3 - 1);
        const uint32_t a0 = smem_u32(abuf + (kb % p.na) * abytes) + a_row0 + shift * 16;
        const uint32_t b0 = smem_u32(ring + slot * SLOT);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, desc_plain(a0 + 2 * kk * plane, plane, 128), desc_sw128(b0 + 32 * kk));
      }
      wgmma_commit();
      wgmma_wait_one();  // the previous step's products are done
      if (lane == 0) {
        if (st > 0) mbar_arrive(&empty[prev]);
        if (tap == 0 && st > 0) mbar_arrive(&a_empty[(kb - 1) % p.na]);  // the previous block's last step
      }
      prev = slot;
      if (++slot == p.ns) {
        slot = 0;
        ph ^= 1;
      }
      if (++tap == 9) {
        tap = 0;
        ++kb;
      }
    }
    wgmma_wait_all();
    keep(acc);
    if (lane == 0) {  // this item's last weight slot and pixel buffer
      mbar_arrive(&empty[prev]);
      mbar_arrive(&a_empty[(kb - 1) % p.na]);
    }

    // epilogue: thread (g, t) of warp w holds positions 16w + g and
    // 16w + g + 8, channels 8j + 2t and 8j + 2t + 1 of each 8-channel block
    // j; the stores drain while the next item's products run
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bool is_out;
      const int pix = pixel_of(p, q0 + row + 8 * hh, &is_out);
      if (pix < 0 || !is_out) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= p.Cout) continue;  // Cout is even: n + 1 < Cout too
        const int v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        const long long o = (long long)pix * p.Cout + n;
        if (p.mode == 0) {
          *reinterpret_cast<int2*>(static_cast<int*>(p.out) + o) = make_int2(v0, v1);
          continue;
        }
        float f0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(xs, p.ws[n]));
        float f1 = __fmul_rn(__int2float_rn(v1), __fmul_rn(xs, p.ws[n + 1]));
        if (p.bias != nullptr) {
          f0 = __fadd_rn(f0, p.bias[n]);
          f1 = __fadd_rn(f1, p.bias[n + 1]);
        }
        if (p.mode == 1) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(f0, f1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(f0, f1);
        }
      }
    }
  }
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

template <int BN, typename In>
int launch(const void* wq, ConvParams p, cudaStream_t stream) {
  p.tw = p.W <= MAX_TW ? p.W : MAX_TW;
  p.strips = (p.W + p.tw - 1) / p.tw;
  p.pitch = p.tw + 2;
  p.np = (BM + 2 * p.pitch + 2) | 1;  // odd: the eight planes of a position fall in eight bank groups
  p.nchunks = (p.C + BK - 1) / BK;
  // bordered positions: a zero row, then per virtual image (image, strip) H
  // rows and a zero row, each row ``pitch`` positions
  const long long mb = ((long long)p.B * p.strips * (p.H + 1) + 1) * p.pitch;
  if (mb + BM + 2LL * p.pitch + 2 > 0x7fffff00LL) return -3;
  constexpr int SLOT = BN * BK;
  const int buffer = 8 * p.np * 16;
  // three pixel buffers and the deepest ring that fit beside the tables and
  // barriers; else two
  size_t smem = 0;
  bool fits = false;
  for (p.na = 3; p.na >= 2 && !fits; --p.na) {
    for (p.ns = MAX_NS; p.ns >= 4 - (3 - p.na) * 2; --p.ns) {  // at least 4 slots beside 3 buffers
      p.abuf = p.ns * SLOT;
      p.tabs = p.abuf + p.na * buffer;
      p.bars = (p.tabs + p.np * 4 + 7) / 8 * 8;
      smem = (size_t)p.bars + (2 * p.ns + 2 * p.na) * 8 + 1024;  // + slack to align the base to 1024 bytes
      if (smem <= 227 * 1024) {
        fits = true;
        break;
      }
    }
    if (fits) break;
  }
  if (!fits) return -5;
  p.ntiles = (p.Cout + BN - 1) / BN;
  const long long items = (mb + BM - 1) / BM * p.ntiles;
  if (items > 0x7fffffffLL) return -3;
  p.items = (int)items;
  const int grid = p.items < sm_count() ? p.items : sm_count();

  // wq (Cout, 3, 3, C) as a 3-D int8 tensor (C, 9, Cout): boxes of 128
  // channels x 1 tap x BN rows, 128-byte swizzle, zeros past C
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -6;
  CUtensorMap wmap;
  cuuint64_t dims[3] = {(cuuint64_t)p.C, 9, (cuuint64_t)p.Cout};
  cuuint64_t strides[2] = {(cuuint64_t)p.C, (cuuint64_t)9 * p.C};
  cuuint32_t box[3] = {BK, 1, BN}, estr[3] = {1, 1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wq), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -6;

  auto kern = int8_conv3x3_wgmma_kernel<BN, In>;
  static SmemLimit limit;
  cudaError_t err = limit.raise(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, stream>>>(wmap, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bn(const void* wq, const ConvParams& p, cudaStream_t stream) {
  // n256 where Cout is a multiple of 256 or at least 512 (K4's rule), n160
  // where it divides Cout (320), else n128
  if (p.Cout % 256 == 0 || p.Cout >= 512) return launch<256, T>(wq, p, stream);
  if (p.Cout % 160 == 0) return launch<160, T>(wq, p, stream);
  return launch<128, T>(wq, p, stream);
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// The weight quantiser, grouped: one launch quantises every int8 site of a
// model (the serving pipeline runs it once per weights version, not per
// conv call).  A table entry per site: an OIHW parameter (Cout, C, 3, 3) in
// bf16 or fp32, whose 9*C values per output channel are contiguous, and the
// site's outputs wq (Cout, 3, 3, C) int8 and ws (Cout,) fp32.  One CTA per
// output channel n of any site (the CTA finds its site by a binary search of
// the entries' first rows):
//
//   ws[n] = max |w[n]| / 127                        (IEEE division)
//   wq[n, ky, kx, c] = round(w[n, c, ky, kx] / ws[n])  (half to even)
//
// equal bit for bit to ops/int8.py::quantize_weight_plain.  The row is read
// once, 16 bytes per thread where the row is 16-byte aligned, into shared
// memory as fp32 while each thread keeps its running max |w|; a shuffle and
// shared-memory reduction gives the row's max; the quotient is quantize()'s
// branch-free correctly rounded division (its range condition |w| <= 127 *
// ws holds by construction; a row whose values are all below ~1e-30 would
// meet a subnormal remainder, which no trained weight has).  The outputs are
// written in (tap, c) order, consecutive threads on consecutive bytes,
// reading the staged row at a stride of 9 floats (odd: no bank conflict).
//
// What bounds it: bytes (each parameter read once, one int8 byte and the
// scales written); the UNet's and the VAE decoder's int8 sites hold about
// 0.6 G values at SD1.5 width.
struct QuantEntry {
  const void* w;   // OIHW parameter
  int8_t* wq;      // (Cout, 9*C) int8
  float* ws;       // (Cout,) fp32
  int row0;        // the entry's first row among all entries' rows
  int cout, c;
  int in_dtype;    // 0 float32, 1 bfloat16
  int vec;         // 1: the rows are 16-byte aligned (vector loads)
  int pad;
};

constexpr int QTHREADS = 256;

__global__ void __launch_bounds__(QTHREADS) quantize_weights_grouped_kernel(const QuantEntry* __restrict__ table,
                                                                              int n_entries) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red[QTHREADS / 32];
  const int r = blockIdx.x;
  int lo = 0, hi = n_entries - 1;
  while (lo < hi) {  // the last entry whose first row is <= r
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].row0 <= r) lo = mid; else hi = mid - 1;
  }
  const QuantEntry e = table[lo];
  const int n = r - e.row0, K = 9 * e.c;
  float m = 0.f;
  if (e.in_dtype == 1) {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(e.w) + (long long)n * K;
    if (e.vec) {
      for (int v = threadIdx.x; v < K / 8; v += QTHREADS) {
        const uint4 u = reinterpret_cast<const uint4*>(src)[v];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          row[8 * v + 2 * j] = f.x;
          row[8 * v + 2 * j + 1] = f.y;
          m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    } else {
      for (int i = threadIdx.x; i < K; i += QTHREADS) {
        const float f = __bfloat162float(src[i]);
        row[i] = f;
        m = fmaxf(m, fabsf(f));
      }
    }
  } else {
    const float* src = static_cast<const float*>(e.w) + (long long)n * K;
    if (e.vec) {
      for (int v = threadIdx.x; v < K / 4; v += QTHREADS) {
        const float4 f = reinterpret_cast<const float4*>(src)[v];
        reinterpret_cast<float4*>(row)[v] = f;
        m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)), fmaxf(fabsf(f.z), fabsf(f.w))));
      }
    } else {
      for (int i = threadIdx.x; i < K; i += QTHREADS) {
        row[i] = src[i];
        m = fmaxf(m, fabsf(src[i]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();  // also publishes the staged row
  m = red[0];
#pragma unroll
  for (int i = 1; i < QTHREADS / 32; ++i) m = fmaxf(m, red[i]);
  const float s = __fdiv_rn(m, 127.f);
  if (threadIdx.x == 0) e.ws[n] = s;
  const Scale k{s, __frcp_rn(s)};
  int8_t* out = e.wq + (long long)n * K;
  for (int o = threadIdx.x; o < K; o += QTHREADS) {  // o = (ky * 3 + kx) * C + c
    const int tap = o / e.c, c = o - tap * e.c;
    out[o] = (int8_t)quantize(row[c * 9 + tap], k);
  }
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16; mode: 0 = int32 out, 1 = fp32, 2 =
// bf16 (dequantised).  x (B, H, W, C) contiguous; wq (Cout, 3, 3, C) int8
// contiguous; xs a device scalar, ws (Cout,) fp32, bias (Cout,) fp32 or null;
// out (B, H, W, Cout).  Returns 0 or the CUDA error code of the launch; -1
// bad dtype or mode, -3 too large, -4 C not a multiple of 16, Cout not a
// multiple of 8 or a base not 16-byte aligned, -5 no shared-memory layout
// fits, -6 no tensor map for the weights.
extern "C" int int8_conv3x3(const void* x, const void* wq, const void* xs, const void* ws, const void* bias,
                            void* out, int in_dtype, int mode, int B, int H, int W, int C, int Cout,
                            void* stream) {
  const long long m = (long long)B * H * W;
  if (m <= 0 || Cout <= 0 || m > 0x7fffff00LL) return -3;
  if (in_dtype < 0 || in_dtype > 1 || mode < 0 || mode > 2 || xs == nullptr || (mode != 0 && ws == nullptr))
    return -1;
  if (C % 16 != 0 || Cout % 8 != 0 || !aligned16(x) || !aligned16(wq) || !aligned16(out)) return -4;
  ConvParams p;
  p.x = x;
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.mode = mode;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cout = Cout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_dtype == 1 ? launch_bn<__nv_bfloat16>(wq, p, st) : launch_bn<float>(wq, p, st);
}

// table: n_entries QuantEntry records in device memory (the wrapper builds
// them), rows the sum of their Cout, max_k the largest 9*C.  Returns 0 or the
// CUDA error code of the launch; -3 bad sizes.
extern "C" int int8_quantize_weights_grouped(const void* table, int n_entries, int rows, int max_k, void* stream) {
  if (n_entries <= 0 || rows <= 0 || max_k <= 0) return -3;
  const size_t smem = (size_t)max_k * sizeof(float);
  if (smem > 227 * 1024) return -3;
  auto kern = quantize_weights_grouped_kernel;
  static SmemLimit limit;
  cudaError_t err = limit.raise(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<rows, QTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(static_cast<const QuantEntry*>(table),
                                                                    n_entries);
  return (int)cudaGetLastError();
}
