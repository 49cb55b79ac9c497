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
// * bf16 (every UNet site): wgmma products fed by a TMA ring of K/V tiles,
//   see flash_fwd_wgmma_kernel below.  It needs 16-byte rows (head dim and
//   strides multiples of 8, aligned bases) that a tensor map can describe;
//   other bf16 inputs are refused.  Measured on an H100 (PERF.md): with the
//   exp2s or the P.V products switched off the D = 40 loop took as long,
//   while more query rows per CTA (fewer K/V tile reads from L2 per row)
//   made it faster, hence four warpgroups at D <= 48; what bounds the rest
//   is an open question there.
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

#include "sm90_tiles.cuh"

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
  static SmemLimit limit;
  cudaError_t err = limit.raise(kern, smem);
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
// bf16 tensor-core path: wgmma fed by a TMA ring (tile layout, descriptors
// and register order in sm90_tiles.cuh).
//
// One CTA of WGS warpgroups per (64*WGS query rows, batch*head); each
// warpgroup owns 64 rows.  The Q tile is loaded once; K and V tiles of BKV
// keys stream through a ring of NS stages, each stage completing on its own
// mbarrier.  Thread 0 issues a stage's TMA boxes right after the barrier
// that frees it, NS - 2 tiles ahead, and no other thread spends an
// instruction on loads.  Per tile:
//   S = Q K^T   wgmma m64nBKVk16, A = Q and B = K from shared memory, both
//               K-major as stored ([token][d]);
//   softmax     on the S accumulators in registers (row max and row sum
//               over the 4 lanes that share a row);
//   O += P V    wgmma m64nDPk16, A = P repacked to bf16 in registers, B = V
//               through the transpose bit (MN-major), read as stored.
// The softmax of tile it runs while the tensor cores do P.V of tile it - 1
// (see the loop).
// Under the static offset (serving's flash_static_max) the loop has no row
// max and no rescale: STATIC is a template parameter.
// The head dim is padded to a multiple of 16 (40 -> 48): the last 16-column
// box reaches past d and TMA zero-fills it; a 64-column pad with a 128-byte
// swizzle would cost a third more Q.K^T steps at D = 40.  Rows past nq or nk
// are zero-filled the same way and masked.  Only the head dim must be
// contiguous; the tensor maps carry every other stride.  blockIdx.y runs
// over (kv batch, head, frame) with the frame fastest, so the kv_repeat
// frames that read one K/V run side by side and find it in L2.
// ---------------------------------------------------------------------------

template <int DP>
struct FwdTile {
  // warpgroups of 64 query rows: more rows share each K/V tile where the
  // registers allow (at D = 40 the K/V traffic from L2 sets the pace)
  static constexpr int WGS = DP <= 48 ? 4 : 2;
  static constexpr int BKV = 64;                 // keys per tile
  static constexpr int NS = DP <= 96 ? 4 : 3;    // ring stages
  static constexpr int THREADS = WGS * 128;
  // CTAs per SM the registers are sized for: one at D = 160, whose O
  // accumulator alone is 80 registers a thread
  static constexpr int MINB = (WGS <= 2 && DP <= 96) ? 2 : 1;
  static constexpr int BQ = WGS * 64;
  static constexpr int QBYTES = BQ * DP * 2;
  static constexpr int TILE = BKV * DP * 2;     // bytes of one K or V tile
  // + barriers, + slack to align the tiles to 1024 bytes
  static constexpr size_t SMEM = (size_t)QBYTES + 2u * NS * TILE + 8 * (NS + 1) + 1024;
};

// The online softmax of one score tile s (register order, rows g and g + 8
// of this warp's 16), in place: s becomes p.  Under the static offset p =
// exp2(s * scale - static_max); otherwise the running max m moves and
// alpha says by how much the earlier sums shrink.  The row sums run in four
// partial sums per row (ls[i % 8]: rows g, g, g+8, g+8, g, g, g+8, g+8), so
// the adds do not form one long chain.
template <int N, bool STATIC>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int kbase, int nk, int t, float scale_log2, float static_max) {
  if (kbase + 2 * N > nk) {  // keys past nk
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (kbase + 8 * (i >> 2) + 2 * t + (i & 1) >= nk) s[i] = NEG_BIG;
    }
  }
  float ls[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (STATIC) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = exp2_ftz(fmaf(s[i], scale_log2, -static_max));
      ls[i & 7] += s[i];
    }
  } else {
    float mt[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] *= scale_log2;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = exp2_ftz(s[i] - m[(i >> 1) & 1]);
      ls[i & 7] += s[i];
    }
  }
  l[0] += (ls[0] + ls[1]) + (ls[4] + ls[5]);
  l[1] += (ls[2] + ls[3]) + (ls[6] + ls[7]);
}

template <int DP, bool STATIC>
__global__ void __launch_bounds__(FwdTile<DP>::THREADS, FwdTile<DP>::MINB) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, TileCoord cq, TileCoord ck, TileCoord cv,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int nq, int nk, int heads, int d,
    int kv_repeat, long long sob, long long son, long long soh, float scale_log2, float static_max) {
  using T = FwdTile<DP>;
  constexpr int BKV = T::BKV, NS = T::NS, BQ = T::BQ, TILE = T::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [DP/16][BQ][16]
  uint8_t* ks = qs + T::QBYTES;        // [NS][DP/16][BKV][16]
  uint8_t* vs = ks + NS * TILE;        // [NS][DP/16][BKV][16]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NS * TILE);  // [NS] K/V stages, [NS] Q

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.y / kv_repeat;
  const int bkv = kvh / heads, h = kvh - bkv * heads;
  const int bq = bkv * kv_repeat + (blockIdx.y - kvh * kv_repeat);
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (nk + BKV - 1) / BKV;

  if (tid == 0) {
    for (int i = 0; i <= NS; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_kv = [&](int tile) {
    const int slot = tile % NS;
    mbar_expect_tx(&bar[slot], 2 * TILE);
    tma_tile<DP, BKV>(ks + slot * TILE, &tk, &bar[slot], ck, tile * BKV, h, bkv);
    tma_tile<DP, BKV>(vs + slot * TILE, &tv, &bar[slot], cv, tile * BKV, h, bkv);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar[NS], T::QBYTES);
    tma_tile<DP, BQ>(qs, &tq, &bar[NS], cq, q0, h, bq);
    for (int tile = 0; tile < NS - 1 && tile < ntiles; ++tile) load_kv(tile);
  }

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  // Q rows of this warpgroup, K-major; K K-major; V MN-major (transposed)
  const uint64_t qdesc = smem_desc(qs + wg * 64 * SLICE_ROW, 16, 8 * SLICE_ROW);
  const uint64_t kdesc = smem_desc(ks, 16, 8 * SLICE_ROW);
  const uint64_t vdesc = smem_desc(vs, BKV * SLICE_ROW, 8 * SLICE_ROW);
  auto issue_s = [&](float (&s)[BKV / 2], int slot) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<BKV>(s, desc_add(qdesc, kk * BQ * SLICE_ROW),
                    desc_add(kdesc, slot * TILE + kk * BKV * SLICE_ROW), kk);
    }
  };
  // O += P V, P rounded to bf16 (p.astype(v.dtype)); the row sums keep the
  // unrounded p.  Rescales O first (the dynamic max moved).
  auto issue_pv = [&](const uint32_t (&pa)[BKV / 16][4], int slot) {
    if (!STATIC) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wgmma_rs_tb<DP>(oacc, pa[kk], desc_add(vdesc, slot * TILE + kk * 16 * SLICE_ROW), 1);
    }
  };

  // Software pipeline per warpgroup: iteration it issues S of tile it and
  // P.V of tile it - 1 together, then runs the softmax of tile it while
  // P.V runs on the tensor cores.  One score buffer suffices: P of tile
  // it - 1 is already packed into pa.
  float s[BKV / 2];
  uint32_t pa[BKV / 16][4];
  mbar_wait(&bar[NS], 0);
  mbar_wait(&bar[0], 0);
  wgmma_fence();
  issue_s(s, 0);
  wgmma_commit();
  wgmma_wait_all();
  keep(s);
  softmax_tile<BKV / 2, STATIC>(s, m, l, alpha, 0, nk, t, scale_log2, static_max);
  to_a_frags<BKV / 16>(pa, s);
  // every iteration issues the same two wgmma groups, so the waits below
  // are exact and the compiler adds none of its own
  for (int it = 1; it < ntiles; ++it) {
    // every warpgroup is done with tile it - 2 (its P.V completed in
    // iteration it - 1), whose stage the next load reuses
    __syncthreads();
    if (tid == 0 && it + NS - 2 < ntiles) load_kv(it + NS - 2);
    const int slot = it % NS;
    mbar_wait(&bar[slot], (it / NS) & 1);
    wgmma_fence();
    issue_s(s, slot);
    wgmma_commit();
    issue_pv(pa, (it - 1) % NS);
    wgmma_commit();
    wgmma_wait_one();  // S done
    keep(s);
    softmax_tile<BKV / 2, STATIC>(s, m, l, alpha, it * BKV, nk, t, scale_log2, static_max);
    wgmma_wait_all();  // P.V of tile it - 1 done: pa and oacc are free
    keep(oacc);
    keep(pa);
    to_a_frags<BKV / 16>(pa, s);
  }
  issue_pv(pa, (ntiles - 1) % NS);
  wgmma_commit();
  wgmma_wait_all();
  keep(oacc);

  const int bh = bq * heads + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
    if (row < nq) {
      if (lse != nullptr && t == 0) {
        lse[(long long)bh * nq + row] = (STATIC ? static_max : m[r]) + log2f(l[r]);
      }
      const float inv = 1.f / l[r];  // l == 0 (all scores underflowed) gives NaN rows
      __nv_bfloat16* op = o + bq * sob + (long long)row * son + h * soh;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int dd = 8 * j + 2 * t;
        if (dd < d) {
          *reinterpret_cast<uint32_t*>(op + dd) = pack_bf16x2(oacc[4 * j + 2 * r] * inv,
                                                              oacc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int DP, bool STATIC>
int launch_wgmma(const TileMap* maps, void* o, float* lse, int bq, int nq, int nk, int heads, int d,
                 int kv_repeat, const long long* so, float scale_log2, float static_max,
                 cudaStream_t stream) {
  using T = FwdTile<DP>;
  auto kern = flash_fwd_wgmma_kernel<DP, STATIC>;
  static SmemLimit limit;  // the carveout is set with it, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 16 || limit.set[dev] < T::SMEM) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if ((err = limit.raise(kern, T::SMEM)) != cudaSuccess) return (int)err;
  }
  dim3 grid((nq + T::BQ - 1) / T::BQ, bq * heads);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      maps[0].map, maps[1].map, maps[2].map, TileCoord{maps[0].order}, TileCoord{maps[1].order},
      TileCoord{maps[2].order}, static_cast<__nv_bfloat16*>(o), lse, nq, nk, heads, d, kv_repeat,
      so[0], so[1], so[2], scale_log2, static_max);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, float* lse, int bq, int nq,
              int nk, int heads, int d, int kv_repeat, const long long* st,
              float scale_log2, float static_max, cudaStream_t stream) {
  using T = FwdTile<DP>;
  const int bkv = bq / kv_repeat;
  TileMap maps[3];
  if (!make_tile_map(&maps[0], q, d, nq, heads, bq, st[1], st[2], st[0], T::BQ) ||
      !make_tile_map(&maps[1], k, d, nk, heads, bkv, st[4], st[5], st[3], T::BKV) ||
      !make_tile_map(&maps[2], v, d, nk, heads, bkv, st[7], st[8], st[6], T::BKV)) {
    return -4;
  }
  return static_max != 0.f
      ? launch_wgmma<DP, true>(maps, o, lse, bq, nq, nk, heads, d, kv_repeat, st + 9, scale_log2, static_max, stream)
      : launch_wgmma<DP, false>(maps, o, lse, bq, nq, nk, heads, d, kv_repeat, st + 9, scale_log2, static_max, stream);
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bq, int nq,
                   int nk, int heads, int d, int kv_repeat, const long long* st,
                   float scale_log2, float static_max, cudaStream_t stream) {
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_dp<16>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 32: return launch_dp<32>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 48: return launch_dp<48>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 64: return launch_dp<64>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 80: return launch_dp<80>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 96: return launch_dp<96>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 128: return launch_dp<128>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    case 160: return launch_dp<160>(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, stream);
    default: return -2;
  }
}

// the tensor-core path needs 16-byte rows: d % 8 == 0, strides % 8 == 0,
// 16-byte-aligned bases, and a padded head dim it is instantiated for
bool wgmma_ok(const void* q, const void* k, const void* v, const void* o, int d,
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
    return wgmma_ok(q, k, v, o, d, st)
        ? dispatch_wgmma(q, k, v, o, lse, bq, nq, nk, heads, d, kv_repeat, st, scale_log2, static_max, s)
        : -4;
  return -1;
}
