// (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, for Hopper (sm_90a);
// plain C interface for ctypes.
//
// Replaces: i2v_adapter_tpu/ops/profile_int8_dense.py::_int8_mm_kernel (the
// tiled int8 matmul behind int8_pallas in the int8 dense microbenchmark).
//
// What bounds it here: bytes at the tool's shapes.  The int32 result is
// 4*M*N bytes against 2*M*N*K operations at the int8 tensor-core rate; with
// K = 320..5120 and M up to 131072 the output write is the larger time at
// most of the 13 shapes, so the kernel writes each result once, as 8-byte
// stores, and never re-reads it.
//
// Design: one CTA of 8 warps per 128 x 128 output tile, mma.sync m16n8k32
// (s8 x s8 -> s32), K in steps of 64.  x rows are k-contiguous as the mma's A
// operand wants them; w is n-contiguous, but the B operand wants four
// consecutive k of one column in a register, so the w tile is transposed
// while it is staged: each thread loads a 4 (k) x 4 (n) block of bytes as
// four words, transposes it in registers with byte permutes and stores four
// words to Bs[n][k].  Rows are 80 bytes (64 + 16 of padding) so fragment
// loads hit 32 banks; the word index within a Bs row is XORed with
// (n >> 3) & 15 so the transposed stores, whose n runs four at a time across
// the warp, do so too.  K must be a multiple of 16 and N of 4 (16-byte and
// 4-byte loads); M, N and K tails are masked or zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64, RS = 80, THREADS = 256;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS) int8_mm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int* __restrict__ out,
    int M, int K, int N) {
  __shared__ __align__(16) uint8_t As[BM * RS];
  __shared__ __align__(16) uint8_t Bs[BN * RS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i >> 2, q = i & 3;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k0 + q * 16 < K) {
        val = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + k0 + q * 16);
      }
      *reinterpret_cast<uint4*>(As + r * RS + q * 16) = val;
    }
    for (int i = tid; i < (BK / 4) * (BN / 4); i += THREADS) {
      const int nq = i & 31, kq = i >> 5;
      const int n = n0 + nq * 4;
      uint32_t r[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int k = k0 + kq * 4 + ii;
        r[ii] = (k < K && n < N) ? *reinterpret_cast<const uint32_t*>(w + (long long)k * N + n) : 0u;
      }
      // 4x4 byte transpose: c[j] = (r0.j, r1.j, r2.j, r3.j)
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t c[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = nq * 4 + j;
        *reinterpret_cast<uint32_t*>(Bs + nn * RS + ((kq ^ ((nn >> 3) & 15)) << 2)) = c[j];
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = wn * 32 + j * 8 + g;
        const int sw = (nn >> 3) & 15;
        bf[j][0] = lds32(Bs + nn * RS + (((kk * 8 + t) ^ sw) << 2));
        bf[j][1] = lds32(Bs + nn * RS + (((kk * 8 + 4 + t) ^ sw) << 2));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* ap = As + (wm * 64 + i * 16 + g) * RS + kk * 32 + 4 * t;
        const uint32_t af[4] = {lds32(ap), lds32(ap + 8 * RS), lds32(ap + 16), lds32(ap + 8 * RS + 16)};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * hh;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n < N) {
          *reinterpret_cast<int2*>(out + (long long)m * N + n) =
              make_int2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

}  // namespace

// x (M, K) and w (K, N) int8, out (M, N) int32, all contiguous.  Returns 0
// or the CUDA error code of the launch; -3 grid too large, -4 K not a
// multiple of 16, N not a multiple of 4 or a base not 16-byte aligned.
extern "C" int int8_matmul(const void* x, const void* w, void* out, int M, int K, int N,
                           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return -3;
  if (K % 16 != 0 || N % 4 != 0) return -4;
  const void* ptrs[3] = {x, w, out};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -4;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return -3;
  int8_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<int*>(out), M, K, N);
  return (int)cudaGetLastError();
}
