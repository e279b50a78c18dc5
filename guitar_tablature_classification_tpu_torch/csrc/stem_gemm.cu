// Stem-front GEMM with BatchNorm statistics in its epilogue, for Hopper
// (sm_90a), bound through ctypes.
//
// Replaces the JAX package's TPU kernel
//   guitar_tablature_classification_tpu/ops/stem_pallas.py::_gemm_stats_pallas
// ops/stem_tail.py::gemm_stats_plain is the plain PyTorch version.
//
// What it computes, for hq [M, K] bf16 and sq [K, N] bf16 (the 224^2 stem
// front's quadrant GEMM: M = B*112, K = 70, N = 7168):
//   y[m, n]    = bf16(sum_k hq[m, k] * sq[k, n])   fp32 products and sums
//   sums[0, n] = sum_m y[m, n],  sums[1, n] = sum_m y[m, n]^2
// in fp32, of the ROUNDED y (what the BatchNorm downstream reads).
//
// Bound.  At M = 28,672 and N = 7,168: 4.0 MB of hq, 1.0 MB of sq, 411 MB
// of y and 57 KB of sums: 0.124 ms of bytes at 3.35 TB/s.  28.8 GFLOP:
// 0.029 ms at the bf16 tensor-core peak.  So the kernel's job is to write y
// at the memory's rate with the products and the statistics out of the way.
//
// Design.
// * A CTA owns a 128 x 128 tile of y and stages its whole depth at once:
//   hq's 128 rows (an hq row is 140 bytes, not 16-byte aligned, so 4-byte
//   loads, or 2-byte ones for odd K) into bf16 [128][KP + 8] and sq's
//   columns into bf16 [KP][128 + 8], KP = K rounded up to 16, zero past K
//   and past M.  The row padding keeps ldmatrix free of bank conflicts.
// * Tensor cores through mma.sync m16n8k16 (bf16 operands, fp32
//   accumulation; products of bf16 values are exact): 8 warps as 2 x 4, each
//   a 64 x 32 block of y, fragments read with ldmatrix (.trans for sq).
// * Epilogue: the accumulators are rounded to bf16 into a [128][128 + 8]
//   tile in shared memory (over the staged operands); y leaves it in
//   16-byte stores, a warp writing whole rows; one thread per (statistic,
//   column) adds the tile's rounded values, or their squares, down the rows
//   in order into one partial row [2, 128] per (row tile, column tile).  A
//   second kernel adds the partial rows of each column in row-tile order.
//   No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // rows and columns of y per CTA
constexpr int kMaxK = 128;   // ops/stem_cuda.GEMM_MAX_K
constexpr int kPadN = kTile + 8;  // B and C row stride (bf16)

__host__ __device__ constexpr int padded_k(int K) { return (K + 15) / 16 * 16; }

// bf16 values of shared memory: A [128][KP + 8] and B [KP][136], and the
// C tile [128][136] over them
__host__ __device__ constexpr int smem_values(int K) {
  return kTile * (padded_k(K) + 8) + padded_k(K) * kPadN > kTile * kPadN
             ? kTile * (padded_k(K) + 8) + padded_k(K) * kPadN
             : kTile * kPadN;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
    gemm_stats_kernel(const __nv_bfloat16* __restrict__ hq,
                      const __nv_bfloat16* __restrict__ sq,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ partial, int M, int N, int K) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int KP = padded_k(K);
  const int lda = KP + 8;                  // A row stride
  __nv_bfloat16* As = smem;                // [kTile][lda]
  __nv_bfloat16* Bs = smem + kTile * lda;  // [KP][kPadN]
  __nv_bfloat16* Cs = smem;                // [kTile][kPadN], after the products
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int rows = min(kTile, M - m0);

  // 1. hq's rows into A, zero past K and past M
  if ((K & 1) == 0) {
    const int words = K / 2, pwords = KP / 2;  // 4-byte words a row, given and padded
    const uint32_t* src = reinterpret_cast<const uint32_t*>(hq + (long long)m0 * K);
    for (int i = tid; i < kTile * pwords; i += kThreads) {
      const int r = i / pwords, w = i % pwords;
      const uint32_t v = (r < rows && w < words) ? src[r * words + w] : 0u;
      *reinterpret_cast<uint32_t*>(As + r * lda + 2 * w) = v;
    }
  } else {
    for (int i = tid; i < kTile * KP; i += kThreads) {
      const int r = i / KP, k = i % KP;
      As[r * lda + k] = (r < rows && k < K) ? hq[(long long)(m0 + r) * K + k] : zero;
    }
  }
  // 2. sq's columns n0..n0+127 into B, 16-byte loads (N % 8 == 0)
  for (int i = tid; i < KP * (kTile / 8); i += kThreads) {
    const int k = i / (kTile / 8), c = (i % (kTile / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K && n0 + c < N) v = *reinterpret_cast<const uint4*>(sq + (long long)k * N + n0 + c);
    *reinterpret_cast<uint4*>(Bs + k * kPadN + c) = v;
  }
  __syncthreads();

  // 3. the products: warp (wm, wn) owns rows wm*64 .. +64, columns wn*32 .. +32
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int k0 = 0; k0 < KP; k0 += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // lanes 0-15: rows r..r+15 at k0; lanes 16-31: the same rows at k0 + 8
      const int r = wm * 64 + i * 16 + (lane % 16);
      ldmatrix_x4(a[i], As + r * lda + k0 + (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // lanes 0-7: rows k0..k0+7, lanes 8-15: k0+8..k0+15, at column c
      const int c = wn * 32 + j * 8;
      ldmatrix_x2_trans(b[j], Bs + (k0 + (lane % 16)) * kPadN + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
  __syncthreads();  // A and B are read no more: C takes their place

  // 4. round into the C tile: accumulator e of tile (i, j) is row
  //    (lane / 4) + 8 * (e / 2), column 2 * (lane % 4) + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + i * 16 + lane / 4 + 8 * h;
        const int c = wn * 32 + j * 8 + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(Cs + r * kPadN + c) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();

  // 5. y in 16-byte stores; column sums of the rounded values down the rows
  for (int i = tid; i < rows * (kTile / 8); i += kThreads) {
    const int r = i / (kTile / 8), c = (i % (kTile / 8)) * 8;
    if (n0 + c < N)
      *reinterpret_cast<uint4*>(y + (long long)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(Cs + r * kPadN + c);
  }
  {
    const int stat = tid / kTile, c = tid % kTile;
    if (n0 + c < N) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float v = __bfloat162float(Cs[r * kPadN + c]);
        s += stat == 0 ? v : v * v;
      }
      partial[((long long)blockIdx.y * 2 + stat) * N + n0 + c] = s;
    }
  }
}

// sums[s, n] = sum_p partial[p, s, n], p in order.
__global__ void __launch_bounds__(kThreads)
    fold_rows_kernel(const float* __restrict__ partial, int parts, int N,
                     float* __restrict__ sums) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * N) return;
  const int s = i / N, n = i % N;
  float acc = 0.0f;
  for (int p = 0; p < parts; ++p) acc += partial[((long long)p * 2 + s) * N + n];
  sums[i] = acc;
}

}  // namespace

// hq [M, K] bf16, sq [K, N] bf16 -> y [M, N] bf16, sums [2, N] fp32;
// partial is scratch of ceil(M / 128) * 2 * N floats.  Needs 1 <= K <= 128,
// N % 8 == 0, sq and y 16-byte aligned, hq 4-byte aligned.
extern "C" int gemm_stats_launch(const void* hq, const void* sq, void* y,
                                 void* partial, void* sums, int M, int N,
                                 int K, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M < 1 || N < 8 || N % 8 || K < 1 || K > kMaxK ||
      (M + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * smem_values(K);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = (M + kTile - 1) / kTile;
  const dim3 grid((N + kTile - 1) / kTile, parts);
  gemm_stats_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hq), static_cast<const __nv_bfloat16*>(sq),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), M, N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_rows_kernel<<<(2 * N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), parts, N, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
