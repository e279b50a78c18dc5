// CQT frame GEMM for Hopper (sm_90a), bound through ctypes: raw
// coefficients, no epilogue.
//
// Replaces the JAX package's TPU kernel
//   guitar_tablature_classification_tpu/ops/cqt_pallas.py::cqt_frame_gemm
// ops/cqt.py::frame_gemm_plain is the plain PyTorch version.
//
// What it computes, for padded audio [B, P] fp32 and any filterbank
// K [Kw, N] fp32 (N = 2F, real | imag):
//   out[b, t, n] = sum_{k < Kw} padded[b, t*hop + k] * K[k, n]
// with padded read as zero past P (the JAX function pads it).  A dense GEMM
// with M = B*T rows, N columns and depth Kw.  It takes any K: unlike
// csrc/cqt.cu it assumes nothing about the filterbank's zero structure.
//
// Precision tiers, the products on the FP32 pipes in every one (fp32 products
// of bf16 operands are exact):
//   highest  fp32 operands;
//   bf16x3   hi = bf16(a), lo = bf16(a - hi); hi*hi + hi*lo + lo*hi;
//   default  both operands rounded to bf16 (nearest even).
//
// Bound.  Training recipe at B=256 (T=9, Kw=23,552, N=192): 20.8 GFLOP
// dense against 53 MB of fp32 (the audio read once, K once, the output
// written once): 0.016 ms of bytes at 3.35 TB/s, 0.31 ms of operations at
// the 67 TFLOP/s FP32 rate (highest), 0.021 ms at the bf16 tensor-core peak
// (default).  This kernel's own ceiling is the FP32 rate in every tier.
//
// Design (simple first; speed is later work).
// * Implicit im2col: row (b, t) of the A tile reads padded[b, t*hop + k]
//   straight from the audio; the [B, T, Kw] frame stack is never written.
// * A classic shared-memory SIMT GEMM: a CTA owns a 64 x 64 output tile,
//   walks K in steps of 16 (A tile stored k-major, so a thread reads its 4
//   rows as one float4), each of 256 threads keeps a 4 x 4 block of fp32
//   accumulators.  The next step's operands are loaded into registers while
//   the current step computes.  Operands are rounded or split on the way
//   into shared memory.
// * Split K: when the output tiles are too few to fill the card (the
//   training recipe has 108), grid z cuts Kw into `splits` ranges whose
//   partial sums go to scratch; a second kernel adds them in split order.
//   splits is fixed by the shape, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output rows (b, t) per CTA
constexpr int kBN = 64;  // output columns per CTA
constexpr int kBK = 16;  // filter rows per step

enum Precision { kHighest = 0, kBf16x3 = 1, kDefault = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kPrec>
__global__ void __launch_bounds__(kThreads)
    frame_gemm_kernel(const float* __restrict__ padded,
                      const float* __restrict__ kern, float* __restrict__ dst,
                      int T, long long P, int hop, int Kw, int N, int M,
                      int k_chunk) {
  constexpr int kParts = kPrec == kBf16x3 ? 2 : 1;  // hi (, lo)
  __shared__ __align__(16) float As[kParts][kBK][kBM];
  __shared__ __align__(16) float Bs[kParts][kBK][kBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(Kw, k_begin + k_chunk);

  // A loads: element (row tid/16 + 16*i, k tid%16); B loads: (k tid/64 +
  // 4*i, column tid%64).
  const int a_k = tid % kBK;
  long long a_off[4];
  long long a_lim[4];  // samples of the row's frame that lie inside P
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / kBK + 16 * i;
    if (m < M) {
      const int b = m / T, t = m % T;
      a_off[i] = (long long)b * P + (long long)t * hop;
      a_lim[i] = P - (long long)t * hop;
    } else {
      a_off[i] = 0;
      a_lim[i] = 0;
    }
  }
  const int b_n = n0 + tid % kBN;
  const int b_k = tid / kBN;

  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_k;
      a_reg[i] = (k < k_end && k < a_lim[i]) ? padded[a_off[i] + k] : 0.0f;
      const int kb = k0 + b_k + 4 * i;
      b_reg[i] = (kb < k_end && b_n < N) ? kern[(long long)kb * N + b_n] : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = a_reg[i], b = b_reg[i];
      float* as = &As[0][a_k][tid / kBK + 16 * i];
      float* bs = &Bs[0][b_k + 4 * i][tid % kBN];
      if constexpr (kPrec == kDefault) {
        a = round_bf16(a);
        b = round_bf16(b);
      }
      if constexpr (kPrec == kBf16x3) {
        const float ah = round_bf16(a), bh = round_bf16(b);
        as[kBK * kBM] = round_bf16(a - ah);  // As[1]: lo
        bs[kBK * kBN] = round_bf16(b - bh);
        a = ah;
        b = bh;
      }
      *as = a;
      *bs = b;
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    stage();
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[0][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[0][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      if constexpr (kPrec == kBf16x3) {
        const float4 al = *reinterpret_cast<const float4*>(&As[1][kk][ty * 4]);
        const float4 bl = *reinterpret_cast<const float4*>(&Bs[1][kk][tx * 4]);
        const float alv[4] = {al.x, al.y, al.z, al.w};
        const float blv[4] = {bl.x, bl.y, bl.z, bl.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            acc[i][j] = fmaf(av[i], blv[j], acc[i][j]);
            acc[i][j] = fmaf(alv[i], bv[j], acc[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = dst + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum_s partial[s][i], s in order.
__global__ void __launch_bounds__(kThreads)
    add_splits_kernel(const float* __restrict__ partial, long long n,
                      int splits, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = partial[i];
  for (int s = 1; s < splits; ++s) acc += partial[(long long)s * n + i];
  out[i] = acc;
}

template <int kPrec>
cudaError_t launch(const float* padded, const float* kern, float* dst, int T,
                   long long P, int hop, int Kw, int N, int M, int splits,
                   int k_chunk, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  frame_gemm_kernel<kPrec><<<grid, kThreads, 0, stream>>>(
      padded, kern, dst, T, P, hop, Kw, N, M, k_chunk);
  return cudaGetLastError();
}

}  // namespace

// padded [B, P] fp32, kern [Kw, N] fp32 -> out [B, T, N] fp32.  With
// splits > 1, partial is scratch of splits * B*T*N floats (else unused).
extern "C" int cqt_frame_gemm_launch(const void* padded, const void* kern,
                                     void* out, void* partial, int B,
                                     long long P, int T, int hop, int Kw,
                                     int N, int splits, int precision,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long m_ll = (long long)B * T;
  if (B < 1 || T < 1 || P < 1 || hop < 1 || Kw < 1 || N < 1 || splits < 1 ||
      splits > 65535 || m_ll > (1LL << 30) || (m_ll + kBM - 1) / kBM > 65535 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = (int)m_ll;
  // filter rows per split, a multiple of kBK
  const int k_chunk = ((Kw + splits - 1) / splits + kBK - 1) / kBK * kBK;
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const float* a = static_cast<const float*>(padded);
  const float* k = static_cast<const float*>(kern);
  cudaError_t err;
  if (precision == kHighest) {
    err = launch<kHighest>(a, k, dst, T, P, hop, Kw, N, M, splits, k_chunk, stream);
  } else if (precision == kBf16x3) {
    err = launch<kBf16x3>(a, k, dst, T, P, hop, Kw, N, M, splits, k_chunk, stream);
  } else if (precision == kDefault) {
    err = launch<kDefault>(a, k, dst, T, P, hop, Kw, N, M, splits, k_chunk, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = m_ll * N;
  add_splits_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), n, splits, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
