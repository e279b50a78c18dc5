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
// Precision tiers (fp32 products of bf16 operands are exact):
//   highest  fp32 operands, as accurate as an fp32 GEMM: three bf16 pieces
//            of each operand and six products of pieces on the tensor cores
//            (frame_gemm_ring_kernel<3>); at a hop that is not a multiple of
//            8, products on the FP32 pipes (SIMT kernel);
//   bf16x3   hi = bf16(a), lo = bf16(a - hi); hi*hi + hi*lo + lo*hi on the
//            tensor cores (frame_gemm_ring_kernel<2>), or the SIMT kernel
//            at a hop that is not a multiple of 8;
//   default  both operands rounded to bf16 (nearest even), products on the
//            tensor cores (frame_gemm_ring_kernel<1>, or at a hop that is not
//            a multiple of 8 frame_gemm_mma_kernel; csrc/frame_mma.cuh).
// The training recipe (hop 1024), serving_cnn (hop 512) and hop 1000 run
// on the tensor cores at every tier.
//
// Bound.  Training recipe at B=256 (T=9, Kw=23,552, N=192): 20.8 GFLOP
// dense against 53 MB of fp32 (the audio read once, K once, the output
// written once): 0.016 ms of bytes at 3.35 TB/s.  Operations: 0.021 ms
// for one bf16 tensor-core pass (default), 0.063 ms for three (bf16x3);
// for an fp32-accurate result the least of 0.31 ms on the 67 TFLOP/s FP32
// pipes and six bf16 passes, 0.126 ms (3xTF32 also costs 0.126 ms): the
// six passes set highest's bound.
//
// Design of the SIMT kernel (highest, bf16x3 at a hop off the 8-grid).
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
//
// Design of the tensor-core kernels.
// * A CTA of 8 warps owns a 128 x 96 output tile (warps 4 x 2, each 32 x 48:
//   2 x 6 mma.sync m16n8k16 tiles, 48 fp32 accumulators a thread) and walks
//   K in steps of 32, with padded shared rows of 40 and 104 bf16, so
//   ldmatrix reads 8 rows from 8 distinct bank groups.
// * The same fixed-order split of the depth and second pass as the SIMT
//   kernel, on the tensor tile count (ops/cqt_cuda.frame_gemm_splits): at
//   default about two CTAs an SM, at the split tiers (one CTA an SM) the
//   count of ranges that fills the last wave best.
// * frame_gemm_mma_kernel (default, any hop) loads the fp32 operands into
//   registers itself, rounding them to bf16 on the way into shared memory
//   (two stages, one barrier a step): per 32-deep step a CTA reads 16 KB of
//   audio and 12 KB of filterbank for 393 k multiply-adds, about 14 per
//   byte, so the L2 rate bounds it.
// * frame_gemm_ring_kernel<parts> (hop a multiple of 8, so every frame row
//   starts 16-byte aligned in a bf16 copy): to_parts_kernel first writes
//   zero-padded bf16 copies of each piece of the audio and the filterbank
//   (part of the launch and of its time), then cp.async fills a ring of 4
//   shared stages (every piece of a step in one stage), three steps ahead of
//   the tensor cores, with no mask and no register staging.  The dispatch
//   is by hop alone, in cqt_frame_gemm_launch
//   (ops/cqt_cuda.frame_gemm_copies).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_mma.cuh"

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

// ---------------------------------------------------------------- default

constexpr int kMmaThreads = 256;
constexpr int kMM = 128;          // output rows per CTA
constexpr int kMN = 96;           // output columns per CTA
constexpr int kMK = 32;           // filter rows per step
constexpr int kALd = kMK + 8;     // A stage row (bf16): 80 bytes
constexpr int kBLd = kMN + 8;     // B stage row (bf16): 208 bytes
constexpr int kARows = kMM * kMK / kMmaThreads;  // A values a thread loads a step: 16
constexpr int kBVals = kMK * kMN / kMmaThreads;  // B values: 12

__global__ void __launch_bounds__(kMmaThreads)
    frame_gemm_mma_kernel(const float* __restrict__ padded,
                          const float* __restrict__ kern, float* __restrict__ dst,
                          int T, long long P, int hop, int Kw, int N, int M,
                          int k_chunk) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kMM][kALd];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kMK][kBLd];
  __shared__ long long s_row_off[kMM];  // padded offset of row (b, t)
  __shared__ long long s_row_lim[kMM];  // samples of its frame inside P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kMM, n0 = blockIdx.x * kMN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(Kw, k_begin + k_chunk);

  for (int r = tid; r < kMM; r += kMmaThreads) {
    const int m = m0 + r;
    if (m < M) {
      const int b = m / T, t = m % T;
      s_row_off[r] = (long long)b * P + (long long)t * hop;
      s_row_lim[r] = P - (long long)t * hop;
    } else {
      s_row_off[r] = 0;
      s_row_lim[r] = 0;
    }
  }
  // B loads: value i is (k, n) = divmod(tid + 256 i, 96) of the step
  int b_off[kBVals];
  bool b_ok[kBVals];
#pragma unroll
  for (int i = 0; i < kBVals; ++i) {
    const int e = tid + kMmaThreads * i;
    b_off[i] = (e / kMN) * N + e % kMN;
    b_ok[i] = n0 + e % kMN < N;
  }
  __syncthreads();

  // A loads: value i is (row tid / 32 + 8 i, k lane) of the step
  float a_reg[kARows], b_reg[kBVals];
  auto load = [&](int k0) {
    const int k = k0 + lane;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = warp + 8 * i;
      a_reg[i] = (k < k_end && k < s_row_lim[r]) ? padded[s_row_off[r] + k] : 0.0f;
    }
    const float* kb = kern + (long long)k0 * N + n0;
#pragma unroll
    for (int i = 0; i < kBVals; ++i) {
      const int kk = k0 + (tid + kMmaThreads * i) / kMN;
      b_reg[i] = (kk < k_end && b_ok[i]) ? kb[b_off[i]] : 0.0f;
    }
  };
  auto stage = [&](int s) {
#pragma unroll
    for (int i = 0; i < kARows; ++i)
      As[s][warp + 8 * i][lane] = __float2bfloat16_rn(a_reg[i]);
#pragma unroll
    for (int i = 0; i < kBVals; ++i) {
      const int e = tid + kMmaThreads * i;
      Bs[s][e / kMN][e % kMN] = __float2bfloat16_rn(b_reg[i]);
    }
  };

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 48;
  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  int s = 0;
  if (k_begin < k_end) {
    load(k_begin);
    stage(0);
  }
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += kMK) {
    const bool more = k0 + kMK < k_end;
    if (more) load(k0 + kMK);
#pragma unroll
    for (int kk = 0; kk < kMK; kk += 16) {
      uint32_t a[2][4], b[3][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        frame_mma::ldmatrix_x4(
            a[i], &As[s][wm + 16 * i + frame_mma::ldm_row(lane)][kk + frame_mma::ldm_k(lane)]);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        frame_mma::ldmatrix_x4_trans(
            b[j], &Bs[s][kk + frame_mma::ldm_row(lane)][wn + 16 * j + frame_mma::ldm_k(lane)]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          frame_mma::mma_bf16(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
    }
    if (more) stage(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

  float* out = dst + (long long)blockIdx.z * M * N;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn + 8 * j + 2 * c + q;
          if (n < N) out[(long long)m * N + n] = acc[i][j][2 * h + q];
        }
    }
}

// The ring kernels (hop a multiple of 8): bf16 copies of the audio and the
// filterbank (to_parts_kernel, part of the launch), then a ring of
// kRingStages shared stages filled by cp.async, so the next steps' copies
// are in flight while the tensor cores run the current one.  The copies are
// padded so that no load needs a mask: the audio rows to P8 >= (T-1)*hop +
// K32 (zeros past P), the filterbank to K32 rows (zeros past Kw) and N96
// columns; a split's range ends on a multiple of kMK, the last at K32.
//
// kParts bf16 pieces of each operand: 1 at default (bf16(v)); 2 at bf16x3
// (hi = bf16(v), lo = bf16(v - hi), as ops/cqt.py::split_bf16); 3 at
// highest (hi, mid = bf16(v - hi), lo = bf16(v - hi - mid): the three
// pieces hold v's 24-bit significand).  Each tier issues its products of
// pieces on mma.sync (exact products of bf16 values, fp32 sums): bf16x3
// hi*hi + hi*lo + lo*hi, as the plain version; highest the six products
// whose weight is at least 2^-16 of hi*hi (hi*hi, hi*mid, mid*hi, hi*lo,
// lo*hi, mid*mid), the TPU's own six-pass HIGHEST emulation
// (ops/cqt_pallas.py::_mxu_passes).  Dropped: mid*lo, lo*mid, lo*lo, at
// most 3 * 2^-24 of |a*b|, below fp32's own rounding of the product.
// Six bf16 passes cost what 3xTF32 does on this card (TF32 runs at half
// the bf16 rate), and reuse the bf16 ldmatrix/mma core unchanged.
// The tensor cores add each mma's products into the accumulator with
// truncation, so at the split tiers a step's sums (32 filter rows) are
// added into a second fp32 accumulator, rounded to nearest, after every
// step: the products' long sum over Kw is an fp32 sum as in the plain
// version, whose error the highest tier must match (tests/test_torch_cuda.py).
constexpr int kRingStages = 4;
constexpr int kStageVals = kMM * kALd + kMK * kBLd;  // bf16 values a stage, one piece

template <int kParts>
constexpr size_t ring_smem() {
  return (size_t)kRingStages * kParts * kStageVals * sizeof(__nv_bfloat16);
}

// The pieces of v: dst[p * part_stride + r * dst_ld + c] for p < parts, for
// v = src[r, c] where r < rows_src and c < cols, else v = 0.  A thread
// writes 8 consecutive columns of a piece with one 16-byte store (dst_ld,
// part_stride and dst are multiples of 8 values), over the flattened
// [rows_dst, dst_ld] array.
__global__ void __launch_bounds__(256)
    to_parts_kernel(const float* __restrict__ src, long long src_ld, int rows_src, int cols,
                    __nv_bfloat16* __restrict__ dst, long long dst_ld, int rows_dst, int parts,
                    long long part_stride) {
  const long long groups_row = dst_ld / 8, groups = groups_row * rows_dst;
  for (long long gi = (long long)blockIdx.x * 256 + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * 256) {
    const long long r = gi / groups_row, c0 = (gi % groups_row) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (r < rows_src && c0 + e < cols) ? src[r * src_ld + c0 + e] : 0.0f;
    for (int p = 0; p < parts; ++p) {
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 piece = __floats2bfloat162_rn(v[e], v[e + 1]);
        packed[e / 2] = *reinterpret_cast<const uint32_t*>(&piece);
        v[e] -= __low2float(piece);  // exact: the piece is v rounded
        v[e + 1] -= __high2float(piece);
      }
      *reinterpret_cast<uint4*>(dst + p * part_stride + r * dst_ld + c0) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

using frame_mma::n_products;  // the tier's products of pieces
using frame_mma::prod_a;
using frame_mma::prod_b;

template <int kParts>
__global__ void __launch_bounds__(kMmaThreads, kParts == 1 ? 2 : 1)
    frame_gemm_ring_kernel(const __nv_bfloat16* __restrict__ abf, long long P8,
                           long long a_part, const __nv_bfloat16* __restrict__ kbf, int N96,
                           long long k_part, float* __restrict__ dst, int T, int hop, int N,
                           int M, int k_chunk, int K32) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  __shared__ long long s_row_off[kMM];  // bf16 copy offset of row (b, t)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kMM, n0 = blockIdx.x * kMN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K32, k_begin + k_chunk);
  const int steps = max(k_end - k_begin, 0) / kMK;
  for (int r = tid; r < kMM; r += kMmaThreads) {
    const int m = min(m0 + r, M - 1);  // a padded row reads the last row, never written
    s_row_off[r] = (long long)(m / T) * P8 + (long long)(m % T) * hop;
  }
  __syncthreads();

  // piece p of a stage: A [kMM][kALd], then B [kMK][kBLd]
  auto stage_a = [&](int slot, int p) {
    return ring + ((size_t)slot * kParts + p) * kStageVals;
  };
  auto stage_b = [&](int slot, int p) { return stage_a(slot, p) + kMM * kALd; };
  auto issue = [&](int step) {
    const int k0 = k_begin + step * kMK, slot = step % kRingStages;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      __nv_bfloat16* as = stage_a(slot, p);
      __nv_bfloat16* bs = stage_b(slot, p);
      const __nv_bfloat16* ap = abf + p * a_part;
      const __nv_bfloat16* kp = kbf + p * k_part;
      for (int j = tid; j < kMM * kMK / 8; j += kMmaThreads) {  // 4 chunks a row
        const int r = j >> 2, q = j & 3;
        frame_mma::cp_async16(as + r * kALd + 8 * q, ap + s_row_off[r] + k0 + 8 * q);
      }
      for (int j = tid; j < kMK * kMN / 8; j += kMmaThreads) {  // 12 chunks a row
        const int r = j / (kMN / 8), q = j % (kMN / 8);
        frame_mma::cp_async16(bs + r * kBLd + 8 * q, kp + (long long)(k0 + r) * N96 + n0 + 8 * q);
      }
    }
  };

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 48;
  float acc[2][6][4], total[kParts > 1 ? 2 : 1][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  if constexpr (kParts > 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) total[i][j][q] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < steps) issue(s);
    frame_mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    frame_mma::cp_async_wait<kRingStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1's slot
    if (s + kRingStages - 1 < steps) issue(s + kRingStages - 1);
    frame_mma::cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kMK; kk += 16) {
      uint32_t a[kParts][2][4], b[kParts][3][4];
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const __nv_bfloat16* as = stage_a(s % kRingStages, p);
        const __nv_bfloat16* bs = stage_b(s % kRingStages, p);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          frame_mma::ldmatrix_x4(
              a[p][i], as + (wm + 16 * i + frame_mma::ldm_row(lane)) * kALd + kk +
                           frame_mma::ldm_k(lane));
#pragma unroll
        for (int j = 0; j < 3; ++j)
          frame_mma::ldmatrix_x4_trans(
              b[p][j], bs + (kk + frame_mma::ldm_row(lane)) * kBLd + wn + 16 * j +
                           frame_mma::ldm_k(lane));
      }
#pragma unroll
      for (int q = 0; q < n_products(kParts); ++q) {
        const int pa = prod_a(kParts, q), pb = prod_b(kParts, q);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j)
            frame_mma::mma_bf16(acc[i][j], a[pa][i], b[pb][j / 2][2 * (j & 1)],
                                b[pb][j / 2][2 * (j & 1) + 1]);
      }
    }
    if constexpr (kParts > 1) {  // the step's sums into the round-to-nearest total
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            total[i][j][q] += acc[i][j][q];
            acc[i][j][q] = 0.0f;
          }
    }
  }
  frame_mma::cp_async_wait<0>();

  float* out = dst + (long long)blockIdx.z * M * N;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn + 8 * j + 2 * c + q;
          if (n < N)
            out[(long long)m * N + n] = kParts > 1 ? total[i][j][2 * h + q] : acc[i][j][2 * h + q];
        }
    }
}

// The copies and the ring kernel of a tier with kParts pieces.
template <int kParts>
cudaError_t launch_ring(const float* a, const float* k, __nv_bfloat16* ab, __nv_bfloat16* kb,
                        float* dst, int B, long long P, long long P8, int T, int hop, int Kw,
                        int N, int M, int splits, int k_chunk, cudaStream_t stream) {
  const int K32 = (Kw + kMK - 1) / kMK * kMK;
  const int N96 = (N + kMN - 1) / kMN * kMN;
  const long long a_part = (long long)B * P8, k_part = (long long)K32 * N96;
  const auto grid_for = [](long long values) {  // 8 values a thread, at most 8 CTAs an SM
    const long long ctas = (values / 8 + 255) / 256;
    return (unsigned)(ctas < 132 * 8 ? ctas : 132 * 8);
  };
  to_parts_kernel<<<grid_for(a_part), 256, 0, stream>>>(a, P, B, (int)P, ab, P8, B, kParts,
                                                         a_part);
  to_parts_kernel<<<grid_for(k_part), 256, 0, stream>>>(k, N, Kw, N, kb, N96, K32, kParts,
                                                         k_part);
  const size_t smem = ring_smem<kParts>();
  cudaError_t err = cudaFuncSetAttribute(frame_gemm_ring_kernel<kParts>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMN - 1) / kMN, (M + kMM - 1) / kMM, splits);
  frame_gemm_ring_kernel<kParts><<<grid, kMmaThreads, smem, stream>>>(
      ab, P8, a_part, kb, N96, k_part, dst, T, hop, N, M, k_chunk, K32);
  return cudaGetLastError();
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
// With abf and kbf (a hop that is a multiple of 8: the ring kernels), bf16
// scratch of parts * B * P8 and parts * K32 * N96 values, parts = 1
// (default), 2 (bf16x3) or 3 (highest), P8 = a multiple of 8 >= max(P,
// (T-1)*hop + K32), K32 = Kw rounded up to kMK, N96 = N rounded up to kMN
// (ops/cqt_cuda.frame_gemm_copies computes the same).  Without them the
// default tier runs frame_gemm_mma_kernel, the others the SIMT kernel.
extern "C" int cqt_frame_gemm_launch(const void* padded, const void* kern,
                                     void* out, void* partial, void* abf, void* kbf,
                                     int B, long long P, int T, int hop, int Kw,
                                     int N, int splits, int precision, long long P8,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long m_ll = (long long)B * T;
  if (B < 1 || T < 1 || P < 1 || hop < 1 || Kw < 1 || N < 1 || splits < 1 ||
      splits > 65535 || m_ll > (1LL << 30) || (m_ll + kBM - 1) / kBM > 65535 ||
      (splits > 1 && partial == nullptr) || precision < kHighest || precision > kDefault)
    return (int)cudaErrorInvalidValue;
  const int M = (int)m_ll;
  const bool ring = abf != nullptr;
  // filter rows per split, a multiple of the kernel's step
  const int step = (precision == kDefault || ring) ? kMK : kBK;
  const int k_chunk = ((Kw + splits - 1) / splits + step - 1) / step * step;
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const float* a = static_cast<const float*>(padded);
  const float* k = static_cast<const float*>(kern);
  cudaError_t err;
  if (ring) {
    const int K32 = (Kw + kMK - 1) / kMK * kMK;
    if (hop % 8 != 0 || P8 % 8 != 0 || P8 < P || P8 < (long long)(T - 1) * hop + K32 ||
        kbf == nullptr)
      return (int)cudaErrorInvalidValue;
    __nv_bfloat16* ab = static_cast<__nv_bfloat16*>(abf);
    __nv_bfloat16* kb = static_cast<__nv_bfloat16*>(kbf);
    if (precision == kDefault)
      err = launch_ring<1>(a, k, ab, kb, dst, B, P, P8, T, hop, Kw, N, M, splits, k_chunk, stream);
    else if (precision == kBf16x3)
      err = launch_ring<2>(a, k, ab, kb, dst, B, P, P8, T, hop, Kw, N, M, splits, k_chunk, stream);
    else
      err = launch_ring<3>(a, k, ab, kb, dst, B, P, P8, T, hop, Kw, N, M, splits, k_chunk, stream);
  } else if (precision == kHighest) {
    err = launch<kHighest>(a, k, dst, T, P, hop, Kw, N, M, splits, k_chunk, stream);
  } else if (precision == kBf16x3) {
    err = launch<kBf16x3>(a, k, dst, T, P, hop, Kw, N, M, splits, k_chunk, stream);
  } else {
    const dim3 grid((N + kMN - 1) / kMN, (M + kMM - 1) / kMM, splits);
    frame_gemm_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(a, k, dst, T, P, hop, Kw, N, M,
                                                           k_chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = m_ll * N;
  add_splits_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(partial), n, splits, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The tensor-core kernels as the card runs them (which: 0 the default
// tier's ring kernel, 1 the default tier's kernel that loads the fp32
// operands itself, 2 the bf16x3 ring kernel, 3 the highest ring kernel):
// info = {registers a thread, local (spill) bytes a thread, shared bytes a
// CTA, threads a CTA, resident CTAs per SM}.  Returns 0, or the cudaError_t
// of the failed query.
extern "C" int frame_gemm_mma_kernel_info(int which, int* info) {
  const void* fns[4] = {(const void*)frame_gemm_ring_kernel<1>,
                        (const void*)frame_gemm_mma_kernel,
                        (const void*)frame_gemm_ring_kernel<2>,
                        (const void*)frame_gemm_ring_kernel<3>};
  const size_t smems[4] = {ring_smem<1>(), 0, ring_smem<2>(), ring_smem<3>()};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  const void* fn = fns[which];
  const size_t smem = smems[which];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  if (smem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kMmaThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)(attr.sharedSizeBytes + smem);
  info[3] = kMmaThreads;
  info[4] = ctas;
  return 0;
}
