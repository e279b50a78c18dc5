// Column sums for Hopper (sm_90a), bound through ctypes: the fp32 batch
// statistics of the fused trunk BatchNorm and of the native fused stem.
//
// Replaces three TPU kernels of the JAX package (guitar_tablature_
// classification_tpu/ops/):
//   bn_pallas.py::_sums_pallas        -> bn_sums_launch, g == nullptr:
//                                        per channel (sum y, sum y*y)
//   bn_pallas.py::_grad_sums_pallas   -> bn_sums_launch, g given:
//                                        per channel (sum g, sum g*y)
//   stem_native.py::_stats_pallas     -> bn_sums_launch over two sources
//                                        (the parity planes ye, yo), per lane
// ops/bn_fused.py and ops/stem_native.py hold the plain PyTorch versions.
//
// Layout.  Each source is a row-major [M, L] matrix, every row contiguous,
// read through that view with no copy; lane l belongs to output column
// (l / div) % C_out:
//   channels-last [B, C, H, W]:  M = B*H*W, L = C,     div = 1,   C_out = C
//   contiguous NCHW:             M = B,     L = C*H*W, div = H*W, C_out = C
//   native stem planes:          M = B*H2,  L = Wp*C,  div = 1,   C_out = L
// (the native stem's host code folds its per-lane sums to channels, leaving
// the pad columns out).  So one kernel reads both memory formats of the
// trunk, including the native trunk's NCHW maps whose rows hold 3 to 72
// values of a channel: a row of the view is a whole sample, not one row of
// one channel's map.
//
// Bound: bytes at 3.35 TB/s.  Flagship trunk, y [256, 64, 56, 56] bf16
// (102.8 MB): sums read y once -> 0.031 ms; grad sums read y and g -> 0.061
// ms.  The arithmetic (3 fp32 operations a value) is far below the FP32 rate.
// Design (simple first; speed is later work):
// * Pass 1: a CTA owns a tile of up to 256 x 8 lanes and a fixed set of rows
//   (grid y = parts, rows part*R + slot + k*parts*R); each thread loads 8
//   lanes of a row in one 16-byte load (bf16) and keeps fp32 sums of them.
//   The CTA adds its R row slots in a fixed order and writes one partial row
//   [2, L-tile] per (source, part).
// * Pass 2: one CTA per (statistic, output column) adds the partials of its
//   lanes over every part and source, each thread a strided run, then a
//   fixed tree.  No float atomics: two runs give the same bits.
// * Products and sums use __fmul_rn / __fadd_rn (no FMA contraction).

#include "vec_io.cuh"

namespace {

using vec_io::Io;
using vec_io::kBfloat16;
using vec_io::kFloat32;

constexpr int kThreads = 256;  // ops/bn_cuda.THREADS
constexpr int kVec = 8;        // lanes a thread loads at once; ops/bn_cuda.VEC

template <typename T, bool kGrad>
__global__ void __launch_bounds__(kThreads)
    col_sums_kernel(const T* __restrict__ y0, const T* __restrict__ y1,
                    const T* __restrict__ g, long long M, int L,
                    float* __restrict__ partial) {
  __shared__ float red[2 * kThreads * kVec];
  const int groups = L / kVec;            // 8-lane groups in a row
  const int G = min(groups, kThreads);    // groups in a lane tile
  const int R = kThreads / G;             // row slots of the CTA
  const int tile_lanes = G * kVec;
  const int parts = gridDim.y;
  const int slot = threadIdx.x / G;
  const int grp = blockIdx.x * G + threadIdx.x % G;
  const T* __restrict__ y = blockIdx.z == 0 ? y0 : y1;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s1[k] = s2[k] = 0.0f;
  if (slot < R && grp < groups) {
    const long long col = (long long)grp * kVec;
    for (long long m = (long long)blockIdx.y * R + slot; m < M;
         m += (long long)parts * R) {
      float v[kVec];
      Io<T>::template load<kVec>(y + m * L + col, v);
      if constexpr (kGrad) {
        float gv[kVec];
        Io<T>::template load<kVec>(g + m * L + col, gv);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          s1[k] = __fadd_rn(s1[k], gv[k]);
          s2[k] = __fadd_rn(s2[k], __fmul_rn(gv[k], v[k]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          s1[k] = __fadd_rn(s1[k], v[k]);
          s2[k] = __fadd_rn(s2[k], __fmul_rn(v[k], v[k]));
        }
      }
    }
  }
  if (slot < R) {
    const int lane0 = (threadIdx.x % G) * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      red[slot * tile_lanes + lane0 + k] = s1[k];
      red[(R + slot) * tile_lanes + lane0 + k] = s2[k];
    }
  }
  __syncthreads();
  const long long row = ((long long)blockIdx.z * parts + blockIdx.y) * 2;
  for (int t = threadIdx.x; t < 2 * tile_lanes; t += blockDim.x) {
    const int s = t / tile_lanes, lane = t % tile_lanes;
    const int l = blockIdx.x * tile_lanes + lane;
    if (l >= L) continue;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc = __fadd_rn(acc, red[(s * R + r) * tile_lanes + lane]);
    partial[(row + s) * L + l] = acc;
  }
}

// partial [n_parts, 2, L] -> out [2, C_out]: one CTA per (statistic,
// column c) adds partial[p][s][l] over every part p and every lane l with
// (l / div) % C_out == c; each thread a strided run of them, then a fixed
// tree.
__global__ void __launch_bounds__(kThreads)
    fold_partials_kernel(const float* __restrict__ partial, long long n_parts,
                         int L, int div, int C_out, float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int s = blockIdx.x / C_out, c = blockIdx.x % C_out;
  const int per_part = L / C_out;  // lanes of column c in one part
  const long long n = n_parts * per_part;
  float acc = 0.0f;
  for (long long idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const long long p = idx / per_part;
    const int j = (int)(idx % per_part);
    const int l = ((j / div) * C_out + c) * div + j % div;
    acc = __fadd_rn(acc, partial[(p * 2 + s) * L + l]);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

template <typename T>
cudaError_t launch_pass1(const void* y0, const void* y1, const void* g,
                         float* partial, long long rows, int lanes, dim3 grid,
                         cudaStream_t stream) {
  const T* a = static_cast<const T*>(y0);
  const T* b = static_cast<const T*>(y1 == nullptr ? y0 : y1);
  if (g == nullptr) {
    col_sums_kernel<T, false><<<grid, kThreads, 0, stream>>>(a, b, nullptr, rows,
                                                             lanes, partial);
  } else {
    col_sums_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        a, b, static_cast<const T*>(g), rows, lanes, partial);
  }
  return cudaGetLastError();
}

}  // namespace

// n_src sources y0 (, y1) of [rows, lanes] -> out [2, c_out] fp32:
// (sum y, sum y*y), or with g (same view as y0, n_src == 1) (sum g,
// sum g*y), folded to columns (lane / div) % c_out.  partial is scratch of
// n_src * parts * 2 * lanes floats.
extern "C" int bn_sums_launch(const void* y0, const void* y1, const void* g,
                              void* partial, void* out, long long rows,
                              int lanes, int n_src, int parts, int div,
                              int c_out, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (lanes <= 0 || lanes % kVec || rows < 0 || n_src < 1 || n_src > 2 ||
      (n_src == 2 && (y1 == nullptr || g != nullptr)) || parts < 1 ||
      parts > 65535 || div < 1 || c_out < 1 || lanes % (c_out * div))
    return (int)cudaErrorInvalidValue;
  const int groups = lanes / kVec;
  const int G = groups < kThreads ? groups : kThreads;
  const dim3 grid((groups + G - 1) / G, parts, n_src);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == kBfloat16) {
    err = launch_pass1<__nv_bfloat16>(y0, y1, g, part, rows, lanes, grid, stream);
  } else if (dtype == kFloat32) {
    err = launch_pass1<float>(y0, y1, g, part, rows, lanes, grid, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  fold_partials_kernel<<<2 * c_out, kThreads, 0, stream>>>(
      part, (long long)n_src * parts, lanes, div, c_out, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
