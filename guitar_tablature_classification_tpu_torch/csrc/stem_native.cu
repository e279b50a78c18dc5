// Fused native-geometry ResNet stem tail for Hopper (sm_90a), bound through
// ctypes: BN + ReLU + 3x3/s2 max-pool on conv1's row-parity planes, and its
// gradient.
//
// Replaces two TPU kernels of the JAX package's
//   guitar_tablature_classification_tpu/ops/stem_native.py
//     _fwd_pallas  -> native_fwd_launch
//     _bwd_pallas  -> native_bwd_launch
// (its third, _stats_pallas, is served by the column sums of csrc/bn.cu).
// ops/stem_native.py holds the plain PyTorch versions these kernels match.
//
// Layout.  conv1 7x7/s2 on the raw [96, 9] CQT gives [48, 5] maps; its even
// and odd output rows arrive as two planes ye, yo [B, H2, Wp*C], channels
// fastest:
//   ye[b, i, w*C + c] = conv1(x)[b, 2i, w, c],  yo[...] = conv1(x)[b, 2i+1, ...]
// Columns w < Wreal are real; the Wp - Wreal columns after them (one, at
// the native geometry) are padding whose values are never used.  Pooled
// output (i, j) covers rows {O[i-1], E[i], O[i]} (taps a = 0, 1, 2) and
// columns {2j-1, 2j, 2j+1} (taps b = 0, 1, 2); it is written compact as
// [B, H2, Wout, C], Wout = (Wreal - 1)/2 + 1.  A tap outside the map or on a
// pad column holds -1, which no ReLU output (>= 0) loses to, so a pad
// column never wins a window.
//
// Rounding.  Every value is read as fp32 and z = y*se + oe is a product and
// then a sum (__fmul_rn, __fadd_rn; built with -fmad=false), r = max(z, 0)
// with NaN kept, so every bf16 tie matches the plain version.  The gradient
// of a window goes to its FIRST tap equal to the max in row-major (a, b)
// order (XLA's select_and_scatter), and the up to four window gradients of
// a source are added in ascending tap order, as the plain version adds them:
// dye and dyo match bit for bit.
//
// Bound (B=4096, H2=24, Wp=6, C=64, bf16; chip_smoke.py computes it per run):
// bytes at 3.35 TB/s.
//   fwd reads ye, yo (151 MB), writes the pool (37.7 MB)        -> 0.056 ms
//   bwd reads ye, yo, g (189 MB), writes dye, dyo (151 MB)      -> 0.101 ms
// Design (simple first; speed is later work):
// * fwd: one thread per (pooled output, 8 channels): 9 16-byte loads (bf16),
//   served mostly by L1/L2 (a row feeds two windows).
// * bwd: one thread per (b, pooled row i, 2 channels), over a fixed grid of
//   CTAs that stride over (b, i).  It loads the five rows O[i-1], E[i],
//   O[i], E[i+1], O[i+1] (every column), finds the first-max tap of the
//   windows of rows i and i+1, and writes the sources of E[i] and O[i]: the
//   rows i+1 are loaded again by the next row's thread (2.5 loads a source).
//   No atomics: each source is written by one thread.
// * Per-lane sums of dz and dz*y: each thread keeps them over its items, the
//   CTA adds its row slots in a fixed order into a partial row [2, L], and a
//   second pass adds the partials of each lane in a fixed order.  Runs are
//   deterministic.

#include "vec_io.cuh"

namespace {

using vec_io::bn_relu;
using vec_io::Io;
using vec_io::kBfloat16;
using vec_io::kFloat32;
using vec_io::max_nan;

constexpr int kThreads = 256;  // ops/stem_native_cuda.THREADS
constexpr int kVecFwd = 8;     // ops/stem_native_cuda.VEC_FWD
constexpr int kVecBwd = 2;     // ops/stem_native_cuda.VEC_BWD
constexpr int kMaxWp = 6;      // widest plane (ops/stem_native_cuda.MAX_WP)
constexpr int kMaxWout = (kMaxWp - 1) / 2 + 1;

__device__ __forceinline__ long long plane_offset(int b, int h, int w, int c,
                                                  int H2, int Wp, int C) {
  return (((long long)b * H2 + h) * Wp + w) * C + c;
}

// ------------------------------------------------------------------ forward

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    native_fwd_kernel(const T* __restrict__ ye, const T* __restrict__ yo,
                      const float* __restrict__ se,
                      const float* __restrict__ oe, T* __restrict__ out, int B,
                      int H2, int Wp, int Wreal, int Wout, int C) {
  const int G = C / V;
  const long long total = (long long)B * H2 * Wout * G;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(t % G) * V;
    long long rest = t / G;
    const int j = (int)(rest % Wout);
    rest /= Wout;
    const int i = (int)(rest % H2);
    const int b = (int)(rest / H2);
    float s[V], o[V], m[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = se[c0 + k];
      o[k] = oe[c0 + k];
      m[k] = -1.0f;  // taps outside the map and pad columns
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {  // rows O[i-1], E[i], O[i]
      const T* __restrict__ plane = a == 1 ? ye : yo;
      const int h = a == 0 ? i - 1 : i;
      if (h < 0) continue;
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {  // columns 2j-1, 2j, 2j+1
        const int w = 2 * j - 1 + bb;
        if (w < 0 || w >= Wreal) continue;
        float v[V];
        Io<T>::template load<V>(plane + plane_offset(b, h, w, c0, H2, Wp, C), v);
#pragma unroll
        for (int k = 0; k < V; ++k) m[k] = max_nan(m[k], bn_relu(v[k], s[k], o[k]));
      }
    }
    Io<T>::template store<V>(out + (((long long)b * H2 + i) * Wout + j) * C + c0, m);
  }
}

// ----------------------------------------------------------------- backward

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    native_bwd_kernel(const T* __restrict__ ye, const T* __restrict__ yo,
                      const T* __restrict__ gout, const float* __restrict__ se,
                      const float* __restrict__ oe, T* __restrict__ dye,
                      T* __restrict__ dyo, float* __restrict__ partial, int B,
                      int H2, int Wp, int Wreal, int Wout, int C) {
  __shared__ float red[2 * kThreads * V * kMaxWp];
  const int G = C / V;
  const int R = blockDim.x / G;  // (b, i) items in flight per CTA
  const int L = Wp * C;
  const int slot = threadIdx.x / G;
  const int c0 = (threadIdx.x % G) * V;
  float s[V], o[V], sdz[kMaxWp][V], sdzy[kMaxWp][V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = se[c0 + k];
    o[k] = oe[c0 + k];
  }
#pragma unroll
  for (int w = 0; w < kMaxWp; ++w)
#pragma unroll
    for (int k = 0; k < V; ++k) sdz[w][k] = sdzy[w][k] = 0.0f;

  const long long n_items = (long long)B * H2;
  for (long long item = (long long)blockIdx.x * R + slot; item < n_items;
       item += (long long)gridDim.x * R) {
    const int i = (int)(item % H2);
    const int b = (int)(item / H2);
    // ReLU outputs of rows ri = 0..4: O[i-1], E[i], O[i], E[i+1], O[i+1]
    // (-1 outside the map and on pad columns); y of E[i] and O[i]
    float r[5][kMaxWp][V], yv[2][kMaxWp][V];
#pragma unroll
    for (int ri = 0; ri < 5; ++ri) {
      const T* __restrict__ plane = ri % 2 == 1 ? ye : yo;
      const int h = i + (ri == 0 ? -1 : (ri < 3 ? 0 : 1));
#pragma unroll
      for (int w = 0; w < kMaxWp; ++w) {
        float v[V];
        const bool live = h >= 0 && h < H2 && w < Wreal;
        if (live) {
          Io<T>::template load<V>(plane + plane_offset(b, h, w, c0, H2, Wp, C), v);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          r[ri][w][k] = live ? bn_relu(v[k], s[k], o[k]) : -1.0f;
          if (ri == 1 || ri == 2) yv[ri - 1][w][k] = v[k];
        }
      }
    }
    // windows (i + di, j): first-max tap (a*3 + b; 9 for none: outside the
    // map, or a NaN window) and pooled gradient
    int tap[2][kMaxWout][V];
    float gv[2][kMaxWout][V];
#pragma unroll
    for (int di = 0; di < 2; ++di) {
#pragma unroll
      for (int j = 0; j < kMaxWout; ++j) {
        if (i + di < H2 && j < Wout) {
          Io<T>::template load<V>(
              gout + (((long long)b * H2 + i + di) * Wout + j) * C + c0, gv[di][j]);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float tv[3][3];
            float m = -1.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
              for (int bb = 0; bb < 3; ++bb) {
                const int w = 2 * j - 1 + bb;
                tv[a][bb] = w >= 0 ? r[2 * di + a][w < 0 ? 0 : w][k] : -1.0f;
                m = max_nan(m, tv[a][bb]);
              }
            int t = 9;
#pragma unroll
            for (int a = 2; a >= 0; --a)
#pragma unroll
              for (int bb = 2; bb >= 0; --bb) t = tv[a][bb] == m ? a * 3 + bb : t;
            tap[di][j][k] = t;
          }
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            tap[di][j][k] = 9;
            gv[di][j][k] = 0.0f;
          }
        }
      }
    }
    // sources E[i] (ri = 1) and O[i] (ri = 2): window (i + di, j) reaches
    // row ri through tap a = ri - 2*di and column w through tap b =
    // w + 1 - 2j; gradients are added in ascending (a, b) order
#pragma unroll
    for (int sr = 0; sr < 2; ++sr) {
      const int ri = sr + 1;
      T* __restrict__ dst = sr == 0 ? dye : dyo;
#pragma unroll
      for (int w = 0; w < kMaxWp; ++w) {
        if (w >= Wp) continue;
        float out[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            if (ri - a != 0 && ri - a != 2) continue;
            const int di = (ri - a) / 2;
#pragma unroll
            for (int bb = 0; bb < 3; ++bb) {
              const int twice_j = w + 1 - bb;
              if (twice_j < 0 || twice_j % 2 || twice_j / 2 >= kMaxWout) continue;
              const int j = twice_j / 2;
              if (tap[di][j][k] == a * 3 + bb) acc = __fadd_rn(acc, gv[di][j][k]);
            }
          }
          // r > 0 exactly where z > 0 on a real column (NaN compares false)
          const float dz = r[ri][w][k] > 0.0f ? acc : 0.0f;
          out[k] = __fmul_rn(dz, s[k]);
          sdz[w][k] = __fadd_rn(sdz[w][k], dz);
          sdzy[w][k] = __fadd_rn(sdzy[w][k], __fmul_rn(dz, yv[sr][w][k]));
        }
        Io<T>::template store<V>(dst + plane_offset(b, i, w, c0, H2, Wp, C), out);
      }
    }
  }
  // this CTA's per-lane sums, its row slots added in a fixed order
#pragma unroll
  for (int w = 0; w < kMaxWp; ++w) {
    if (w >= Wp) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[slot * L + w * C + c0 + k] = sdz[w][k];
      red[(R + slot) * L + w * C + c0 + k] = sdzy[w][k];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * L; t += blockDim.x) {
    const int st = t / L, l = t % L;
    float acc = 0.0f;
    for (int q = 0; q < R; ++q) acc = __fadd_rn(acc, red[(st * R + q) * L + l]);
    partial[((long long)blockIdx.x * 2 + st) * L + l] = acc;
  }
}

// partial [n_parts, 2, L] -> out [2, L]: one CTA per (statistic, lane), each
// thread a strided subset of the parts, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
    reduce_parts_kernel(const float* __restrict__ partial, int n_parts, int L,
                        float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int sl = blockIdx.x;  // s * L + l
  float acc = 0.0f;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x)
    acc = __fadd_rn(acc, partial[(long long)p * 2 * L + sl]);
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[sl] = red[0];
}

bool shape_ok(int Wp, int Wreal, int C) {
  return Wp >= 1 && Wp <= kMaxWp && Wreal >= 1 && Wreal <= Wp && C > 0 &&
         C % kVecFwd == 0 && kThreads % (C / kVecBwd) == 0;
}

}  // namespace

// ye, yo [B, H2, Wp*C], se/oe [C] fp32 -> out [B, H2, Wout, C].
extern "C" int native_fwd_launch(const void* ye, const void* yo, const void* se,
                                 const void* oe, void* out, int B, int H2,
                                 int Wp, int Wreal, int C, int n_ctas,
                                 int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(Wp, Wreal, C) || n_ctas <= 0) return (int)cudaErrorInvalidValue;
  const int Wout = (Wreal - 1) / 2 + 1;
  const float* s = static_cast<const float*>(se);
  const float* o = static_cast<const float*>(oe);
  if (dtype == kBfloat16) {
    using T = __nv_bfloat16;
    native_fwd_kernel<T, kVecFwd><<<n_ctas, kThreads, 0, stream>>>(
        static_cast<const T*>(ye), static_cast<const T*>(yo), s, o,
        static_cast<T*>(out), B, H2, Wp, Wreal, Wout, C);
  } else if (dtype == kFloat32) {
    native_fwd_kernel<float, kVecFwd><<<n_ctas, kThreads, 0, stream>>>(
        static_cast<const float*>(ye), static_cast<const float*>(yo), s, o,
        static_cast<float*>(out), B, H2, Wp, Wreal, Wout, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ye, yo [B, H2, Wp*C], g [B, H2, Wout, C], se/oe [C] -> dye, dyo like ye
// (the direct term dz*se) and sums [2, Wp*C] fp32 per lane (sum dz,
// sum dz*y); partial is scratch of n_parts * 2 * Wp*C floats.
extern "C" int native_bwd_launch(const void* ye, const void* yo, const void* g,
                                 const void* se, const void* oe, void* dye,
                                 void* dyo, void* partial, void* sums, int B,
                                 int H2, int Wp, int Wreal, int C, int n_parts,
                                 int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(Wp, Wreal, C) || n_parts <= 0) return (int)cudaErrorInvalidValue;
  const int Wout = (Wreal - 1) / 2 + 1;
  const float* s = static_cast<const float*>(se);
  const float* o = static_cast<const float*>(oe);
  float* part = static_cast<float*>(partial);
  if (dtype == kBfloat16) {
    using T = __nv_bfloat16;
    native_bwd_kernel<T, kVecBwd><<<n_parts, kThreads, 0, stream>>>(
        static_cast<const T*>(ye), static_cast<const T*>(yo),
        static_cast<const T*>(g), s, o, static_cast<T*>(dye), static_cast<T*>(dyo),
        part, B, H2, Wp, Wreal, Wout, C);
  } else if (dtype == kFloat32) {
    native_bwd_kernel<float, kVecBwd><<<n_parts, kThreads, 0, stream>>>(
        static_cast<const float*>(ye), static_cast<const float*>(yo),
        static_cast<const float*>(g), s, o, static_cast<float*>(dye),
        static_cast<float*>(dyo), part, B, H2, Wp, Wreal, Wout, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_parts_kernel<<<2 * Wp * C, kThreads, 0, stream>>>(part, n_parts, Wp * C,
                                                          static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
