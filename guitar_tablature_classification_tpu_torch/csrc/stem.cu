// Fused ResNet stem tail for Hopper (sm_90a), bound through ctypes:
// BatchNorm statistics, BN + ReLU + 3x3/s2 max-pool, and its gradient.
//
// Replaces the JAX package's three TPU kernels of
//   guitar_tablature_classification_tpu/ops/stem_pallas.py
//     _stats_pallas  -> stem_stats_launch
//     _fwd_pallas    -> stem_fwd_launch
//     _bwd_pallas    -> stem_bwd_launch
// and computes what their kernel bodies compute (ops/stem_tail.py holds the
// plain PyTorch versions, which these kernels match).
//
// Layout.  y is conv1's output in the quadrant layout [B, 2, H2, L] with
// L = 2 * W2 * C:
//   yq[b, rp, h, cp*W2*C + w*C + c] = y[b, 2h + rp, 2w + cp, c]
// i.e. row-major [B, 2 (row parity), H2, 2 (col parity), W2, C], channels
// fastest.  E[h] is row parity 0 at h, O[h] parity 1; the same for columns.
// The 3x3/s2/pad-1 pooling window of output (i, j) covers rows
// {O[i-1], E[i], O[i]} and columns {O[j-1], E[j], O[j]}; taps outside the
// map hold -1, which never wins against a ReLU output (>= 0).
//
// Rounding.  Every value is read as fp32 (bf16 -> fp32 is exact) and
//   z = y*se + oe   (__fmul_rn, then __fadd_rn: no FMA contraction; the file
//                    is also built with -fmad=false)
//   r = max(z, 0)   (NaN propagates, as jnp.maximum / torch.maximum)
// so z, r and every tie between equal taps match the plain version bit for
// bit.  bf16 ties are common, so the tie-break is part of the function: the
// gradient of a window goes to its FIRST tap equal to the max in row-major
// (a, b) order, the order of XLA's select_and_scatter.
//
// Bound (B=256, C=64, H2=W2=56, bf16; chip_smoke.py computes it per run):
// every kernel is set by bytes at 3.35 TB/s.
//   stats reads y once (411 MB)                         -> 0.123 ms
//   fwd   reads y (411 MB), writes the pool (103 MB)     -> 0.153 ms
//   bwd   reads y and g, writes dy (925 MB in all)       -> 0.276 ms
// Design (simple first; speed is later work):
// * stats: a column sum over the [B*2*H2*2*W2, C] matrix.  Each thread owns
//   8 channels (one 16-byte load) of one pixel per step and walks pixels
//   with a fixed grid stride, so its fp32 sums cover a fixed set of pixels.
// * fwd: one thread per (output pixel, 8 channels); 9 vector loads, served
//   mostly by L1/L2 (an input pixel feeds up to 4 windows).
// * bwd: one thread per (column w of 2x2 source quads, run of quad rows,
//   2 channels).  For quad (h, w) it needs the 5x5 source neighbourhood
//   {O[h-1],E[h],O[h],E[h+1],O[h+1]} x {O[w-1],...,O[w+1]} and the four
//   windows that touch the quad.  Walking down the column, the
//   neighbourhood slides by two source rows (10 new loads a quad, not 25)
//   and the windows below one quad are the windows above the next, so each
//   window's first-max tap is found once.  The up to four contributions per
//   source are added in the order the plain version adds them (tap order
//   (a, b) ascending, i.e. windows (h+1,w+1), (h+1,w), (h,w+1), (h,w)).
//   No atomics: each source is written by one thread.
// * Cross-CTA sums (stats, bwd): the GPU grid runs in no order, so each CTA
//   writes its per-channel partial sums [nCTA, 2, C] (folded to channels
//   inside the kernel) and a second pass, one CTA per (statistic, channel),
//   adds them in a fixed order.  Runs are deterministic.

#include "vec_io.cuh"

namespace {

using vec_io::bn_relu;
using vec_io::Io;
using vec_io::max_nan;

constexpr int kThreads = 256;  // threads per CTA (ops/stem_cuda.THREADS)

// Offset of (b, rp, h, cp, w, c) in the quadrant layout.
__device__ __forceinline__ long long quad_offset(int b, int rp, int h, int cp,
                                                 int w, int c, int H2, int W2,
                                                 int C) {
  return ((((long long)b * 2 + rp) * H2 + h) * 2 + cp) * (long long)(W2 * C) +
         (long long)w * C + c;
}

// Per-thread sums s[2][V] of channels c0..c0+V-1 -> this CTA's row of the
// partial-sum table [gridDim.x, 2, C], in a fixed order.  Thread t owns
// channel group t % G and lane t / G.
template <int V>
__device__ __forceinline__ void write_partials(const float (&s1)[V],
                                               const float (&s2)[V],
                                               float* red, float* partial,
                                               int C) {
  const int G = C / V;
  const int lanes = blockDim.x / G;
  const int g = threadIdx.x % G;
  const int lane = threadIdx.x / G;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[lane * C + g * V + k] = s1[k];
    red[(lanes + lane) * C + g * V + k] = s2[k];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * C; t += blockDim.x) {
    const int s = t / C, c = t % C;
    float acc = 0.0f;
    for (int l = 0; l < lanes; ++l) acc = __fadd_rn(acc, red[(s * lanes + l) * C + c]);
    partial[((long long)blockIdx.x * 2 + s) * C + c] = acc;
  }
}

// -------------------------------------------------------------------- stats

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stem_stats_kernel(const T* __restrict__ y, float* __restrict__ partial,
                      long long n_pix, int C) {
  __shared__ float red[2 * kThreads * V];
  const int G = C / V;
  const int lanes = blockDim.x / G;
  const int c0 = (threadIdx.x % G) * V;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0f;
  for (long long p = (long long)blockIdx.x * lanes + threadIdx.x / G; p < n_pix;
       p += (long long)gridDim.x * lanes) {
    float v[V];
    Io<T>::template load<V>(y + p * C + c0, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1[k] = __fadd_rn(s1[k], v[k]);
      s2[k] = __fadd_rn(s2[k], __fmul_rn(v[k], v[k]));
    }
  }
  write_partials<V>(s1, s2, red, partial, C);
}

// partial [n_parts, 2, C] -> out [2, C]: one CTA per (statistic, channel),
// each thread a strided subset of the parts, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ partial, int n_parts,
                           int C, float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int sc = blockIdx.x;  // s * C + c
  float acc = 0.0f;
  for (int k = threadIdx.x; k < n_parts; k += blockDim.x)
    acc = __fadd_rn(acc, partial[(long long)k * 2 * C + sc]);
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[sc] = red[0];
}

// ------------------------------------------------------------------ forward

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stem_fwd_kernel(const T* __restrict__ y, const float* __restrict__ se,
                    const float* __restrict__ oe, T* __restrict__ out, int B,
                    int H2, int W2, int C) {
  const int G = C / V;
  const long long total = (long long)B * H2 * W2 * G;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(t % G) * V;
    long long rest = t / G;
    const int j = (int)(rest % W2);
    rest /= W2;
    const int i = (int)(rest % H2);
    const int b = (int)(rest / H2);
    float s[V], o[V], m[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = se[c0 + k];
      o[k] = oe[c0 + k];
      m[k] = -1.0f;  // the fill of taps outside the map
    }
    // rows O[i-1], E[i], O[i]; columns O[j-1], E[j], O[j]
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int rp = a == 1 ? 0 : 1;
      const int h = a == 0 ? i - 1 : i;
      if (h < 0) continue;
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const int cp = bb == 1 ? 0 : 1;
        const int w = bb == 0 ? j - 1 : j;
        if (w < 0) continue;
        float v[V];
        Io<T>::template load<V>(y + quad_offset(b, rp, h, cp, w, c0, H2, W2, C), v);
#pragma unroll
        for (int k = 0; k < V; ++k) m[k] = max_nan(m[k], bn_relu(v[k], s[k], o[k]));
      }
    }
    Io<T>::template store<V>(out + (((long long)b * H2 + i) * W2 + j) * C + c0, m);
  }
}

// ----------------------------------------------------------------- backward

// Row (or column) index ri in 0..4 of the 5x5 neighbourhood of quad h:
// 0 O[h-1], 1 E[h], 2 O[h], 3 E[h+1], 4 O[h+1].
__device__ __forceinline__ int nb_parity(int ri) { return ri % 2 == 0 ? 1 : 0; }
__device__ __forceinline__ int nb_shift(int ri) { return (ri + 1) / 2 - 1; }

// One neighbourhood row ri of quad (h, w): its five ReLU outputs (-1
// outside the map), and y itself for the quad's own two columns.
template <typename T, int V>
__device__ __forceinline__ void load_nb_row(const T* __restrict__ y, int b,
                                            int h, int w, int ri, int c0,
                                            int H2, int W2, int C,
                                            const float (&s)[V],
                                            const float (&o)[V],
                                            float (&r)[5][V], float (&ys)[2][V]) {
  const int hh = h + nb_shift(ri);
#pragma unroll
  for (int ci = 0; ci < 5; ++ci) {
    const int ww = w + nb_shift(ci);
    float v[V];
    if (hh >= 0 && hh < H2 && ww >= 0 && ww < W2) {
      Io<T>::template load<V>(
          y + quad_offset(b, nb_parity(ri), hh, nb_parity(ci), ww, c0, H2, W2, C), v);
#pragma unroll
      for (int k = 0; k < V; ++k) r[ci][k] = bn_relu(v[k], s[k], o[k]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = 0.0f;
        r[ci][k] = -1.0f;
      }
    }
    if (ci >= 1 && ci <= 2) {
#pragma unroll
      for (int k = 0; k < V; ++k) ys[ci - 1][k] = v[k];
    }
  }
}

// Tap (a*3 + b, row-major) of the first maximum of window (di, dj) of the
// neighbourhood, per channel; 9 when no tap equals the max (a NaN window).
template <int V>
__device__ __forceinline__ void first_max_tap(const float (&r)[5][5][V], int di,
                                              int dj, int (&tap)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float m = -1.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) m = max_nan(m, r[2 * di + a][2 * dj + bb][k]);
    int t = 9;
#pragma unroll
    for (int a = 2; a >= 0; --a)
#pragma unroll
      for (int bb = 2; bb >= 0; --bb)
        t = r[2 * di + a][2 * dj + bb][k] == m ? a * 3 + bb : t;
    tap[k] = t;
  }
}

// A thread owns one column w of 2x2 source quads, for a run of up to
// `run` quad rows, and 2 channels.  Walking down the run, the 5x5
// neighbourhood shifts by two source rows, so each quad loads 10 new values
// instead of 25, and the two windows below the quad (h+1, w..w+1) become the
// next quad's windows above it: their first-max taps and gradients carry
// over.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stem_bwd_kernel(const T* __restrict__ y, const T* __restrict__ gout,
                    const float* __restrict__ se, const float* __restrict__ oe,
                    T* __restrict__ dy, float* __restrict__ partial, int B,
                    int H2, int W2, int C, int run) {
  __shared__ float red[2 * kThreads * V];
  const int G = C / V;
  const int lanes = blockDim.x / G;
  const int c0 = (threadIdx.x % G) * V;
  float s[V], o[V], sdz[V], sdzy[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = se[c0 + k];
    o[k] = oe[c0 + k];
    sdz[k] = sdzy[k] = 0.0f;
  }
  const int runs_per_column = (H2 + run - 1) / run;
  const long long n_items = (long long)B * runs_per_column * W2;
  for (long long item = (long long)blockIdx.x * lanes + threadIdx.x / G;
       item < n_items; item += (long long)gridDim.x * lanes) {
    const int w = (int)(item % W2);
    const int h0 = (int)((item / W2) % runs_per_column) * run;
    const int b = (int)(item / ((long long)W2 * runs_per_column));
    const int h1 = min(H2, h0 + run);
    float r[5][5][V];   // ReLU outputs of the neighbourhood, -1 outside
    float ys[5][2][V];  // y at the quad's two columns, per neighbourhood row
    int tap[2][2][V];   // first-max tap of window (h+di, w+dj)
    float g[2][2][V];   // its pooled gradient (0 outside the map)
#pragma unroll
    for (int ri = 0; ri < 5; ++ri)
      load_nb_row<T, V>(y, b, h0, w, ri, c0, H2, W2, C, s, o, r[ri], ys[ri]);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const int j = w + dj;
      if (j < W2) {
        Io<T>::template load<V>(gout + (((long long)b * H2 + h0) * W2 + j) * C + c0,
                                g[0][dj]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) g[0][dj][k] = 0.0f;
      }
      first_max_tap<V>(r, 0, dj, tap[0][dj]);
    }
    for (int h = h0; h < h1; ++h) {
      if (h > h0) {  // slide down two source rows
#pragma unroll
        for (int ri = 0; ri < 3; ++ri)
#pragma unroll
          for (int ci = 0; ci < 5; ++ci)
#pragma unroll
            for (int k = 0; k < V; ++k) r[ri][ci][k] = r[ri + 2][ci][k];
#pragma unroll
        for (int ri = 0; ri < 3; ++ri)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
#pragma unroll
            for (int k = 0; k < V; ++k) ys[ri][cc][k] = ys[ri + 2][cc][k];
        load_nb_row<T, V>(y, b, h, w, 3, c0, H2, W2, C, s, o, r[3], ys[3]);
        load_nb_row<T, V>(y, b, h, w, 4, c0, H2, W2, C, s, o, r[4], ys[4]);
#pragma unroll
        for (int dj = 0; dj < 2; ++dj)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            tap[0][dj][k] = tap[1][dj][k];
            g[0][dj][k] = g[1][dj][k];
          }
      }
      // the windows below the quad, (h+1, w+dj)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const int i = h + 1, j = w + dj;
        if (i < H2 && j < W2) {
          Io<T>::template load<V>(gout + (((long long)b * H2 + i) * W2 + j) * C + c0,
                                  g[1][dj]);
          first_max_tap<V>(r, 1, dj, tap[1][dj]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            g[1][dj][k] = 0.0f;
            tap[1][dj][k] = 9;
          }
        }
      }
      // contributions to the quad's sources (neighbourhood rows 1-2, cols
      // 1-2), windows in the order (1,1), (1,0), (0,1), (0,0): ascending tap
      // order for every source, as the plain version adds
      float acc[2][2][V];
#pragma unroll
      for (int sr = 0; sr < 2; ++sr)
#pragma unroll
        for (int sc = 0; sc < 2; ++sc)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[sr][sc][k] = 0.0f;
#pragma unroll
      for (int di = 1; di >= 0; --di) {
#pragma unroll
        for (int dj = 1; dj >= 0; --dj) {
#pragma unroll
          for (int sr = 0; sr < 2; ++sr) {
#pragma unroll
            for (int sc = 0; sc < 2; ++sc) {
              const int a = sr + 1 - 2 * di, bb = sc + 1 - 2 * dj;
              if (a < 0 || a > 2 || bb < 0 || bb > 2) continue;
#pragma unroll
              for (int k = 0; k < V; ++k)
                if (tap[di][dj][k] == a * 3 + bb)
                  acc[sr][sc][k] = __fadd_rn(acc[sr][sc][k], g[di][dj][k]);
            }
          }
        }
      }
#pragma unroll
      for (int sr = 0; sr < 2; ++sr) {
#pragma unroll
        for (int sc = 0; sc < 2; ++sc) {
          float out[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            // r > 0 exactly where z > 0 (r = max(z, 0), NaN compares false)
            const float dz = r[sr + 1][sc + 1][k] > 0.0f ? acc[sr][sc][k] : 0.0f;
            out[k] = __fmul_rn(dz, s[k]);
            sdz[k] = __fadd_rn(sdz[k], dz);
            sdzy[k] = __fadd_rn(sdzy[k], __fmul_rn(dz, ys[sr + 1][sc][k]));
          }
          Io<T>::template store<V>(dy + quad_offset(b, sr, h, sc, w, c0, H2, W2, C), out);
        }
      }
    }
  }
  write_partials<V>(sdz, sdzy, red, partial, C);
}

constexpr int kVecStats = 8;  // ops/stem_cuda.VEC_STATS
constexpr int kVecFwd = 8;    // ops/stem_cuda.VEC_FWD
constexpr int kVecBwd = 2;    // ops/stem_cuda.VEC_BWD

using vec_io::kBfloat16;
using vec_io::kFloat32;

bool shape_ok(int C, int V) {
  return C > 0 && C % V == 0 && kThreads % (C / V) == 0;
}

}  // namespace

// y [n_pix, C] -> sums [2, C] fp32 (sum, sum of squares); partial is
// scratch of n_parts * 2 * C floats.
extern "C" int stem_stats_launch(const void* y, void* partial, void* sums,
                                 long long n_pix, int C, int n_parts,
                                 int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(C, kVecStats) || n_parts <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == kBfloat16) {
    stem_stats_kernel<__nv_bfloat16, kVecStats><<<n_parts, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<float*>(partial), n_pix, C);
  } else if (dtype == kFloat32) {
    stem_stats_kernel<float, kVecStats><<<n_parts, kThreads, 0, stream>>>(
        static_cast<const float*>(y), static_cast<float*>(partial), n_pix, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), n_parts, C, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// y [B, 2, H2, 2*W2*C], se/oe [C] fp32 -> out [B, H2, W2*C].
extern "C" int stem_fwd_launch(const void* y, const void* se, const void* oe,
                               void* out, int B, int H2, int W2, int C,
                               int n_ctas, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(C, kVecFwd) || n_ctas <= 0) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(se);
  const float* o = static_cast<const float*>(oe);
  if (dtype == kBfloat16) {
    stem_fwd_kernel<__nv_bfloat16, kVecFwd><<<n_ctas, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(y), s, o, static_cast<__nv_bfloat16*>(out),
        B, H2, W2, C);
  } else if (dtype == kFloat32) {
    stem_fwd_kernel<float, kVecFwd><<<n_ctas, kThreads, 0, stream>>>(
        static_cast<const float*>(y), s, o, static_cast<float*>(out), B, H2, W2, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y [B, 2, H2, 2*W2*C], g [B, H2, W2*C], se/oe [C] -> dy like y and
// sums [2, C] fp32 (sum dz, sum dz*y); partial is scratch of
// n_parts * 2 * C floats.
extern "C" int stem_bwd_launch(const void* y, const void* g, const void* se,
                               const void* oe, void* dy, void* partial,
                               void* sums, int B, int H2, int W2, int C,
                               int run, int n_parts, int dtype,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(C, kVecBwd) || n_parts <= 0 || run <= 0)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(se);
  const float* o = static_cast<const float*>(oe);
  if (dtype == kBfloat16) {
    stem_bwd_kernel<__nv_bfloat16, kVecBwd><<<n_parts, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(g),
        s, o, static_cast<__nv_bfloat16*>(dy), static_cast<float*>(partial),
        B, H2, W2, C, run);
  } else if (dtype == kFloat32) {
    stem_bwd_kernel<float, kVecBwd><<<n_parts, kThreads, 0, stream>>>(
        static_cast<const float*>(y), static_cast<const float*>(g), s, o,
        static_cast<float*>(dy), static_cast<float*>(partial), B, H2, W2, C,
        run);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), n_parts, C, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}
