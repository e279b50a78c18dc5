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
// Design:
// * stats: a column sum over the [B*2*H2*2*W2, C] matrix.  Each thread owns
//   8 channels (one 16-byte load) of one pixel per step and walks pixels
//   with a fixed grid stride, so its fp32 sums cover a fixed set of pixels.
// * fwd: one thread per (output pixel, 8 channels); 9 vector loads, served
//   mostly by L1/L2 (an input pixel feeds up to 4 windows).
// * bwd: a CTA of 256 threads owns one image, a band of R = 8 quad rows
//   (ops/stem_cuda.BWD_BAND; fewer where a band would not fit two CTAs an
//   SM) and a slice of two 16-byte vectors of channels a pixel (16 bf16 or
//   8 fp32 channels; 8 where C = 8 in bf16).
//   1. It stages the slice of its 2R+3 source rows O[h0-1], E[h0], O[h0],
//      ..., E[h1], O[h1] and its R+1 gradient rows into shared memory with
//      16-byte cp.async copies, each vector once.  At the flagship shape
//      (B=256, H2=W2=56, C=64, bf16) that is 68,096 + 16,128 bytes a CTA,
//      with 8,064 bytes of taps: 92,288 bytes, two CTAs an SM.  The halo
//      rows add 3/16 to y's reads and 1/8 to g's (1.02 GB of traffic in
//      all against 0.925 GB), and consecutive CTAs are the channel slices,
//      then the bands, of one image, so the halo rows and the other slices
//      of each 128-byte line are read again while they are in L2.
//   2. One thread per (window, vector) finds each window's first-max tap
//      once, from y in shared memory (BN affine and ReLU recomputed, taps
//      outside the map -1), and stores it as one byte per channel.
//   3. One thread per (2x2 source quad, vector) gathers each source's
//      gradient from its <= 4 windows in ascending tap order, windows
//      (h+1, w+1), (h+1, w), (h, w+1), (h, w) (the plain version adds in
//      tap order, and the order of fp32 adds is part of the result), applies
//      the ReLU mask and writes dy with 16-byte stores.  Each source is
//      written by one thread; no atomics.
//   The kernel's __launch_bounds__(256, 2) holds it to 128 registers.  On
//   the card it runs at about half its byte bound and is bound by its
//   instructions, not by memory (with its global loads removed it takes
//   the same time): the recomputed affine of the tap phase and the
//   gather's compares are the work left.
// * Cross-CTA sums (stats, bwd): the GPU grid runs in no order, so each CTA
//   writes its per-channel partial sums (stats: a row [nCTA, 2, C], folded
//   to channels inside the kernel; bwd: its slice of row b * n_bands + band
//   of [B * n_bands, 2, C]) and a second pass, one CTA per (statistic,
//   channel), adds them in a fixed order.  Runs are deterministic.

#include "frame_mma.cuh"
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

constexpr int kBwdThreads = 256;
constexpr int kBwdMinCtas = 2;    // CTAs an SM must hold: <= 128 registers

// jnp.maximum's NaN-propagating maximum as one instruction (max_nan's
// value for non-NaN operands; a NaN gives a NaN, whose payload no
// comparison reads).  bn_relu's max_nan(z, 0) compiles to one instruction
// as it is; with max_nan in the window-max chain the kernel ran 7 % slower.
__device__ __forceinline__ float max_nan_1(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ uint32_t word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Value k of a 16-byte vector of T, as fp32 (exact).
template <typename T>
__device__ __forceinline__ float lane(const uint4& q, int k);
template <>
__device__ __forceinline__ float lane<__nv_bfloat16>(const uint4& q, int k) {
  const uint32_t w = word(q, k / 2);
  return __uint_as_float(k % 2 ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float lane<float>(const uint4& q, int k) {
  return __uint_as_float(word(q, k));
}

// Writes fp32 v[0..V) rounded to T into a 16-byte vector.
template <typename T, int V>
__device__ __forceinline__ uint4 pack(const float (&v)[V]);
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16, 8>(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ uint4 pack<float, 4>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

// The first-max taps of V channels, one byte each.
template <int V>
struct TapBytes;
template <>
struct TapBytes<8> {
  using type = uint2;
  static __device__ __forceinline__ uint32_t byte(const uint2& t, int k) {
    return ((k < 4 ? t.x : t.y) >> (8 * (k % 4))) & 0xffu;
  }
  static __device__ __forceinline__ uint2 make(const uint32_t (&b)[8]) {
    return make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                      b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
  }
  static __device__ __forceinline__ uint2 none() { return make_uint2(0x09090909u, 0x09090909u); }
};
template <>
struct TapBytes<4> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t byte(uint32_t t, int k) {
    return (t >> (8 * k)) & 0xffu;
  }
  static __device__ __forceinline__ uint32_t make(const uint32_t (&b)[4]) {
    return b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
  }
  static __device__ __forceinline__ uint32_t none() { return 0x09090909u; }
};

// Advances (row, col) of a row-major walk by kBwdThreads.
__device__ __forceinline__ void step(int& row, int& col, int cols) {
  col += kBwdThreads;
  while (col >= cols) {
    col -= cols;
    ++row;
  }
}

// A CTA owns image b, a band of quad rows [h0, h1) (h1 - h0 <= R), and a
// slice of cs = NV * V channels (NV 16-byte vectors a pixel; V = 16 /
// sizeof(T)).  Block index = (b * n_bands + band) * (C / cs) + slice.
// Dynamic shared memory (ops/stem_cuda.bwd_plan mirrors it):
//   ys   [2(h1-h0)+3 slots][2 col parities][W2][cs] T: slot s holds image
//        row 2*h0 - 1 + s (O[h0-1], E[h0], O[h0], ..., E[h1], O[h1]); rows
//        outside the map are not loaded and read as the -1 fill
//   gs   [n_win][W2][cs] T: pooled gradient of window rows h0..last
//   taps [n_win][W2][cs] uint8: first-max tap of each window and channel
// with last = min(h1, H2 - 1), n_win = last - h0 + 1.
template <typename T, int NV>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinCtas)
    stem_bwd_kernel(const T* __restrict__ y, const T* __restrict__ gout,
                    const float* __restrict__ se, const float* __restrict__ oe,
                    T* __restrict__ dy, float* __restrict__ partial, int H2, int W2,
                    int C, int R, int n_bands) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CS = NV * V;
  using Tap = TapBytes<V>;
  using TapT = typename Tap::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kBwdThreads / 32][CS];

  const int n_slices = C / CS;
  const int slice = blockIdx.x % n_slices;
  const int band = (blockIdx.x / n_slices) % n_bands;
  const int b = blockIdx.x / (n_slices * n_bands);
  const int h0 = band * R, h1 = min(H2, h0 + R);
  const int last = min(h1, H2 - 1);
  const int n_win = last - h0 + 1;
  const int n_slots = 2 * (h1 - h0) + 3;
  const int pix_vecs = W2 * NV;       // vectors of one column-parity half
  const int row_vecs = 2 * pix_vecs;  // of one source row
  uint4* ys = reinterpret_cast<uint4*>(smem);
  uint4* gs = ys + n_slots * row_vecs;
  TapT* taps = reinterpret_cast<TapT*>(gs + n_win * pix_vecs);
  const int tid = threadIdx.x;
  const int v = tid % NV;  // this thread's vector of the slice, fixed
  const int c0 = slice * CS + v * V;
  const long long row_len = 2LL * W2 * C;

  // 1. stage: every 16-byte vector of the band's rows, once
  const int pix_t = tid / pix_vecs, pix_p = tid % pix_vecs;
  {
    const int q0 = 2 * h0 - 1;
    for (int s = tid / row_vecs, p = tid % row_vecs; s < n_slots; step(s, p, row_vecs)) {
      const int q = q0 + s;  // image row 2h + row parity
      if (q < 0 || q >= 2 * H2) continue;
      const long long row = ((long long)b * 2 + (q & 1)) * H2 + (q >> 1);
      frame_mma::cp_async16(ys + s * row_vecs + p,
                            y + row * row_len + (long long)(p / NV) * C + slice * CS +
                                (p % NV) * V);
    }
    for (int i = pix_t, p = pix_p; i < n_win; step(i, p, pix_vecs)) {
      frame_mma::cp_async16(gs + i * pix_vecs + p,
                            gout + ((long long)b * H2 + h0 + i) * (W2 * (long long)C) +
                                (long long)(p / NV) * C + slice * CS + (p % NV) * V);
    }
    frame_mma::cp_async_commit();
  }
  float s_[V], o_[V], sdz[V], sdzy[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_[k] = se[c0 + k];
    o_[k] = oe[c0 + k];
    sdz[k] = sdzy[k] = 0.0f;
  }
  frame_mma::cp_async_wait<0>();
  __syncthreads();

  // 2. each window's first-max tap, once: window (h0 + i, j) reads slots
  //    2i..2i+2 (rows O[h-1], E[h], O[h]) at columns O[j-1], E[j], O[j]
  for (int i = pix_t, p = pix_p; i < n_win; step(i, p, pix_vecs)) {
    const int j = p / NV;
    const bool top = h0 + i > 0, left = j > 0;
    uint4 t[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const int col = bb == 1 ? j : (bb == 0 ? j - 1 : j) + W2;
        t[a][bb] = ys[(2 * i + a) * row_vecs + col * NV + v];
      }
    uint32_t tap[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float r[3][3];
      float m = -1.0f;  // the fill of taps outside the map
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          const bool in = (a > 0 || top) && (bb > 0 || left);
          r[a][bb] = in ? bn_relu(lane<T>(t[a][bb], k), s_[k], o_[k]) : -1.0f;
          m = max_nan_1(m, r[a][bb]);
        }
      uint32_t first = 9;  // no tap equals a NaN maximum
#pragma unroll
      for (int a = 2; a >= 0; --a)
#pragma unroll
        for (int bb = 2; bb >= 0; --bb) first = r[a][bb] == m ? a * 3 + bb : first;
      tap[k] = first;
    }
    taps[i * pix_vecs + p] = Tap::make(tap);
  }
  __syncthreads();

  // 3. each source gathers from its <= 4 windows in ascending tap order:
  //    windows (h+1, w+1), (h+1, w), (h, w+1), (h, w); then the ReLU mask,
  //    dy = dz*se (16-byte stores) and the channel sums
  for (int hl = pix_t, p = pix_p; hl < h1 - h0; step(hl, p, pix_vecs)) {
    const int h = h0 + hl, w = p / NV;
    const bool below = h + 1 < H2, right = w + 1 < W2;
    TapT tw[2][2];
    uint4 gw[2][2];
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const bool in = (di == 0 || below) && (dj == 0 || right);
        const int at = in ? (hl + di) * pix_vecs + p + dj * NV : 0;
        tw[di][dj] = in ? taps[at] : Tap::none();
        gw[di][dj] = in ? gs[at] : make_uint4(0, 0, 0, 0);
      }
    uint4 yv[2][2];
#pragma unroll
    for (int sr = 0; sr < 2; ++sr)
#pragma unroll
      for (int sc = 0; sc < 2; ++sc)
        yv[sr][sc] = ys[(2 * hl + 1 + sr) * row_vecs + (sc * W2 + w) * NV + v];
    float out[2][2][V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      uint32_t tk[2][2];
      float gk[2][2];
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          tk[di][dj] = Tap::byte(tw[di][dj], k);
          gk[di][dj] = lane<T>(gw[di][dj], k);
        }
#pragma unroll
      for (int sr = 0; sr < 2; ++sr)
#pragma unroll
        for (int sc = 0; sc < 2; ++sc) {
          float acc = 0.0f;
#pragma unroll
          for (int di = 1; di >= 0; --di)
#pragma unroll
            for (int dj = 1; dj >= 0; --dj) {
              const int a = sr + 1 - 2 * di, bb = sc + 1 - 2 * dj;
              if (a < 0 || bb < 0) continue;  // the source is not in this window
              if (tk[di][dj] == (uint32_t)(a * 3 + bb)) acc = __fadd_rn(acc, gk[di][dj]);
            }
          const float yk = lane<T>(yv[sr][sc], k);
          // z > 0 exactly where r = max(z, 0) > 0 (NaN compares false)
          const float z = __fadd_rn(__fmul_rn(yk, s_[k]), o_[k]);
          const float dz = z > 0.0f ? acc : 0.0f;
          out[sr][sc][k] = __fmul_rn(dz, s_[k]);
          sdz[k] = __fadd_rn(sdz[k], dz);
          sdzy[k] = __fadd_rn(sdzy[k], __fmul_rn(dz, yk));
        }
    }
#pragma unroll
    for (int sr = 0; sr < 2; ++sr)
#pragma unroll
      for (int sc = 0; sc < 2; ++sc)
        *reinterpret_cast<uint4*>(dy + quad_offset(b, sr, h, sc, w, c0, H2, W2, C)) =
            pack<T, V>(out[sr][sc]);
  }

  // 4. this CTA's channel sums -> partial[b * n_bands + band, 2, C] at its
  //    slice, in a fixed order: a butterfly over the lanes that share v,
  //    then the warps in turn
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int off = 16; off >= NV; off /= 2) {
      sdz[k] = __fadd_rn(sdz[k], __shfl_xor_sync(0xffffffffu, sdz[k], off));
      sdzy[k] = __fadd_rn(sdzy[k], __shfl_xor_sync(0xffffffffu, sdzy[k], off));
    }
  const int warp = tid / 32, lane_id = tid % 32;
  if (lane_id < NV) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][warp][v * V + k] = sdz[k];
      red[1][warp][v * V + k] = sdzy[k];
    }
  }
  __syncthreads();
  if (tid < 2 * CS) {
    const int s = tid / CS, c = tid % CS;
    float acc = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kBwdThreads / 32; ++wp) acc = __fadd_rn(acc, red[s][wp][c]);
    partial[(((long long)b * n_bands + band) * 2 + s) * C + slice * CS + c] = acc;
  }
}

// Dynamic shared bytes of a CTA of a full band of R quad rows
// (ops/stem_cuda.bwd_plan computes the same).
int bwd_smem_bytes(int H2, int W2, int cs, int elem, int R) {
  const int r = R < H2 ? R : H2;
  const int n_win = r + 1 < H2 ? r + 1 : H2;
  const int pix_bytes = W2 * cs * elem;  // one column-parity half row
  return (2 * r + 3) * 2 * pix_bytes + n_win * pix_bytes + n_win * W2 * cs;
}

constexpr int kVecStats = 8;  // ops/stem_cuda.VEC_STATS
constexpr int kVecFwd = 8;    // ops/stem_cuda.VEC_FWD

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
// B * ceil(H2 / R) * 2 * C floats.  cs channels a CTA (two 16-byte vectors
// a pixel, or one where C = 8 in bf16), R quad rows a band.
extern "C" int stem_bwd_launch(const void* y, const void* g, const void* se,
                               const void* oe, void* dy, void* partial,
                               void* sums, int B, int H2, int W2, int C,
                               int cs, int R, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int elem = dtype == kBfloat16 ? 2 : 4;
  if ((dtype != kBfloat16 && dtype != kFloat32) || B <= 0 || H2 <= 0 || W2 <= 0 ||
      R <= 0 || cs <= 0 || C % cs || (cs * elem != 16 && cs * elem != 32))
    return (int)cudaErrorInvalidValue;
  const int n_bands = (H2 + R - 1) / R;
  const long long grid = (long long)B * n_bands * (C / cs);
  const int smem = bwd_smem_bytes(H2, W2, cs, elem, R);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(se);
  const float* o = static_cast<const float*>(oe);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == kBfloat16 && cs * elem == 32) {
    auto kernel = stem_bwd_kernel<__nv_bfloat16, 2>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(int)grid, kBwdThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(g), s, o,
        static_cast<__nv_bfloat16*>(dy), part, H2, W2, C, R, n_bands);
  } else if (dtype == kBfloat16) {
    auto kernel = stem_bwd_kernel<__nv_bfloat16, 1>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(int)grid, kBwdThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(g), s, o,
        static_cast<__nv_bfloat16*>(dy), part, H2, W2, C, R, n_bands);
  } else if (cs * elem == 32) {
    auto kernel = stem_bwd_kernel<float, 2>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(int)grid, kBwdThreads, smem, stream>>>(
        static_cast<const float*>(y), static_cast<const float*>(g), s, o,
        static_cast<float*>(dy), part, H2, W2, C, R, n_bands);
  } else {
    return (int)cudaErrorInvalidValue;  // fp32 slices are two vectors (C % 8 == 0)
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, kThreads, 0, stream>>>(part, B * n_bands, C,
                                                         static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// The backward kernel as the card runs it for this dtype, slice width and
// band: info = {registers a thread, local (spill) bytes a thread, shared
// bytes a CTA (static + dynamic), threads a CTA, resident CTAs per SM}.
// Returns 0, or the cudaError_t of the failed query.
extern "C" int stem_bwd_kernel_info(int H2, int W2, int cs, int R, int dtype, int* info) {
  const int elem = dtype == kBfloat16 ? 2 : 4;
  const void* kernel = dtype == kBfloat16
                           ? (cs * elem == 32 ? (const void*)stem_bwd_kernel<__nv_bfloat16, 2>
                                              : (const void*)stem_bwd_kernel<__nv_bfloat16, 1>)
                           : (const void*)stem_bwd_kernel<float, 2>;
  const int smem = bwd_smem_bytes(H2, W2, cs, elem, R);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kBwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes + smem;
  info[3] = kBwdThreads;
  info[4] = ctas;
  return 0;
}
