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
// Bound (B=4096, H2=24, Wp=6, Wreal=5, C=64, bf16; chip_smoke.py computes
// it per run): bytes at 3.35 TB/s, the real columns of y read.
//   fwd reads ye, yo (126 MB), writes the pool (37.7 MB)        -> 0.049 ms
//   bwd reads ye, yo, g (164 MB), writes dye, dyo (151 MB)      -> 0.094 ms
// Both kernels are persistent: a pooling window never crosses images, so a
// CTA owns whole images and needs no halo.  A fixed grid (ops/
// stem_native_cuda.fwd_plan, bwd_plan; fixed by the plan, not by the card)
// walks runs of consecutive images at one slice of channels (64 bf16 or 32
// fp32 at C = 64: 128 bytes a pixel), staging an image's real columns of ye
// and yo once, as 16-byte cp.async copies (30,720 bytes at the model shape;
// the pad column is never read), into a two-stage ring: image n+1 is copied
// while image n computes.  The loops step their indices by a fixed stride:
// no division in them.
// * fwd (replacing one thread per pooled output and 8 channels that made
//   nine 16-byte loads through L1/L2, about 83 KB loaded for an image's
//   30.7 KB, and recomputed the affine at each of nine taps): about 396
//   CTAs, three an SM (__launch_bounds__(256, 3): <= 85 registers; 73,728
//   shared bytes a CTA).  For each image:
//   1. Each thread turns the vectors it copied into r = max(y*se + oe, 0)
//      in place, once a source, rounded to T (its se and oe in registers:
//      a thread keeps one vector of the slice).  Rounding is monotone, so
//      the max of rounded r is the rounded max, bit for bit; NaN stays NaN.
//   2. One thread per (pooled row i, vector) takes each real column's max
//      over rows O[i-1], E[i], O[i], then each window's over columns 2j-1,
//      2j, 2j+1 (max.NaN on bf16x2 pairs or fp32), and writes the row's
//      Wout outputs as 16-byte stores: an image's output [H2, Wout, C] is
//      one contiguous block.  Taps outside the map and the pad column are
//      left out, which is what their -1 did: every window holds its real
//      centre column, and r >= 0 or NaN.
// * bwd: about 264 CTAs, two an SM (a constant, so the sums' order is the
//   same on every card).  For each image:
//   1. Staging: the image's pooled gradient g (9,216 bytes at the model
//      shape) is staged with its rows.
//   2. One thread per (window, 16-byte vector of channels) finds the
//      window's first-max tap once: z recomputed from y in shared memory,
//      a row-major scan that takes a tap only where z exceeds every tap
//      before it (starting from 0 at the first real tap: r = max(z, 0)
//      makes a window of non-positive z a tie at 0), NaN kept by
//      max.NaN.f32 (a NaN window takes no tap).  One byte a window and
//      channel.  Windows are taken column by column, so a warp's windows
//      share their column and its taps outside the map are left out at
//      compile time (first_max_taps<LEFT, RIGHT>), not masked a channel at
//      a time.
//   3. One thread per (row i, column pair 2q and 2q+1, vector) gathers the
//      2x2 sources E[i][2q], E[i][2q+1], O[i][2q], O[i][2q+1] from their
//      <= 4 windows (i+1, q+1), (i+1, q), (i, q+1), (i, q) in that order,
//      which is ascending tap order, applies the ReLU and real-column mask
//      and writes dye, dyo with 16-byte stores (the pad column as 0*se, as
//      the plain version writes it, with none of its gather computed).
//      Each source is written by one thread; no atomics.  A thread keeps
//      one column pair and one vector for the whole run, so it keeps the
//      per-lane sums of dz and dz*y of those lanes in registers; a warp's
//      threads share the column pair.
//   256 threads: __launch_bounds__(256, 2) holds a thread to 128 registers
//   (at 288 threads, two CTAs an SM hold a thread to 96 registers, and the
//   kernel spilled and ran slower); se and oe are read from shared
//   memory (held in registers, they spilled).  With its global loads removed
//   the kernel keeps most of its time: it is bound by its instructions
//   (the recomputed affine and the gather's compare-and-adds) more than by
//   memory.
// * Per-lane sums of dz and dz*y: each CTA adds its threads' sums in a
//   fixed order into its row of a partial table [n_parts, 2, L] (L = Wp*C;
//   its slice's lanes), and a second pass adds the rows of each lane in a
//   fixed order.  Runs are deterministic.

#include "frame_mma.cuh"
#include "vec_io.cuh"

namespace {

using vec_io::bn_relu;
using vec_io::kBfloat16;
using vec_io::kFloat32;

constexpr int kThreads = 256;  // reduce_parts_kernel
constexpr int kMaxWp = 6;      // widest plane (ops/stem_native_cuda.MAX_WP)

// ---------------------------------------------------- shared by both kernels

// jnp.maximum's NaN-propagating maximum as one instruction.
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

// fp32 v[0..V) rounded to T, as one 16-byte vector.
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

// (row, col) of a row-major walk over rows of `cols`, advanced by a fixed
// stride of dq rows and dr columns (stride = dq * cols + dr, dr < cols):
// the loops' indices with no division.
__device__ __forceinline__ void step(int& row, int& col, int dq, int dr, int cols) {
  col += dr;
  row += dq;
  if (col >= cols) {
    col -= cols;
    ++row;
  }
}

// ------------------------------------------------------------------ forward

constexpr int kFwdThreads = 256;  // ops/stem_native_cuda.FWD_THREADS
constexpr int kFwdMinCtas = 3;    // CTAs an SM must hold: <= 85 registers
constexpr int kFwdStages = 2;     // images in the ring (ops/stem_native_cuda.FWD_STAGES)

// max.NaN of two 16-byte vectors of T, lane by lane (exact).
template <typename T>
__device__ __forceinline__ uint4 vmax_nan(const uint4& a, const uint4& b);
template <>
__device__ __forceinline__ uint4 vmax_nan<__nv_bfloat16>(const uint4& a, const uint4& b) {
  uint4 d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d.x) : "r"(a.x), "r"(b.x));
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d.y) : "r"(a.y), "r"(b.y));
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d.z) : "r"(a.z), "r"(b.z));
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d.w) : "r"(a.w), "r"(b.w));
  return d;
}
template <>
__device__ __forceinline__ uint4 vmax_nan<float>(const uint4& a, const uint4& b) {
  const auto m = [](uint32_t x, uint32_t y) {
    return __float_as_uint(max_nan_1(__uint_as_float(x), __uint_as_float(y)));
  };
  return make_uint4(m(a.x, b.x), m(a.y, b.y), m(a.z, b.z), m(a.w, b.w));
}

// r = max(y*se + oe, 0) of a 16-byte vector of T (NaN kept), rounded to T.
template <typename T>
__device__ __forceinline__ uint4 relu_vec(const uint4& q, const float (&s)[16 / sizeof(T)],
                                          const float (&o)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  float r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) r[k] = bn_relu(lane<T>(q, k), s[k], o[k]);
  return pack<T, V>(r);
}

// A CTA (group, slice) -- block index group * (C / CS) + slice -- walks
// images [group * ipc, min(B, (group + 1) * ipc)) at channels
// [slice * CS, (slice + 1) * CS), CS = NV * V, through a ring of kFwdStages
// images.  ipc and the dynamic shared bytes are the plan's
// (ops/stem_native_cuda.fwd_plan; fwd_plan_ok checks the bytes).  A stage
// is ys [2 planes][H2][Wp][NV] uint4, real columns filled.  Thread tid keeps
// vector u = tid % NV of the slice in every phase, so its se and oe stay in
// registers; it copies, and then turns into r, the (row, real column)
// pairs tid / NV, + kFwdThreads / NV, ... of an image (its own copies need
// no barrier once it has waited for them), and pools rows tid / NV,
// + kFwdThreads / NV, ...
template <typename T, int NV>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinCtas)
    native_fwd_kernel(const T* __restrict__ ye, const T* __restrict__ yo,
                      const float* __restrict__ se, const float* __restrict__ oe,
                      T* __restrict__ out, int B, int H2, int Wp, int Wreal, int Wout,
                      int C, int ipc) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CS = NV * V;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);

  const int n_slices = C / CS;
  const int slice = blockIdx.x % n_slices;
  const int group = blockIdx.x / n_slices;
  const int b0 = group * ipc;
  const int n_img = min(B, b0 + ipc) - b0;
  const int stage_vecs = 2 * H2 * Wp * NV;
  const int tid = threadIdx.x;
  const int u = tid % NV;
  const int c0 = slice * CS + u * V;
  const long long row_len = (long long)Wp * C;
  float s[V], o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = se[c0 + k];
    o[k] = oe[c0 + k];
  }

  // the thread's first (row r = plane * H2 + h, real column w) pair and
  // its stride, found once
  const int p_step = kFwdThreads / NV;
  const int r0 = tid / NV / Wreal, w0 = tid / NV % Wreal;
  const int p_dq = p_step / Wreal, p_dr = p_step % Wreal;
  auto stage = [&](int n, int buf) {
    uint4* ys = ring + buf * stage_vecs;
    const long long img = (long long)(b0 + n) * H2;
    for (int r = r0, w = w0; r < 2 * H2; step(r, w, p_dq, p_dr, Wreal)) {
      const bool odd = r >= H2;
      const int h = odd ? r - H2 : r;
      frame_mma::cp_async16(ys + (r * Wp + w) * NV + u,
                            (odd ? yo : ye) + (img + h) * row_len + (long long)w * C + c0);
    }
    frame_mma::cp_async_commit();
  };

  if (n_img > 0) stage(0, 0);
  for (int n = 0; n < n_img; ++n) {
    frame_mma::cp_async_wait<0>();
    __syncthreads();  // image n has landed; image n-1's pooling is done
    if (n + 1 < n_img) stage(n + 1, (n + 1) % kFwdStages);
    uint4* ys = ring + (n % kFwdStages) * stage_vecs;

    // 1. r = max(y*se + oe, 0) once a source, in place, held in T: the
    //    rounding to T is monotone, so the max of the rounded r is the
    //    rounded max (NaN stays NaN)
    for (int r = r0, w = w0; r < 2 * H2; step(r, w, p_dq, p_dr, Wreal)) {
      uint4* q = ys + (r * Wp + w) * NV + u;
      *q = relu_vec<T>(*q, s, o);
    }
    __syncthreads();

    // 2. pooled row i: each real column's max over rows O[i-1], E[i], O[i],
    //    then each window's over columns 2j-1, 2j, 2j+1; taps outside the
    //    map and the pad column are left out (they hold -1, which no r
    //    loses to, and every window holds its real centre column)
    T* dst = out + (long long)(b0 + n) * H2 * Wout * C + c0;
    for (int i = tid / NV; i < H2; i += p_step) {
      const uint4* e_row = ys + i * Wp * NV + u;
      const uint4* o_row = e_row + H2 * Wp * NV;
      uint4 m[3];
#pragma unroll
      for (int w = 0; w < kMaxWp; ++w) {
        if (w >= Wreal) continue;
        uint4 cm = vmax_nan<T>(e_row[w * NV], o_row[w * NV]);
        if (i > 0) cm = vmax_nan<T>(cm, o_row[(w - Wp) * NV]);
        if (w == 0) {
          m[0] = cm;
        } else if (w % 2 == 0) {  // the centre of window w / 2
          m[w / 2] = vmax_nan<T>(m[w / 2], cm);
        } else {  // the right of window w / 2, the left of window w / 2 + 1
          m[w / 2] = vmax_nan<T>(m[w / 2], cm);
          if (w / 2 + 1 < 3) m[w / 2 + 1] = cm;
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j < Wout) *reinterpret_cast<uint4*>(dst + ((long long)i * Wout + j) * C) = m[j];
    }
  }
}

// The dynamic shared bytes the forward kernel addresses: kFwdStages images'
// rows at Wp column slots.
long long fwd_smem_need(int H2, int Wp, int cs, int elem) {
  return (long long)kFwdStages * 2 * H2 * Wp * (cs * elem / 16) * 16;
}

// Whether the plan's (cs, smem) fit the forward kernel at (H2, Wp).
bool fwd_plan_ok(int H2, int Wp, int cs, int elem, int smem) {
  const int nv = cs * elem / 16;
  return H2 > 0 && Wp >= 1 && Wp <= kMaxWp && cs * elem % 16 == 0 &&
         (nv == 1 || nv == 2 || nv == 4 || nv == 8) && smem >= fwd_smem_need(H2, Wp, cs, elem);
}

// The forward kernel for this dtype and slice (cs channels), or nullptr.
const void* fwd_kernel_for(int dtype, int cs) {
  const int nv = cs * (dtype == kBfloat16 ? 2 : 4) / 16;
  if (dtype == kBfloat16) {
    using T = __nv_bfloat16;
    switch (nv) {
      case 1: return (const void*)native_fwd_kernel<T, 1>;
      case 2: return (const void*)native_fwd_kernel<T, 2>;
      case 4: return (const void*)native_fwd_kernel<T, 4>;
      case 8: return (const void*)native_fwd_kernel<T, 8>;
    }
  } else if (dtype == kFloat32) {
    switch (nv) {
      case 1: return (const void*)native_fwd_kernel<float, 1>;
      case 2: return (const void*)native_fwd_kernel<float, 2>;
      case 4: return (const void*)native_fwd_kernel<float, 4>;
      case 8: return (const void*)native_fwd_kernel<float, 8>;
    }
  }
  return nullptr;
}

// ----------------------------------------------------------------- backward

constexpr int kBwdThreads = 256;  // ops/stem_native_cuda.BWD_THREADS
constexpr int kBwdMinCtas = 2;    // CTAs an SM must hold: <= 128 registers

// The first-max taps of V channels, one byte each (9: no tap).
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

// Windows of a row for the widest Wreal <= Wp: shared memory is sized by it.
__host__ __device__ __forceinline__ int window_slots(int Wp) { return (Wp - 1) / 2 + 1; }

// Step 2 for window (i, j): the first-max tap of each of the V channels of
// vector u.  LEFT, RIGHT: whether columns 2j-1 and 2j+1 are real (uniform
// over a warp, which takes windows of one j, where H2 % (32 / NV) == 0).
template <typename T, int NV, bool LEFT, bool RIGHT>
__device__ __forceinline__ typename TapBytes<16 / sizeof(T)>::type first_max_taps(
    const uint4* __restrict__ ys, int i, int j, int H2, int Wp, int u,
    const float* __restrict__ s, const float* __restrict__ o) {
  constexpr int V = 16 / sizeof(T);
  const bool top = i > 0;
  uint4 tv[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      if ((bb == 0 && !LEFT) || (bb == 2 && !RIGHT)) continue;
      const int r = (a == 1 ? 0 : H2) + (a == 0 ? i - 1 : i);
      tv[a][bb] = a > 0 || top ? ys[(r * Wp + 2 * j - 1 + bb) * NV + u] : make_uint4(0, 0, 0, 0);
    }
  // the first real tap holds every window whose z are all <= 0
  const uint32_t first_real = (top ? 0 : 3) + (LEFT ? 0 : 1);
  uint32_t tap[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float m = 0.0f;
    uint32_t first = first_real;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        if ((bb == 0 && !LEFT) || (bb == 2 && !RIGHT)) continue;  // outside the map
        const float z = __fadd_rn(__fmul_rn(lane<T>(tv[a][bb], k), s[k]), o[k]);
        const float zt = a > 0 || top ? z : -1.0f;
        first = zt > m ? (uint32_t)(a * 3 + bb) : first;
        m = max_nan_1(m, zt);
      }
    tap[k] = m != m ? 9u : first;  // a NaN window takes no tap
  }
  return TapBytes<V>::make(tap);
}

// Step 3 for the quad of row i at columns 2q, 2q+1: each source adds its
// windows' gradients in ascending tap order, windows (i+1, q+1), (i+1, q),
// (i, q+1), (i, q); then the ReLU and column masks, dy = dz*se into out and
// the lane sums.  REAL1: column 2q+1 is real (else its dz is 0 and nothing
// of it is computed; uniform over a warp at the model shape).
template <typename T, bool REAL1>
__device__ __forceinline__ void gather_quad(
    const typename TapBytes<16 / sizeof(T)>::type (&tw)[2][2], const uint4 (&gw)[2][2],
    const uint4 (&yv)[2][2], bool real0, const float* __restrict__ s,
    const float* __restrict__ o, float (&sdz)[2][16 / sizeof(T)],
    float (&sdzy)[2][16 / sizeof(T)], float (&out)[2][2][16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  using Tap = TapBytes<V>;
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
        if (sc == 1 && !REAL1) {
          out[sr][sc][k] = __fmul_rn(0.0f, s[k]);  // a pad column, as the plain version
          continue;
        }
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
        const float z = __fadd_rn(__fmul_rn(yk, s[k]), o[k]);
        const float dz = (sc == 1 || real0) && z > 0.0f ? acc : 0.0f;
        out[sr][sc][k] = __fmul_rn(dz, s[k]);
        sdz[sc][k] = __fadd_rn(sdz[sc][k], dz);
        sdzy[sc][k] = __fadd_rn(sdzy[sc][k], __fmul_rn(dz, yk));
      }
  }
}

// A CTA (group, slice) -- block index group * (C / CS) + slice -- walks
// images [group * ipc, min(B, (group + 1) * ipc)) at channels
// [slice * CS, (slice + 1) * CS), CS = NV * V (NV 16-byte vectors a pixel,
// V = 16 / sizeof(T)); its gather threads split an image's rows into RG
// groups.  ipc, RG and the dynamic shared bytes are the plan's
// (ops/stem_native_cuda.bwd_plan; bwd_smem_need checks the bytes).  Dynamic
// shared memory, sized for Wout = window_slots(Wp):
//   two stages, each
//     ys [2 planes][H2][Wp][NV] uint4: the image's rows, real columns only
//     gs [H2][Wout][NV] uint4: its pooled gradient
//   taps [H2][Wout][NV] TapBytes<V>::type: each window's first-max tap
// and, once the walk is done, red [2][RG][Wp][CS] fp32 over the same bytes;
// static: aff [2][CS] fp32, the slice's se and oe.
template <typename T, int NV>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinCtas)
    native_bwd_kernel(const T* __restrict__ ye, const T* __restrict__ yo,
                      const T* __restrict__ gout, const float* __restrict__ se,
                      const float* __restrict__ oe, T* __restrict__ dye,
                      T* __restrict__ dyo, float* __restrict__ partial, int B,
                      int H2, int Wp, int Wreal, int Wout, int C, int ipc, int RG) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CS = NV * V;
  using Tap = TapBytes<V>;
  using TapT = typename Tap::type;
  extern __shared__ __align__(16) unsigned char smem[];

  const int n_slices = C / CS;
  const int slice = blockIdx.x % n_slices;
  const int group = blockIdx.x / n_slices;
  const int b0 = group * ipc;
  const int n_img = min(B, b0 + ipc) - b0;
  const int y_vecs = 2 * H2 * Wp * NV;
  const int stage_vecs = y_vecs + H2 * window_slots(Wp) * NV;
  TapT* taps = reinterpret_cast<TapT*>(reinterpret_cast<uint4*>(smem) + 2 * stage_vecs);
  const int tid = threadIdx.x;
  const int u = tid % NV;  // this thread's vector of the slice, in every phase
  const int c0 = slice * CS + u * V;
  const long long row_len = (long long)Wp * C;

  // 1. one image's real columns of ye, yo and its g -> stage buf.  The y
  //    copies walk rows r = plane * H2 + h of rv real vectors; each
  //    thread's first (row, vector) and its stride are found once.
  const int rv = Wreal * NV;
  const int r0 = tid / rv, e0 = tid % rv, y_dq = kBwdThreads / rv, y_dr = kBwdThreads % rv;
  auto stage = [&](int n, int buf) {
    uint4* ys = reinterpret_cast<uint4*>(smem) + buf * stage_vecs;
    uint4* gs = ys + y_vecs;
    const long long img = (long long)(b0 + n) * H2;
    for (int r = r0, e = e0; r < 2 * H2; step(r, e, y_dq, y_dr, rv)) {
      const bool odd = r >= H2;
      const int h = odd ? r - H2 : r, w = e / NV, v = e % NV;
      frame_mma::cp_async16(ys + r * Wp * NV + e,
                            (odd ? yo : ye) + (img + h) * row_len + (long long)w * C +
                                slice * CS + v * V);
    }
    for (int t = tid; t < H2 * Wout * NV; t += kBwdThreads) {
      const int pix = t / NV, v = t % NV;  // pix = h * Wout + j
      frame_mma::cp_async16(gs + t, gout + (img * Wout + pix) * (long long)C + slice * CS + v * V);
    }
    frame_mma::cp_async_commit();
  };

  if (n_img > 0) stage(0, 0);
  __shared__ __align__(16) float aff[2][CS];  // se, oe of the slice
  for (int t = tid; t < 2 * CS; t += kBwdThreads)
    aff[t / CS][t % CS] = (t < CS ? se : oe)[slice * CS + t % CS];
  const float* s_ = aff[0] + u * V;
  const float* o_ = aff[1] + u * V;
  // the tap phase's first window (j-major: i fastest) and its stride
  const int j0 = tid / NV / H2, i0 = tid / NV % H2;
  const int w_dq = kBwdThreads / NV / H2, w_dr = kBwdThreads / NV % H2;
  // the gather's fixed lanes: column pair q, vector u; rows rg, rg + RG, ...
  const int Wq = (Wp + 1) / 2;
  const int q = tid / (RG * NV), rg = tid / NV % RG;
  float sdz[2][V], sdzy[2][V];
#pragma unroll
  for (int sc = 0; sc < 2; ++sc)
#pragma unroll
    for (int k = 0; k < V; ++k) sdz[sc][k] = sdzy[sc][k] = 0.0f;

  for (int n = 0; n < n_img; ++n) {
    const int b = b0 + n;
    frame_mma::cp_async_wait<0>();
    __syncthreads();  // image n has landed; image n-1's gather is done
    if (n + 1 < n_img) stage(n + 1, (n + 1) & 1);
    const uint4* ys = reinterpret_cast<const uint4*>(smem) + (n & 1) * stage_vecs;
    const uint4* gs = ys + y_vecs;

    // 2. each window's first-max tap, once: window (i, j) reads rows
    //    O[i-1], E[i], O[i] at columns 2j-1, 2j, 2j+1
    for (int j = j0, i = i0; j < Wout; step(j, i, w_dq, w_dr, H2)) {
      const bool left = j > 0, right = 2 * j + 1 < Wreal;
      TapT t;
      if (left && right)
        t = first_max_taps<T, NV, true, true>(ys, i, j, H2, Wp, u, s_, o_);
      else if (left)
        t = first_max_taps<T, NV, true, false>(ys, i, j, H2, Wp, u, s_, o_);
      else if (right)
        t = first_max_taps<T, NV, false, true>(ys, i, j, H2, Wp, u, s_, o_);
      else
        t = first_max_taps<T, NV, false, false>(ys, i, j, H2, Wp, u, s_, o_);
      taps[(i * Wout + j) * NV + u] = t;
    }
    __syncthreads();

    // 3. each 2x2 source quad (E/O[i] at columns 2q, 2q+1) gathers from its
    //    <= 4 windows (gather_quad) and writes dy with 16-byte stores
    if (q < Wq) {
      const bool real0 = 2 * q < Wreal, real1 = 2 * q + 1 < Wreal, has1 = 2 * q + 1 < Wp;
      for (int i = rg; i < H2; i += RG) {
        const bool below = i + 1 < H2;
        TapT tw[2][2];
        uint4 gw[2][2];
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const bool in = (di == 0 || below) && q + dj < Wout;
            const int at = ((i + di) * Wout + q + dj) * NV + u;
            tw[di][dj] = in ? taps[at] : Tap::none();
            gw[di][dj] = in ? gs[at] : make_uint4(0, 0, 0, 0);
          }
        uint4 yv[2][2];
#pragma unroll
        for (int sr = 0; sr < 2; ++sr)
#pragma unroll
          for (int sc = 0; sc < 2; ++sc) {
            const bool real = sc == 0 ? real0 : real1;
            yv[sr][sc] = real ? ys[((sr * H2 + i) * Wp + 2 * q + sc) * NV + u]
                              : make_uint4(0, 0, 0, 0);
          }
        float out[2][2][V];
        if (real1)
          gather_quad<T, true>(tw, gw, yv, real0, s_, o_, sdz, sdzy, out);
        else
          gather_quad<T, false>(tw, gw, yv, real0, s_, o_, sdz, sdzy, out);
        const long long row = ((long long)b * H2 + i) * row_len + (long long)(2 * q) * C + c0;
#pragma unroll
        for (int sr = 0; sr < 2; ++sr) {
          T* __restrict__ dst = sr == 0 ? dye : dyo;
          *reinterpret_cast<uint4*>(dst + row) = pack<T, V>(out[sr][0]);
          if (has1) *reinterpret_cast<uint4*>(dst + row + C) = pack<T, V>(out[sr][1]);
        }
      }
    }
  }

  // 4. this CTA's lane sums -> partial[group, 2, Wp*C] at its slice: the
  //    row groups added in turn
  __syncthreads();  // the ring is no longer read
  float* red = reinterpret_cast<float*>(smem);  // [2][RG][Wp][CS]
  const int lanes = Wp * CS;
  if (q < Wq) {
#pragma unroll
    for (int sc = 0; sc < 2; ++sc) {
      if (2 * q + sc >= Wp) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int l = (2 * q + sc) * CS + u * V + k;
        red[rg * lanes + l] = sdz[sc][k];
        red[(RG + rg) * lanes + l] = sdzy[sc][k];
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < 2 * lanes; t += kBwdThreads) {
    const int st = t / lanes, l = t - st * lanes;
    float acc = 0.0f;
    for (int r = 0; r < RG; ++r) acc = __fadd_rn(acc, red[(st * RG + r) * lanes + l]);
    const int w = l / CS, c = l - w * CS;
    partial[((long long)group * 2 + st) * Wp * C + w * C + slice * CS + c] = acc;
  }
}

// The dynamic shared bytes the backward kernel addresses with RG row
// groups: two stages and the taps, or the lane sums' table where that is
// larger.  A check of the plan's smem_bytes, which is the one the launch uses.
long long bwd_smem_need(int H2, int Wp, int cs, int elem, int RG) {
  const long long nv = cs * elem / 16, wg = window_slots(Wp);
  const long long stage = (2LL * H2 * Wp + H2 * wg) * nv * 16;
  const long long ring = 2 * stage + H2 * wg * cs;
  const long long red = 2LL * RG * Wp * cs * 4;
  return ring > red ? ring : red;
}

// Whether the plan's (cs, RG, smem) fit the kernel at (H2, Wp): cs is one to
// eight 16-byte vectors, every gather lane (column pair, vector, row group)
// has a thread, and smem covers what the kernel addresses.
bool bwd_plan_ok(int H2, int Wp, int cs, int elem, int RG, int smem) {
  const int nv = cs * elem / 16;
  return H2 > 0 && Wp >= 1 && Wp <= kMaxWp && cs * elem % 16 == 0 && RG >= 1 &&
         (long long)RG * ((Wp + 1) / 2) * nv <= kBwdThreads &&
         smem >= bwd_smem_need(H2, Wp, cs, elem, RG);
}

template <typename T, int NV>
const void* bwd_kernel_of() {
  return (const void*)native_bwd_kernel<T, NV>;
}

// The kernel for this dtype and slice (cs channels), or nullptr.
const void* bwd_kernel_for(int dtype, int cs) {
  const int nv = cs * (dtype == kBfloat16 ? 2 : 4) / 16;
  if (dtype == kBfloat16) {
    using T = __nv_bfloat16;
    switch (nv) {
      case 1: return bwd_kernel_of<T, 1>();
      case 2: return bwd_kernel_of<T, 2>();
      case 4: return bwd_kernel_of<T, 4>();
      case 8: return bwd_kernel_of<T, 8>();
    }
  } else if (dtype == kFloat32) {
    switch (nv) {
      case 1: return bwd_kernel_of<float, 1>();
      case 2: return bwd_kernel_of<float, 2>();
      case 4: return bwd_kernel_of<float, 4>();
      case 8: return bwd_kernel_of<float, 8>();
    }
  }
  return nullptr;
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
  return Wp >= 1 && Wp <= kMaxWp && Wreal >= 1 && Wreal <= Wp && C > 0 && C % 8 == 0;
}

// The kernel's registers, local (spill) bytes, shared bytes (static +
// dynamic), threads and resident CTAs per SM at smem dynamic bytes, into
// info[0..5).  Returns 0, or the cudaError_t of the failed query.
int kernel_info(const void* kernel, int threads, int smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes + smem;
  info[3] = threads;
  info[4] = ctas;
  return 0;
}

}  // namespace

// ye, yo [B, H2, Wp*C], se/oe [C] fp32 -> out [B, H2, Wout, C].  cs
// channels a CTA (one to eight 16-byte vectors a pixel), ipc images a CTA
// and smem dynamic shared bytes: the plan's (ops/stem_native_cuda.fwd_plan),
// checked here.  ye, yo and out are 16-byte aligned.
extern "C" int native_fwd_launch(const void* ye, const void* yo, const void* se,
                                 const void* oe, void* out, int B, int H2, int Wp,
                                 int Wreal, int C, int cs, int ipc, int smem, int dtype,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* kernel = fwd_kernel_for(dtype, cs);
  const int elem = dtype == kBfloat16 ? 2 : 4;
  if (!shape_ok(Wp, Wreal, C) || kernel == nullptr || B <= 0 || ipc <= 0 || C % cs ||
      !fwd_plan_ok(H2, Wp, cs, elem, smem))
    return (int)cudaErrorInvalidValue;
  int Wout = (Wreal - 1) / 2 + 1;
  const long long grid = (long long)((B + ipc - 1) / ipc) * (C / cs);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&ye, (void*)&yo, (void*)&se, (void*)&oe, (void*)&out,
                  (void*)&B, (void*)&H2, (void*)&Wp, (void*)&Wreal, (void*)&Wout,
                  (void*)&C, (void*)&ipc};
  err = cudaLaunchKernel(kernel, dim3((unsigned)grid), dim3(kFwdThreads), args, smem, stream);
  return (int)err;
}

// The forward kernel as the card runs it for this dtype and plan (cs, smem
// as native_fwd_launch takes them): info = {registers a thread, local
// (spill) bytes a thread, shared bytes a CTA (static + dynamic), threads a
// CTA, resident CTAs per SM}.  Returns 0, or the cudaError_t of the failed
// query.
extern "C" int native_fwd_kernel_info(int H2, int Wp, int cs, int smem, int dtype, int* info) {
  const void* kernel = fwd_kernel_for(dtype, cs);
  if (kernel == nullptr || !fwd_plan_ok(H2, Wp, cs, dtype == kBfloat16 ? 2 : 4, smem))
    return (int)cudaErrorInvalidValue;
  return kernel_info(kernel, kFwdThreads, smem, info);
}

// ye, yo [B, H2, Wp*C], g [B, H2, Wout, C], se/oe [C] -> dye, dyo like ye
// (the direct term dz*se) and sums [2, Wp*C] fp32 per lane (sum dz,
// sum dz*y); partial is scratch of ceil(B / ipc) * 2 * Wp*C floats.  cs
// channels a CTA (one to eight 16-byte vectors a pixel), ipc images a CTA,
// rg row groups and smem dynamic shared bytes: the plan's
// (ops/stem_native_cuda.bwd_plan), checked here.  Every pointer is 16-byte
// aligned.
extern "C" int native_bwd_launch(const void* ye, const void* yo, const void* g,
                                 const void* se, const void* oe, void* dye,
                                 void* dyo, void* partial, void* sums, int B,
                                 int H2, int Wp, int Wreal, int C, int cs, int ipc,
                                 int rg, int smem, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* kernel = bwd_kernel_for(dtype, cs);
  const int elem = dtype == kBfloat16 ? 2 : 4;
  if (!shape_ok(Wp, Wreal, C) || kernel == nullptr || B <= 0 || ipc <= 0 || C % cs ||
      !bwd_plan_ok(H2, Wp, cs, elem, rg, smem))
    return (int)cudaErrorInvalidValue;
  int Wout = (Wreal - 1) / 2 + 1;
  const int n_parts = (B + ipc - 1) / ipc;
  const long long grid = (long long)n_parts * (C / cs);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  float* part = static_cast<float*>(partial);
  void* args[] = {(void*)&ye, (void*)&yo, (void*)&g, (void*)&se, (void*)&oe,
                  (void*)&dye, (void*)&dyo, (void*)&part, (void*)&B, (void*)&H2,
                  (void*)&Wp, (void*)&Wreal, (void*)&Wout, (void*)&C,
                  (void*)&ipc, (void*)&rg};
  err = cudaLaunchKernel(kernel, dim3((unsigned)grid), dim3(kBwdThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  reduce_parts_kernel<<<2 * Wp * C, kThreads, 0, stream>>>(part, n_parts, Wp * C,
                                                          static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// The backward kernel as the card runs it for this dtype and plan (cs, rg,
// smem as native_bwd_launch takes them): info = {registers a thread, local
// (spill) bytes a thread, shared bytes a CTA (static + dynamic), threads a
// CTA, resident CTAs per SM}.  Returns 0, or the cudaError_t of the failed
// query.
extern "C" int native_bwd_kernel_info(int H2, int Wp, int cs, int rg, int smem, int dtype,
                                      int* info) {
  const void* kernel = bwd_kernel_for(dtype, cs);
  if (kernel == nullptr || !bwd_plan_ok(H2, Wp, cs, dtype == kBfloat16 ? 2 : 4, rg, smem))
    return (int)cudaErrorInvalidValue;
  return kernel_info(kernel, kBwdThreads, smem, info);
}
