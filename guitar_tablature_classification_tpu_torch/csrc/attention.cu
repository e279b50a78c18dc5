// Fused multi-head attention for Hopper (sm_90a), bound through ctypes:
// softmax(Q K^T * Dh^-1/2) V and its gradient, head dim 64.
//
// Replaces the JAX package's two TPU kernels of
//   guitar_tablature_classification_tpu/ops/attention_pallas.py
//     _attention_fwd_hd  -> attn_fwd_launch
//     _attention_bwd_hd  -> attn_bwd_launch
// and computes what they compute, not their block structure
// (ops/attention.py holds the plain PyTorch version they are held to).
//
// Layout.  Every operand is a [B, N, H, 64] view with its own element
// strides for batch, token and head, and the 64 head-dim values contiguous:
// q, k and v are read as strided views of the QKV projection's [B, N, 3*H*64]
// output, with no copy.  Outputs (o, dq, dk, dv) are contiguous [B, N, H, 64]
// in the input dtype; the log-sum-exp residual and the backward's row dots
// are [B, H, N] fp32.
//
// Numerics (attention_pallas.py:79-101, 159-197).  Every value is read as
// fp32 (bf16 -> fp32 is exact), products accumulate in fp32 (SIMT FFMA at
// both dtypes, so fp32 inputs get fp32-grade products), the softmax runs in
// fp32, and the weights P and the score gradient dS are rounded to the input
// dtype before they enter a product, as the TPU kernels round them before
// their bf16 GEMMs.  Keys past N take no weight; query rows past N add
// nothing to dk and dv.
//
// Bound (B=64, H=6, N=785, Dh=64, bf16; chip_smoke.py computes it per run):
// operations on the tensor cores at 989 TFLOP/s.
//   fwd: 4*B*H*N^2*Dh = 60.6 GFLOP -> 0.061 ms (bytes: 154 MB, 0.046 ms)
//   bwd: 10*B*H*N^2*Dh = 151 GFLOP -> 0.153 ms
// The B*H*N^2 = 237 M exponentials of each pass take ~0.06 ms on the SMs'
// special-function units, the same order as the tensor-core bound.  These
// kernels run on the FP32 pipes (SIMT), so they sit far above that bound:
// this first version is simple and right; mma.sync / wgmma is later work.
//
// Design.  The TPU kernel keeps one head's whole K and V resident in VMEM
// and pads N to its 128-row tile; at fp32 that is ~400 KB, past a CTA's
// 227 KB of shared memory, so here K and V stream through shared memory in
// 64-row tiles with an online softmax (running max and sum in fp32).
// * fwd: one CTA per (64-query tile, head, batch).  Per key tile the 256
//   threads (16 x 16) each own a 4 x 4 block of scores (queries ty+16i,
//   keys tx+16j), reduce the row max and sum across the 16 threads of a row
//   with shuffles, and write the rounded weights to shared memory for the
//   P V product, where each thread owns 4 queries x 4 head-dim columns.
//   It also writes lse = max + log(sum) per (row, head).
// * bwd: the TPU kernel adds dk and dv into output blocks that later grid
//   steps revisit, which a GPU grid cannot do.  The deterministic form here
//   uses no atomics: (1) one warp per (row, head) forms
//   D = rowsum(dO * O) = rowsum(dP * P); (2) one CTA per (64-key tile, head,
//   batch) loops over every query tile, recomputes S^T and dP^T for its keys
//   and accumulates dV = P^T dO and dK = scale * dS^T Q in registers;
//   (3) one CTA per (64-query tile, head, batch) loops over every key tile
//   for dQ = scale * dS K.  Each output element is summed by one thread in a
//   fixed order, so two runs give identical gradients.  The backward
//   recomputes S with the forward's exact operation order (an fmaf chain
//   over the head dim, then * scale), so exp(S - lse) sums to 1 as in the
//   forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kTile = 64;      // queries or keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads (ops/attention_cuda.THREADS)
constexpr int kLd = kD + 1;    // padded shared row (floats): conflict-free columns
constexpr int kTileFloats = kTile * kLd;

// A [B, N, H, 64] operand: element strides of batch, token and head.
struct View {
  const void* ptr;
  long long sb, sn, sh;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // values per 16-byte load
  static __device__ __forceinline__ void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float from_float(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Rows [n0, n0 + 64) of head h in batch b -> tile[row * kLd + col] as fp32;
// rows at or past n are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const View& v, int b, int h,
                                          int n0, int n) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kChunks = kD / kVec;
  const T* base = static_cast<const T*>(v.ptr) + b * v.sb + h * v.sh;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int row = i / kChunks, col = (i % kChunks) * kVec;
    float vals[kVec];
    if (n0 + row < n) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + (long long)(n0 + row) * v.sn + col);
      Io<T>::unpack(raw, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
    float* dst = tile + row * kLd + col;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = vals[e];
  }
}

// Entries [n0, n0 + 64) of a [B, H, N] fp32 row vector; past n: 0 (those
// rows are masked wherever the values are used).
__device__ __forceinline__ void load_rows(float* dst, const float* src, int n0, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = n0 + i < n ? src[n0 + i] : 0.f;
}

// Sum or max over the 16 threads of a score row (lanes tx = lane % 16).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = sum_d a[(ty + 16i)][d] * b[(tx + 16j)][d], an fmaf chain over d
// in ascending order (the forward and both backward passes share it, so the
// recomputed scores equal the forward's bit for bit).
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int ty, int tx,
                                         float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][j] += sum_r w[(ty + 16i)][r] * m[r][(tx + 16j)] over the 64 rows r.
__device__ __forceinline__ void tile_gemm(const float* w, const float* m, int ty, int tx,
                                          float (&acc)[4][4]) {
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w[(ty + 16 * i) * kLd + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = m[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Write a thread's 4 x 4 block (rows r0 + ty + 16i, columns tx + 16j, times
// `mul`) of head h to a contiguous [B, N, H, 64] output.
template <typename T>
__device__ __forceinline__ void store_block(T* out, const float (&acc)[4][4], float mul,
                                            int b, int h, int r0, int n, int heads,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
    T* dst = out + (((long long)b * n + row) * heads + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[tx + 16 * j] = Io<T>::from_float(acc[i][j] * mul);
  }
}

// ------------------------------------------------------------------ forward

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(View q, View k, View v, T* out, float* lse, int n, int heads,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;             // [64 queries][kLd]
  float* ks = qs + kTileFloats;  // [64 keys][kLd]
  float* vs = ks + kTileFloats;  // [64 keys][kLd]
  float* ps = vs + kTileFloats;  // [64 queries][kLd] weights, rounded to T
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T>(qs, q, b, h, q0, n);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile's ks / vs / ps are read
    load_tile<T>(ks, k, b, h, k0, n);
    load_tile<T>(vs, v, b, h, k0, n);
    __syncthreads();
    float s[4][4];
    tile_dot(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < n ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // finite: the first tile holds key 0, and m only grows
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // 0 for masked keys
        sum += p;
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = Io<T>::round(p);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_gemm(ps, vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    T* dst = out + (((long long)b * n + row) * heads + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[tx + 16 * j] = Io<T>::from_float(acc[i][j] / l[i]);
    if (tx == 0) lse[((long long)b * heads + h) * n + row] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------------- backward

// (1) dsum[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one warp per row.
template <typename T>
__global__ void attn_rowdot_kernel(View g, View o, float* dsum, int batch, int n,
                                   int heads) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * n * heads) return;
  const int h = (int)(row % heads);
  const int t = (int)((row / heads) % n);
  const int b = (int)(row / ((long long)heads * n));
  const T* gp = static_cast<const T*>(g.ptr) + b * g.sb + t * g.sn + h * g.sh;
  const T* op = static_cast<const T*>(o.ptr) + b * o.sb + t * o.sn + h * o.sh;
  float s = Io<T>::to_float(gp[lane]) * Io<T>::to_float(op[lane]);
  s = fmaf(Io<T>::to_float(gp[lane + 32]), Io<T>::to_float(op[lane + 32]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dsum[((long long)b * heads + h) * n + t] = s;
}

// (2) dK and dV of one 64-key tile, looping over every query tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kv_kernel(View q, View k, View v, View g, const float* lse,
                       const float* dsum, T* dk, T* dv, int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // [64 keys][kLd], resident
  float* vs = ks + kTileFloats;    // [64 keys][kLd], resident
  float* qs = vs + kTileFloats;    // [64 queries][kLd]
  float* gs = qs + kTileFloats;    // [64 queries][kLd]
  float* pts = gs + kTileFloats;   // [64 keys][kLd] P^T rounded to T
  float* dsts = pts + kTileFloats;  // [64 keys][kLd] dS^T rounded to T
  float* ls = dsts + kTileFloats;   // [64] lse of the query tile
  float* ds = ls + kTile;           // [64] row dots of the query tile
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row_base = ((long long)b * heads + h) * n;

  load_tile<T>(ks, k, b, h, k0, n);
  load_tile<T>(vs, v, b, h, k0, n);
  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous tile's qs / gs / pts / dsts are read
    load_tile<T>(qs, q, b, h, q0, n);
    load_tile<T>(gs, g, b, h, q0, n);
    load_rows(ls, lse + row_base, q0, n);
    load_rows(ds, dsum + row_base, q0, n);
    __syncthreads();
    // rows: keys ty + 16i; columns: queries tx + 16j
    float s[4][4], dp[4][4];
    tile_dot(ks, qs, ty, tx, s);
    tile_dot(vs, gs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool key_ok = k0 + ty + 16 * i < n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = key_ok && q0 + c < n ? expf(s[i][j] * scale - ls[c]) : 0.f;
        pts[(ty + 16 * i) * kLd + c] = Io<T>::round(p);
        dsts[(ty + 16 * i) * kLd + c] = Io<T>::round(p * (dp[i][j] - ds[c]));
      }
    }
    __syncthreads();
    tile_gemm(pts, gs, ty, tx, acc_v);   // dV += P^T dO
    tile_gemm(dsts, qs, ty, tx, acc_k);  // dK += dS^T Q (scaled at the end)
  }
  store_block<T>(dv, acc_v, 1.f, b, h, k0, n, heads, ty, tx);
  store_block<T>(dk, acc_k, scale, b, h, k0, n, heads, ty, tx);
}

// (3) dQ of one 64-query tile, looping over every key tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_q_kernel(View q, View k, View v, View g, const float* lse,
                      const float* dsum, T* dq, int n, int heads, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [64 queries][kLd], resident
  float* gs = qs + kTileFloats;   // [64 queries][kLd], resident
  float* ks = gs + kTileFloats;   // [64 keys][kLd]
  float* vs = ks + kTileFloats;   // [64 keys][kLd]
  float* dss = vs + kTileFloats;  // [64 queries][kLd] dS rounded to T
  float* ls = dss + kTileFloats;  // [64]
  float* ds = ls + kTile;         // [64]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row_base = ((long long)b * heads + h) * n;

  load_tile<T>(qs, q, b, h, q0, n);
  load_tile<T>(gs, g, b, h, q0, n);
  load_rows(ls, lse + row_base, q0, n);
  load_rows(ds, dsum + row_base, q0, n);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile's ks / vs / dss are read
    load_tile<T>(ks, k, b, h, k0, n);
    load_tile<T>(vs, v, b, h, k0, n);
    __syncthreads();
    // rows: queries ty + 16i; columns: keys tx + 16j
    float s[4][4], dp[4][4];
    tile_dot(qs, ks, ty, tx, s);
    tile_dot(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool row_ok = q0 + r < n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = row_ok && k0 + c < n ? expf(s[i][j] * scale - ls[r]) : 0.f;
        dss[r * kLd + c] = Io<T>::round(p * (dp[i][j] - ds[r]));
      }
    }
    __syncthreads();
    tile_gemm(dss, ks, ty, tx, acc);  // dQ += dS K (scaled at the end)
  }
  store_block<T>(dq, acc, scale, b, h, q0, n, heads, ty, tx);
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kKvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kQSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);

View make_view(const void* ptr, const long long* strides) {
  return View{ptr, strides[0], strides[1], strides[2]};
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const long long* st,
                void* out, void* lse, int batch, int n, int heads, float scale,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  attn_fwd_kernel<T><<<grid, kThreads, kFwdSmem, stream>>>(
      make_view(q, st), make_view(k, st + 3), make_view(v, st + 6),
      static_cast<T*>(out), static_cast<float*>(lse), n, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* g, const long long* st, const void* lse, void* dsum,
                void* dq, void* dk, void* dv, int batch, int n, int heads, float scale,
                cudaStream_t stream) {
  const View qv = make_view(q, st), kv = make_view(k, st + 3), vv = make_view(v, st + 6);
  const View ov = make_view(o, st + 9), gv = make_view(g, st + 12);
  const long long rows = (long long)batch * n * heads;
  const int warps_per_cta = kThreads / 32;
  attn_rowdot_kernel<T><<<(unsigned)((rows + warps_per_cta - 1) / warps_per_cta),
                          kThreads, 0, stream>>>(gv, ov, static_cast<float*>(dsum),
                                                 batch, n, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kKvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_q_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kQSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  attn_bwd_kv_kernel<T><<<grid, kThreads, kKvSmem, stream>>>(
      qv, kv, vv, gv, l, d, static_cast<T*>(dk), static_cast<T*>(dv), n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_q_kernel<T><<<grid, kThreads, kQSmem, stream>>>(
      qv, kv, vv, gv, l, d, static_cast<T*>(dq), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: (batch, token, head) element strides of q, k, v.  dtype 0 = fp32,
// 1 = bf16.  Returns the CUDA error of the launch (0 on success).
extern "C" int attn_fwd_launch(const void* q, const void* k, const void* v,
                               const long long* strides, void* out, void* lse,
                               int batch, int n, int heads, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(q, k, v, strides, out, lse, batch, n, heads, scale, s);
  return (int)fwd<__nv_bfloat16>(q, k, v, strides, out, lse, batch, n, heads, scale, s);
}

// strides: (batch, token, head) element strides of q, k, v, o and g.  dsum
// is [B, H, N] fp32 scratch.  Enqueues the three backward kernels.
extern "C" int attn_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* g, const long long* strides,
                               const void* lse, void* dsum, void* dq, void* dk,
                               void* dv, int batch, int n, int heads, float scale,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(q, k, v, o, g, strides, lse, dsum, dq, dk, dv, batch, n,
                           heads, scale, s);
  return (int)bwd<__nv_bfloat16>(q, k, v, o, g, strides, lse, dsum, dq, dk, dv, batch,
                                 n, heads, scale, s);
}
