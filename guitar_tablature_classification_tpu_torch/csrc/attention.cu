// Fused multi-head attention for Hopper (sm_90a), bound through ctypes:
// softmax(Q K^T * scale) V and its gradient: head dim 64 (the ViT), and
// query/key width 192 with value width 128 under an optional causal mask
// (DeepSeek-V2's latent attention), both from one template ("the tensor-core
// kernels" below).
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
// D = rowsum(dO * O) are [B, H, N] fp32.
//
// Numerics (attention_pallas.py:79-101, 159-197).  Products accumulate in
// fp32, the softmax runs in fp32, and the weights P and the score gradient
// dS are rounded to the input dtype before they enter a product, as the TPU
// kernels round them before their bf16 GEMMs; dq and dk are scaled after
// their products (scale * dot(dS, .)).  Keys past N take no weight; query
// rows past N add nothing to dk and dv.
//
// Bound (B=64, H=6, N=785, Dh=64, bf16; chip_smoke.py computes it per run):
// operations on the tensor cores at 989 TFLOP/s.
//   fwd: 4*B*H*N^2*Dh = 60.6 GFLOP -> 0.0613 ms (bytes: 155 MB, 0.046 ms)
//   bwd: 10*B*H*N^2*Dh = 151 GFLOP -> 0.153 ms (the JAX kernel's estimate;
//        the deterministic split below issues 14*B*H*N^2*Dh = 211 GFLOP)
// The B*H*N^2 = 237 M exponentials of each pass take ~0.06 ms on the SMs'
// special-function units, the same order as the tensor-core bound.  On the
// card (PERF.md) these kernels are held back less by the tensor cores than
// by the instructions around each score (scale, mask, max, exp, sum, pack),
// so the score loops keep those few: one FFMA and one ex2.approx a score,
// masks only on the last tile.
//
// bf16: the tensor-core kernels (FlashAttention-2's scheme with mma.sync).
// * Tiles of 64 tokens, 4 warps (128 threads) a CTA, each warp 16 rows of
//   the CTA's tile.  Shared tiles are bf16 [64][64 + 8]: the 144-byte row
//   keeps ldmatrix free of bank conflicts.  The streamed operand tiles go
//   through a ring of kStages = 2 cp.async stages (16-byte copies, rows past
//   N zero-filled by src-size 0): the copy of the next tile is in flight
//   while the current one computes, with one barrier a tile.
// * Products: mma.sync m16n8k16 bf16 x bf16 -> fp32 (bf16 products are
//   exact in fp32).  A 16 x 64 accumulator block of one warp is 8 n-tiles
//   of 4 registers, and its layout is that of the A operand of the next
//   product: the rounded P (or dS) is packed to bf16 in registers and used
//   as the A fragments directly; it never goes to shared memory.
// * One source for every width: the kernels' bodies are device functions
//   templated on the query/key and value widths and on the causal mask (the
//   "tensor-core kernels" section below says how each works); the ViT runs
//   their <64, 64, no mask> instance as attn_fwd_mma_kernel,
//   attn_rowdot_mma_kernel, attn_bwd_kv_mma_kernel and attn_bwd_q_mma_kernel.
// * fwd: one CTA per (64-query tile, head, batch); Q stays in shared memory,
//   K and V stream.  Shared memory at 64 wide: Q 9 KB + 2 stages x (K, V)
//   36 KB = 45 KB a CTA.
// * bwd: (1) the row dots D = rowsum(dO * O); (2) dK and dV, one CTA per
//   64-key tile, K and V resident, Q, dO, lse and D streaming (55 KB);
//   (3) dQ, one CTA per 64-query tile, Q and dO resident, K and V
//   streaming (54 KB).  That is 14*N^2*Dh of products a head (S and dP
//   twice) against 10 for a single pass, the price of determinism: a dQ
//   partial per key tile would need ~1 GB of scratch at the main shape.
// * Determinism: no atomics.  Every dq, dk and dv element is the sum of one
//   thread's accumulator over the tiles in order, and D, lse and the
//   outputs have one writer each: two runs give identical bits.
// * Registers, spills and CTAs per SM of each kernel: chip_smoke.py prints
//   the build's -Xptxas -v lines and attn_kernel_info's occupancy (the ViT's
//   dK/dV and dQ kernels are held to 3 CTAs an SM by __launch_bounds__).
//
// fp32: the SIMT kernels (attn_fwd_kernel, attn_bwd_kv_kernel,
// attn_bwd_q_kernel).  The fp32 limits (output 2e-5, gradients 1e-4) need
// fp32 products: TF32 or bf16 tensor cores would break them.  No model path
// runs attention in fp32 (vit_s8 computes in bf16).  The TPU kernel keeps
// one head's whole K and V resident in VMEM; at fp32 that is ~400 KB, past a
// CTA's 227 KB of shared memory, so K and V stream through shared memory in
// 64-row fp32 tiles with an online softmax.  fwd: one CTA of 256 threads
// (16 x 16) per (64-query tile, head, batch), each thread a 4 x 4 block of
// scores (queries ty+16i, keys tx+16j), row max and sum over the 16 threads
// of a row by shuffles, the weights written to shared memory for P V.  bwd:
// attn_rowdot_kernel (one thread per row, an fmaf chain over the head dim in
// tile_dot's order, so D rounds as dP does), then one CTA per key tile for
// dK and dV and one per query tile for dQ, as above.  The backward
// recomputes S with the forward's exact operation order (an fmaf chain over
// the head dim, then * scale), so exp(S - lse) sums to 1 as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kTile = 64;      // queries or keys per tile
constexpr int kThreads = 256;  // fp32 SIMT kernels: 16 x 16 threads
constexpr int kLd = kD + 1;    // padded shared row (floats): conflict-free columns
constexpr int kTileFloats = kTile * kLd;

// A [B, N, H, 64] operand: element strides of batch, token and head.
struct View {
  const void* ptr;
  long long sb, sn, sh;
};

// ============================================ fp32: SIMT kernels (FFMA)

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

// (1) dsum[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one thread per
// row: an fmaf chain over d in ascending order, tile_dot's order, so D
// rounds as dP = dO . V does.
__global__ void attn_rowdot_kernel(View g, View o, float* dsum, int batch, int n,
                                   int heads) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)batch * n * heads) return;
  const int h = (int)(row % heads);
  const int t = (int)((row / heads) % n);
  const int b = (int)(row / ((long long)heads * n));
  const float* gp = static_cast<const float*>(g.ptr) + b * g.sb + t * g.sn + h * g.sh;
  const float* op = static_cast<const float*>(o.ptr) + b * o.sb + t * o.sn + h * o.sh;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(gp + d);
    const float4 y = *reinterpret_cast<const float4*>(op + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  dsum[((long long)b * heads + h) * n + t] = s;
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

// ============================= bf16: tensor-core kernels (mma.sync, cp.async)

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of the tile each
constexpr int kStages = 2;        // cp.async ring depth
constexpr size_t kRowBytes = kTile * sizeof(float);        // lse or D of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src-size
// 0: nothing is read, `src` only has to be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2^-22 relative error;
// -inf gives 0).  exp2f adds a denormal path around it, which costs the
// score loops ~10 % (measured on the card).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even, as astype
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  An fp32
// accumulator n-tile c[4] holds rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1.  A 16 x 64 block is c[8][4]: n-tile j covers columns
// 8j .. 8j + 7.

// Entries [n0, n0 + 64) of two [B, H, N] fp32 row vectors (the lse and D of
// a query tile) -> shared, asynchronously; past n: 0.
__device__ __forceinline__ void rows_async(float* dst, const float* lse, const float* dsum,
                                           int n0, int n) {
  const int i = threadIdx.x % kTile;
  const float* src = threadIdx.x < kTile ? lse : dsum;
  const bool ok = n0 + i < n;
  cp_async4(dst + threadIdx.x, src + (ok ? n0 + i : 0), ok);
}

// Accumulator block (16 x 64) -> bf16 A fragments (16 x 64): n-tiles 2kk and
// 2kk + 1 are k-step kk.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// ------------------------------------------ the tensor-core kernels
//
// One template serves both widths: q and k [B, N, H, DQK], v [B, N, H, DV],
// an explicit scale, and optionally the causal mask (key s takes weight in
// query row t only where s <= t).  Its instances are <64, 64, no mask> (the
// ViT; attn_*_mma_kernel) and <192, 128> (DeepSeek-V2's latent attention,
// MLA; attn_*_mla_kernel): the bodies below are device functions, and each
// instance is a kernel of its own name, so a trace tells them apart.
// * A warp reads the A operand of a score product from shared memory one
//   16-wide k-step at a time: at 192 wide a warp's fragments do not fit in
//   registers beside its accumulators (dK alone is 16 x 192 fp32, 96
//   registers a thread).
// * Shared tiles are [64][D + 8] bf16 (rows of 144, 272 and 400 bytes keep
//   ldmatrix free of bank conflicts).  At <192, 128> the forward takes
//   112 KB a CTA, the dK/dV and dQ kernels 130 KB and 129 KB: one or two
//   CTAs an SM.
// * Under the mask a query tile reads key tiles 0 .. its own, and a key tile
//   query tiles from its own on: the causal pass does about half the work.
//   The forward and the dQ kernel then run their query tiles from the last
//   (the longest) to the first.

template <int D>
struct Wide {
  static constexpr int kLd = D + 8;                   // bf16 shared row
  static constexpr int kHalves = kTile * kLd;         // a 64-row tile
  static constexpr size_t kBytes = kHalves * sizeof(bf16);
};

// Rows [n0, n0 + 64) of head h in batch b of a D-wide bf16 operand -> a
// padded shared tile, asynchronously; rows at or past n are zero.
template <int D>
__device__ __forceinline__ void tile_async(bf16* tile, const View& v, int b, int h, int n0,
                                           int n) {
  const bf16* base = static_cast<const bf16*>(v.ptr) + b * v.sb + h * v.sh;
  for (int i = threadIdx.x; i < kTile * (D / 8); i += kMmaThreads) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    const bool ok = n0 + row < n;
    cp_async16(tile + row * Wide<D>::kLd + col,
               base + (long long)(ok ? n0 + row : 0) * v.sn + col, ok);
  }
}

// acc (16 x 64) += A (rows r0 .. r0 + 15 of the D-wide shared tile `a`) *
// tile^T (column j is the tile's row j), the k-steps in ascending order.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a, int r0,
                                        const bf16* tile, int lane) {
  constexpr int kLd = Wide<D>::kLd;
  const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (r0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, tile + (np * 16 + row) * kLd + kk * 16 + col);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += A (16 x 64 tile rows, in registers) * tile (64 rows, D wide).
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[4][4],
                                       const bf16* tile, int lane) {
  constexpr int kLd = Wide<D>::kLd;
  const int row = lane & 15, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, tile + (kk * 16 + row) * kLd + dp * 16 + col);
      mma_bf16(acc[2 * dp], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], bf[2], bf[3]);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

template <int N>
__device__ __forceinline__ void scale_all(float (&c)[N][4], float s) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] *= s;
}

// The warp's 16 x D block -> bf16 rows t0 .. t0 + 15 (those before n) of
// head h of a contiguous [B, N, H, D] output, through `stage` (16 rows of
// D + 8 halves that no other warp reads) and 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&c)[D / 8][4], bf16* stage,
                                           int t0, int b, int h, int n, int heads, int lane) {
  constexpr int kLd = Wide<D>::kLd;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(stage + ((lane >> 2) + 8 * hh) * kLd + j * 8 +
                                   2 * (lane & 3)) = pack_bf16(c[j][2 * hh], c[j][2 * hh + 1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    if (t0 + row < n)
      *reinterpret_cast<uint4*>(out + (((long long)b * n + t0 + row) * heads + h) * D + col) =
          *reinterpret_cast<const uint4*>(stage + row * kLd + col);
  }
}

// Whether accumulator entry e of n-tile nt (row: the warp's 16 rows from r0;
// column: the 64 from c0) is masked: the column at or past n, or under the
// causal mask a key past its query.  `key_cols`: the columns are keys (S),
// else queries (S^T).
template <bool CAUSAL>
__device__ __forceinline__ bool masked(int r0, int c0, int nt, int e, int lane, int n,
                                       bool key_cols) {
  const int r = r0 + (lane >> 2) + 8 * (e >> 1), c = c0 + nt * 8 + 2 * (lane & 3) + (e & 1);
  if (c >= n) return true;
  return CAUSAL && (key_cols ? c > r : c < r);
}

// dynamic shared bytes of each kernel at <DQK, DV>
template <int DQK, int DV>
struct TileSmem {
  static constexpr size_t kFwd = Wide<DQK>::kBytes + kStages * (Wide<DQK>::kBytes + Wide<DV>::kBytes);
  static constexpr size_t kKvStage = Wide<DQK>::kBytes + Wide<DV>::kBytes + 2 * kRowBytes;
  static constexpr size_t kKv = Wide<DQK>::kBytes + Wide<DV>::kBytes + kStages * kKvStage;
  static constexpr size_t kQ = Wide<DQK>::kBytes + Wide<DV>::kBytes +
                               kStages * (Wide<DQK>::kBytes + Wide<DV>::kBytes);
};

// forward: one CTA per (64-query tile, head, batch); Q stays in shared
// memory, K and V stream.  S = Q K^T; the online softmax on the accumulator
// fragments keeps the row max of the unscaled scores (reduced over the 4
// lanes of a quad by shuffles) and forms P = 2^(S * scale * log2 e - max *
// scale * log2 e) with one FFMA; O += bf16(P) V with P at the running max;
// O = acc / l in bf16 and lse = max * scale + log(l) leave through shared
// memory in 16-byte stores.
template <int DQK, int DV, bool CAUSAL>
__device__ __forceinline__ void fwd_body(View q, View k, View v, bf16* out, float* lse, int n,
                                         int heads, float scale_log2) {
  constexpr int kQH = Wide<DQK>::kHalves, kVH = Wide<DV>::kHalves;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][DQK + 8], resident
  bf16* ring = qs + kQH;                         // kStages x (K, V)
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = CAUSAL ? qt + 1 : (n + kTile - 1) / kTile;
  auto load_stage = [&](int s, int k0) {
    bf16* ks = ring + s * (kQH + kVH);
    tile_async<DQK>(ks, k, b, h, k0, n);
    tile_async<DV>(ks + kQH, v, b, h, k0, n);
  };

  tile_async<DQK>(qs, q, b, h, q0, n);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_stage(s, s * kTile);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
  zero(o);
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j (and, on the first, Q) has landed
    __syncthreads();
    {
      const int next = j + kStages - 1;
      if (next < tiles) load_stage(next % kStages, next * kTile);
      cp_async_commit();
    }
    const bf16* ks = ring + (j % kStages) * (kQH + kVH);
    const bf16* vs = ks + kQH;
    const int k0 = j * kTile;

    float s[8][4];
    zero(s);
    mma_abt<DQK>(s, qs, warp * 16, ks, lane);  // S = Q K^T, unscaled
    if (k0 + kTile > n || (CAUSAL && j == tiles - 1)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked<CAUSAL>(q0 + warp * 16, k0, nt, e, lane, n, true)) s[nt][e] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // finite: the first tile holds key 0, which every query row sees
      const float m_new = fmaxf(m[r], mx);
      const float alpha = ex2((m[r] - m_new) * scale_log2);
      const float offset = -m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = ex2(fmaf(s[nt][e], scale_log2, offset));
          sum += s[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
    }
    uint32_t pf[4][4];
    to_a(pf, s);
    mma_ab<DV>(o, pf, vs, lane);  // O += bf16(P) V
  }

#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = o[nt][e] / l[e >> 1];
  const int t0 = q0 + warp * 16;
  // the warp's own Q rows (read by no other warp) stage its output
  store_rows<DV>(out, o, qs + warp * 16 * Wide<DQK>::kLd, t0, b, h, n, heads, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + (lane >> 2) + 8 * r;
      if (t < n)
        lse[((long long)b * heads + h) * n + t] = fmaf(m[r], scale_log2, log2f(l[r])) * kLn2;
    }
  }
}

// backward (1): D = rowsum(dO * O) as the diagonal of dO O^T on the tensor
// cores, so D rounds as dP = dO V^T does (with one key, O = V and dS = P (dP
// - D) is exactly 0, as in the plain version).  One CTA per (64-row tile,
// head, batch).
template <int DV>
__device__ __forceinline__ void rowdot_body(View g, View o, float* dsum, int n, int heads) {
  constexpr int kLd = Wide<DV>::kLd;
  __shared__ __align__(16) bf16 gs[Wide<DV>::kHalves];
  __shared__ __align__(16) bf16 os[Wide<DV>::kHalves];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  tile_async<DV>(gs, g, b, h, q0, n);
  tile_async<DV>(os, o, b, h, q0, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int row = warp * 16 + (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    uint32_t af[4], bf[4];
    ldmatrix_x4(af, gs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
    ldmatrix_x4(bf, os + row * kLd + kk * 16 + col);
    mma_bf16(c[0], af, bf[0], bf[1]);
    mma_bf16(c[1], af, bf[2], bf[3]);
  }
  const int gr = lane >> 2;
  if ((lane & 3) == (gr >> 1)) {
    const long long base = ((long long)b * heads + h) * n;
    const int t = q0 + warp * 16 + gr;
    if (t < n) dsum[base + t] = c[0][gr & 1];
    if (t + 8 < n) dsum[base + t + 8] = c[1][2 + (gr & 1)];
  }
}

// backward (2): dK and dV of one 64-key tile, over the query tiles that see
// it.  K and V stay in shared memory; Q, dO, lse and D stream.  Per warp (16
// keys) S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T scale - lse), dS^T =
// P^T (dP^T - D), dV += bf16(P^T) dO, dK += bf16(dS^T) Q.
template <int DQK, int DV, bool CAUSAL>
__device__ __forceinline__ void bwd_kv_body(View q, View k, View v, View g, const float* lse,
                                            const float* dsum, bf16* dk, bf16* dv, int n,
                                            int heads, float scale, float scale_log2) {
  constexpr int kQH = Wide<DQK>::kHalves, kVH = Wide<DV>::kHalves;
  constexpr size_t kStage = TileSmem<DQK, DV>::kKvStage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64 keys][DQK + 8], resident
  bf16* vs = ks + kQH;                           // [64 keys][DV + 8], resident
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kVH);
  const int kt = blockIdx.x, k0 = kt * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = CAUSAL ? kt : 0, tiles = (n + kTile - 1) / kTile;
  const long long row_base = ((long long)b * heads + h) * n;
  auto load_stage = [&](int s, int q0) {
    bf16* qs = reinterpret_cast<bf16*>(ring + s * kStage);
    tile_async<DQK>(qs, q, b, h, q0, n);
    tile_async<DV>(qs + kQH, g, b, h, q0, n);
    rows_async(reinterpret_cast<float*>(qs + kQH + kVH), lse + row_base, dsum + row_base, q0,
               n);
  };

  tile_async<DQK>(ks, k, b, h, k0, n);
  tile_async<DV>(vs, v, b, h, k0, n);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (first + s < tiles) load_stage(s, (first + s) * kTile);
    cp_async_commit();
  }
  float dk_acc[DQK / 8][4], dv_acc[DV / 8][4];  // rows: the warp's 16 keys
  zero(dk_acc);
  zero(dv_acc);
  for (int j = first; j < tiles; ++j) {
    const int slot = (j - first) % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int next = j + kStages - 1;
      if (next < tiles) load_stage((next - first) % kStages, next * kTile);
      cp_async_commit();
    }
    const bf16* qs = reinterpret_cast<const bf16*>(ring + slot * kStage);
    const bf16* gs = qs + kQH;
    const float* ls = reinterpret_cast<const float*>(gs + kVH);
    const float* ds = ls + kTile;
    const int q0 = j * kTile;

    float p[8][4];  // P^T: rows the warp's keys, columns the tile's queries
    zero(p);
    mma_abt<DQK>(p, ks, warp * 16, qs, lane);  // S^T = K Q^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + nt * 8 + 2 * (lane & 3));
      const float lse0 = -l2.x * kLog2e, lse1 = -l2.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = ex2(fmaf(p[nt][e], scale_log2, (e & 1) ? lse1 : lse0));
    }
    if (q0 + kTile > n || (CAUSAL && j == kt)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked<CAUSAL>(k0 + warp * 16, q0, nt, e, lane, n, false)) p[nt][e] = 0.f;
    }
    uint32_t af[4][4];
    to_a(af, p);
    mma_ab<DV>(dv_acc, af, gs, lane);  // dV += bf16(P^T) dO

    float dp[8][4];
    zero(dp);
    mma_abt<DV>(dp, vs, warp * 16, gs, lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(ds + nt * 8 + 2 * (lane & 3));
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - ((e & 1) ? d2.y : d2.x));
    }
    to_a(af, dp);
    mma_ab<DQK>(dk_acc, af, qs, lane);  // dK += bf16(dS^T) Q
  }

  scale_all(dk_acc, scale);
  const int t0 = k0 + warp * 16;
  store_rows<DV>(dv, dv_acc, vs + warp * 16 * Wide<DV>::kLd, t0, b, h, n, heads, lane);
  store_rows<DQK>(dk, dk_acc, ks + warp * 16 * Wide<DQK>::kLd, t0, b, h, n, heads, lane);
}

// backward (3): dQ of one 64-query tile, over the key tiles it sees: Q and
// dO stay in shared memory, K and V stream; S and dP in the forward's
// orientation and k order, dQ += bf16(dS) K.
template <int DQK, int DV, bool CAUSAL>
__device__ __forceinline__ void bwd_q_body(View q, View k, View v, View g, const float* lse,
                                           const float* dsum, bf16* dq, int n, int heads,
                                           float scale, float scale_log2) {
  constexpr int kQH = Wide<DQK>::kHalves, kVH = Wide<DV>::kHalves;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64 queries][DQK + 8], resident
  bf16* gs = qs + kQH;                           // [64 queries][DV + 8], resident
  bf16* ring = gs + kVH;                         // kStages x (K, V)
  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = CAUSAL ? qt + 1 : (n + kTile - 1) / kTile;
  const long long row_base = ((long long)b * heads + h) * n;
  auto load_stage = [&](int s, int k0) {
    bf16* ks = ring + s * (kQH + kVH);
    tile_async<DQK>(ks, k, b, h, k0, n);
    tile_async<DV>(ks + kQH, v, b, h, k0, n);
  };

  tile_async<DQK>(qs, q, b, h, q0, n);
  tile_async<DV>(gs, g, b, h, q0, n);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_stage(s, s * kTile);
    cp_async_commit();
  }
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + (lane >> 2) + 8 * r;
    lse2[r] = t < n ? -lse[row_base + t] * kLog2e : 0.f;
    dd[r] = t < n ? dsum[row_base + t] : 0.f;
  }

  float dq_acc[DQK / 8][4];
  zero(dq_acc);
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int next = j + kStages - 1;
      if (next < tiles) load_stage(next % kStages, next * kTile);
      cp_async_commit();
    }
    const bf16* ks = ring + (j % kStages) * (kQH + kVH);
    const bf16* vs = ks + kQH;
    const int k0 = j * kTile;

    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    mma_abt<DQK>(p, qs, warp * 16, ks, lane);  // S = Q K^T
    mma_abt<DV>(dp, gs, warp * 16, vs, lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = ex2(fmaf(p[nt][e], scale_log2, lse2[e >> 1]));
    if (k0 + kTile > n || (CAUSAL && j == tiles - 1)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked<CAUSAL>(q0 + warp * 16, k0, nt, e, lane, n, true)) p[nt][e] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - dd[e >> 1]);
    uint32_t af[4][4];
    to_a(af, dp);
    mma_ab<DQK>(dq_acc, af, ks, lane);  // dQ += bf16(dS) K
  }

  scale_all(dq_acc, scale);
  store_rows<DQK>(dq, dq_acc, qs + warp * 16 * Wide<DQK>::kLd, q0 + warp * 16, b, h, n, heads,
                  lane);
}

// The ViT's instance: 64 wide, no mask.  The dK/dV and dQ kernels are held
// to 3 CTAs an SM (3 ran 5 % faster than 2, measured on the card).
__global__ void __launch_bounds__(kMmaThreads)
    attn_fwd_mma_kernel(View q, View k, View v, bf16* out, float* lse, int n, int heads,
                        float scale_log2) {
  fwd_body<kD, kD, false>(q, k, v, out, lse, n, heads, scale_log2);
}

__global__ void __launch_bounds__(kMmaThreads)
    attn_rowdot_mma_kernel(View g, View o, float* dsum, int n, int heads) {
  rowdot_body<kD>(g, o, dsum, n, heads);
}

__global__ void __launch_bounds__(kMmaThreads, 3)
    attn_bwd_kv_mma_kernel(View q, View k, View v, View g, const float* lse,
                           const float* dsum, bf16* dk, bf16* dv, int n, int heads,
                           float scale, float scale_log2) {
  bwd_kv_body<kD, kD, false>(q, k, v, g, lse, dsum, dk, dv, n, heads, scale, scale_log2);
}

__global__ void __launch_bounds__(kMmaThreads, 3)
    attn_bwd_q_mma_kernel(View q, View k, View v, View g, const float* lse,
                          const float* dsum, bf16* dq, int n, int heads, float scale,
                          float scale_log2) {
  bwd_q_body<kD, kD, false>(q, k, v, g, lse, dsum, dq, n, heads, scale, scale_log2);
}

// The MLA instances.
template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads)
    attn_fwd_mla_kernel(View q, View k, View v, bf16* out, float* lse, int n, int heads,
                        float scale_log2) {
  fwd_body<DQK, DV, CAUSAL>(q, k, v, out, lse, n, heads, scale_log2);
}

template <int DV>
__global__ void __launch_bounds__(kMmaThreads)
    attn_rowdot_mla_kernel(View g, View o, float* dsum, int n, int heads) {
  rowdot_body<DV>(g, o, dsum, n, heads);
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads, 1)
    attn_bwd_kv_mla_kernel(View q, View k, View v, View g, const float* lse,
                           const float* dsum, bf16* dk, bf16* dv, int n, int heads,
                           float scale, float scale_log2) {
  bwd_kv_body<DQK, DV, CAUSAL>(q, k, v, g, lse, dsum, dk, dv, n, heads, scale, scale_log2);
}

template <int DQK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads, 1)
    attn_bwd_q_mla_kernel(View q, View k, View v, View g, const float* lse,
                          const float* dsum, bf16* dq, int n, int heads, float scale,
                          float scale_log2) {
  bwd_q_body<DQK, DV, CAUSAL>(q, k, v, g, lse, dsum, dq, n, heads, scale, scale_log2);
}

using VitSizes = TileSmem<kD, kD>;
constexpr int kMlaDqk = 192, kMlaDv = 128;  // DeepSeek-V2's 128 + 64 rotary, and 128
using MlaSizes = TileSmem<kMlaDqk, kMlaDv>;

// ------------------------------------------------------------------- host

View make_view(const void* ptr, const long long* strides) {
  return View{ptr, strides[0], strides[1], strides[2]};
}

float log2_scale(float scale) { return (float)((double)scale * 1.4426950408889634); }

cudaError_t fwd_simt(const void* q, const void* k, const void* v, const long long* st,
                     void* out, void* lse, int batch, int n, int heads, float scale,
                     cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  attn_fwd_kernel<float><<<grid, kThreads, kFwdSmem, stream>>>(
      make_view(q, st), make_view(k, st + 3), make_view(v, st + 6),
      static_cast<float*>(out), static_cast<float*>(lse), n, heads, scale);
  return cudaGetLastError();
}

// the tensor-core forward of instance <DQK, DV> (`kernel`: its causal or
// unmasked kernel)
template <int DQK, int DV>
cudaError_t fwd_tc(void (*kernel)(View, View, View, bf16*, float*, int, int, float),
                   const void* q, const void* k, const void* v, const long long* st, void* out,
                   void* lse, int batch, int n, int heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = TileSmem<DQK, DV>::kFwd;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      make_view(q, st), make_view(k, st + 3), make_view(v, st + 6), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, heads, log2_scale(scale));
  return cudaGetLastError();
}

cudaError_t bwd_simt(const void* q, const void* k, const void* v, const void* o,
                     const void* g, const long long* st, const void* lse, void* dsum,
                     void* dq, void* dk, void* dv, int batch, int n, int heads, float scale,
                     cudaStream_t stream) {
  const View qv = make_view(q, st), kv = make_view(k, st + 3), vv = make_view(v, st + 6);
  const View ov = make_view(o, st + 9), gv = make_view(g, st + 12);
  const long long rows = (long long)batch * n * heads;
  attn_rowdot_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      gv, ov, static_cast<float*>(dsum), batch, n, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kKvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_q_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kQSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  attn_bwd_kv_kernel<float><<<grid, kThreads, kKvSmem, stream>>>(
      qv, kv, vv, gv, l, d, static_cast<float*>(dk), static_cast<float*>(dv), n, heads,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_q_kernel<float><<<grid, kThreads, kQSmem, stream>>>(
      qv, kv, vv, gv, l, d, static_cast<float*>(dq), n, heads, scale);
  return cudaGetLastError();
}

using KvKernel = void (*)(View, View, View, View, const float*, const float*, bf16*, bf16*,
                          int, int, float, float);
using QKernel = void (*)(View, View, View, View, const float*, const float*, bf16*, int, int,
                         float, float);

// the tensor-core backward of instance <DQK, DV>: the row dots, then dK/dV,
// then dQ (`kv_kernel`, `q_kernel`: the instance's causal or unmasked ones)
template <int DQK, int DV>
cudaError_t bwd_tc(void (*rowdot_kernel)(View, View, float*, int, int), KvKernel kv_kernel,
                   QKernel q_kernel, const void* q, const void* k, const void* v, const void* o,
                   const void* g, const long long* st, const void* lse, void* dsum, void* dq,
                   void* dk, void* dv, int batch, int n, int heads, float scale,
                   cudaStream_t stream) {
  using Sizes = TileSmem<DQK, DV>;
  const View qv = make_view(q, st), kv = make_view(k, st + 3), vv = make_view(v, st + 6);
  const View ov = make_view(o, st + 9), gv = make_view(g, st + 12);
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  rowdot_kernel<<<grid, kMmaThreads, 0, stream>>>(gv, ov, static_cast<float*>(dsum), n, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sizes::kKv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sizes::kQ);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  const float s2 = log2_scale(scale);
  kv_kernel<<<grid, kMmaThreads, Sizes::kKv, stream>>>(
      qv, kv, vv, gv, l, d, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, heads, scale, s2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<grid, kMmaThreads, Sizes::kQ, stream>>>(qv, kv, vv, gv, l, d,
                                                     static_cast<bf16*>(dq), n, heads, scale, s2);
  return cudaGetLastError();
}

struct KernelEntry {
  const char* name;
  const void* fn;
  int threads;
  size_t smem;  // dynamic shared memory of a launch
};

const KernelEntry kKernels[] = {
    {"attn_fwd_mma_kernel", (const void*)attn_fwd_mma_kernel, kMmaThreads, VitSizes::kFwd},
    {"attn_rowdot_mma_kernel", (const void*)attn_rowdot_mma_kernel, kMmaThreads, 0},
    {"attn_bwd_kv_mma_kernel", (const void*)attn_bwd_kv_mma_kernel, kMmaThreads, VitSizes::kKv},
    {"attn_bwd_q_mma_kernel", (const void*)attn_bwd_q_mma_kernel, kMmaThreads, VitSizes::kQ},
    {"attn_fwd_kernel<float>", (const void*)attn_fwd_kernel<float>, kThreads, kFwdSmem},
    {"attn_rowdot_kernel", (const void*)attn_rowdot_kernel, kThreads, 0},
    {"attn_bwd_kv_kernel<float>", (const void*)attn_bwd_kv_kernel<float>, kThreads, kKvSmem},
    {"attn_bwd_q_kernel<float>", (const void*)attn_bwd_q_kernel<float>, kThreads, kQSmem},
    {"attn_fwd_mla_kernel<192, 128, true>",
     (const void*)attn_fwd_mla_kernel<kMlaDqk, kMlaDv, true>, kMmaThreads, MlaSizes::kFwd},
    {"attn_rowdot_mla_kernel<128>", (const void*)attn_rowdot_mla_kernel<kMlaDv>, kMmaThreads, 0},
    {"attn_bwd_kv_mla_kernel<192, 128, true>",
     (const void*)attn_bwd_kv_mla_kernel<kMlaDqk, kMlaDv, true>, kMmaThreads, MlaSizes::kKv},
    {"attn_bwd_q_mla_kernel<192, 128, true>",
     (const void*)attn_bwd_q_mla_kernel<kMlaDqk, kMlaDv, true>, kMmaThreads, MlaSizes::kQ},
};

}  // namespace

// strides: (batch, token, head) element strides of q, k, v.  dtype 0 = fp32
// (SIMT), 1 = bf16 (tensor cores).  Returns the CUDA error of the launch (0
// on success).
extern "C" int attn_fwd_launch(const void* q, const void* k, const void* v,
                               const long long* strides, void* out, void* lse,
                               int batch, int n, int heads, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd_simt(q, k, v, strides, out, lse, batch, n, heads, scale, s);
  return (int)fwd_tc<kD, kD>(attn_fwd_mma_kernel, q, k, v, strides, out, lse, batch, n, heads,
                             scale, s);
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
    return (int)bwd_simt(q, k, v, o, g, strides, lse, dsum, dq, dk, dv, batch, n, heads,
                         scale, s);
  return (int)bwd_tc<kD, kD>(attn_rowdot_mma_kernel, attn_bwd_kv_mma_kernel, attn_bwd_q_mma_kernel,
                             q, k, v, o, g, strides, lse, dsum, dq, dk, dv, batch, n, heads, scale,
                             s);
}

// The MLA kernels (bf16 only): q, k [B, N, H, 192], v [B, N, H, 128]; out
// [B, N, H, 128]; causal 0 or 1.  strides as attn_fwd_launch's.
extern "C" int attn_fwd_mla_launch(const void* q, const void* k, const void* v,
                                   const long long* strides, void* out, void* lse, int batch,
                                   int n, int heads, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)fwd_tc<kMlaDqk, kMlaDv>(causal ? attn_fwd_mla_kernel<kMlaDqk, kMlaDv, true>
                                             : attn_fwd_mla_kernel<kMlaDqk, kMlaDv, false>,
                                      q, k, v, strides, out, lse, batch, n, heads, scale, s);
}

// dq, dk [B, N, H, 192] and dv [B, N, H, 128]; dsum [B, H, N] fp32 scratch.
extern "C" int attn_bwd_mla_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const long long* strides, const void* lse,
                                   void* dsum, void* dq, void* dk, void* dv, int batch, int n,
                                   int heads, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)bwd_tc<kMlaDqk, kMlaDv>(
      attn_rowdot_mla_kernel<kMlaDv>,
      causal ? attn_bwd_kv_mla_kernel<kMlaDqk, kMlaDv, true>
             : attn_bwd_kv_mla_kernel<kMlaDqk, kMlaDv, false>,
      causal ? attn_bwd_q_mla_kernel<kMlaDqk, kMlaDv, true>
             : attn_bwd_q_mla_kernel<kMlaDqk, kMlaDv, false>,
      q, k, v, o, g, strides, lse, dsum, dq, dk, dv, batch, n, heads, scale, s);
}

// Kernel `which` (0 .. count - 1) of this library as the card runs it:
// its name, and info = {registers a thread, local (spill) bytes a thread,
// shared bytes a CTA (static + dynamic), threads a CTA, resident CTAs per
// SM}.  Returns the number of kernels, or -1 on a CUDA error.
extern "C" int attn_kernel_info(int which, const char** name, int* info) {
  const int count = (int)(sizeof(kKernels) / sizeof(kKernels[0]));
  if (which < 0 || which >= count) return count;
  const KernelEntry& e = kKernels[which];
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, e.fn) != cudaSuccess) return -1;
  if (cudaFuncSetAttribute(e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)e.smem) != cudaSuccess)
    return -1;
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, e.fn, e.threads, e.smem) !=
      cudaSuccess)
    return -1;
  *name = e.name;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)(attr.sharedSizeBytes + e.smem);
  info[3] = e.threads;
  info[4] = ctas;
  return count;
}
