// 3x3 "same" convolution with a fused ReLU-affine on its input, for Hopper
// (sm_90a), bound through ctypes.
//
// Replaces the JAX repo's TPU kernel
//   tools/probe_pallas_conv.py::pallas_conv3x3
// (a probe of an implicit-GEMM conv at ResNet18 trunk shapes; its sum9 and
// concat formulations compute the same function).  ops/conv3x3.py::
// conv3x3_plain is the plain PyTorch version.
//
// What it computes, NHWC, for x [B, H, W, C] bf16, w9 [9, C, F] bf16 (tap
// dy*3 + dx) and s, o [C] bf16:
//   t = relu(bf16(bf16(x*s) + o))       rounded as JAX's bf16 x*s+o rounds
//   out[b, h, w, f] = bf16(sum_{dy, dx, c} tp[b, h+dy, w+dx, c] * w9[dy*3+dx, c, f])
// with tp = t zero-padded by one pixel on each side (the padding is zero
// after the ReLU: the halo is zeroed after the affine), products and sums
// in fp32, one rounding at the end.
//
// Bound.  The probe's cases at B=256, (56, 64->64), (28, 128->128) and
// (14, 256->256), are 59.2 GFLOP each: 0.060 ms at the bf16 tensor-core
// peak; bytes (x once, out once) 205.5 / 102.8 / 51.4 MB -> 0.061 / 0.031 /
// 0.015 ms.
//
// Design.  An implicit GEMM with M = B*H*W output pixels, N = F and depth
// 9*C, walked tap by tap in steps of 32 channels:
// * A CTA owns 128 pixels x BN filters (BN = 128 when F % 128 == 0, else
//   64).  Each step stages the 128 pixels' shifted inputs for one tap and
//   32 channels: a thread loads 8 channels of a pixel (16 bytes), applies
//   the affine and ReLU once per staged element, on bf16 pairs (mul.rn,
//   add.rn, max.NaN: the same two roundings, three instructions for two
//   values), writes zero for a pixel whose tap falls outside the image or a
//   channel past C, and stores the bf16 values as [128][32 + 8]; w9's
//   [32][BN] slice is staged as it is, [32][BN + 8].  The row padding keeps
//   ldmatrix free of bank conflicts.  The next step's raw values are loaded
//   into registers while the current step computes.
// * Tensor cores through mma.sync m16n8k16 (bf16 operands, fp32
//   accumulation; the products of bf16 values are exact): 8 warps, each a
//   (128 / (8 / (BN / 32))) x 32 block of the output, fragments read with
//   ldmatrix (.trans for w9).
// * Epilogue: the accumulators are rounded once to bf16 into a tile in
//   shared memory, which leaves in 16-byte stores.  Every output is one
//   warp's sum in a fixed order: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;     // output pixels per CTA
constexpr int kBK = 32;      // channels per step
constexpr int kMaxC = 1024;  // ops/conv3x3_cuda.MAX_CHANNELS
constexpr int kLdA = kBK + 8;  // A row stride (bf16)

// relu(bf16(bf16(x*s) + o)) on two bf16 values at once: the product and the
// sum each rounded to bf16 (nearest even; .rn keeps ptxas from fusing them
// into one fma), max with NaN kept, as jnp.maximum keeps it
__device__ __forceinline__ uint32_t affine_relu2(uint32_t x, uint32_t s, uint32_t o) {
  uint32_t p, z, r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p) : "r"(x), "r"(s));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(z) : "r"(p), "r"(o));
  asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(z), "r"(0u));
  return r;
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

template <int kBN>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w9,
                   const __nv_bfloat16* __restrict__ s,
                   const __nv_bfloat16* __restrict__ o,
                   __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
                   int F) {
  constexpr int kLdB = kBN + 8;                       // B and C row stride (bf16)
  constexpr int kWarpsN = kBN / 32, kWarpsM = 8 / kWarpsN;
  constexpr int kMI = kBM / kWarpsM / 16;             // m16 tiles of a warp
  constexpr int kBLoads = kBK * kBN / 8 / kThreads;   // 16-byte w9 loads a thread
  constexpr int kStage = kBM * kLdA + kBK * kLdB;
  constexpr int kSmem = kStage > kBM * kLdB ? kStage : kBM * kLdB;
  __shared__ __align__(16) __nv_bfloat16 smem[kSmem];
  __shared__ uint32_t s_sh[kMaxC / 2], o_sh[kMaxC / 2];  // bf16 pairs (c, c + 1)
  __nv_bfloat16* As = smem;              // [kBM][kLdA]
  __nv_bfloat16* Bs = smem + kBM * kLdA;  // [kBK][kLdB]
  __nv_bfloat16* Cs = smem;              // [kBM][kLdB], after the last step

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  for (int i = tid; i < C / 2; i += kThreads) {
    const __nv_bfloat162 sp = __halves2bfloat162(s[2 * i], s[2 * i + 1]);
    const __nv_bfloat162 op = __halves2bfloat162(o[2 * i], o[2 * i + 1]);
    s_sh[i] = *reinterpret_cast<const uint32_t*>(&sp);
    o_sh[i] = *reinterpret_cast<const uint32_t*>(&op);
  }

  // A staging: this thread's pixel (row r of the tile) and its two 8-channel
  // groups q and q + 2 of each 32-channel step
  const int a_r = tid % kBM;
  const int a_q = tid / kBM;  // 0 or 1
  const long long a_m = m0 + a_r;
  int a_b = 0, a_h = 0, a_w = 0;
  const bool a_valid = a_m < M;
  if (a_valid) {
    a_w = (int)(a_m % W);
    const long long bh = a_m / W;
    a_h = (int)(bh % H);
    a_b = (int)(bh / H);
  }

  uint4 a_raw[2], b_raw[kBLoads];
  bool a_in[2];
  auto load = [&](int tap, int c0) {
    const int dy = tap / 3, dx = tap % 3;
    const int hh = a_h + dy - 1, ww = a_w + dx - 1;
    const bool inside = a_valid && hh >= 0 && hh < H && ww >= 0 && ww < W;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = c0 + (a_q + 2 * g) * 8;
      a_in[g] = inside && c < C;
      a_raw[g] = a_in[g]
          ? *reinterpret_cast<const uint4*>(
                x + (((long long)a_b * H + hh) * W + ww) * C + c)
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / (kBN / 8), n = n0 + (idx % (kBN / 8)) * 8;
      const int c = c0 + k;
      b_raw[i] = (c < C && n < F)
          ? *reinterpret_cast<const uint4*>(w9 + ((long long)tap * C + c) * F + n)
          : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&](int c0) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int kq = (a_q + 2 * g) * 8;
      uint4 packed = make_uint4(0, 0, 0, 0);  // zero outside the image and past C
      if (a_in[g]) {
        const int p = (c0 + kq) / 2;  // pair index of the first channel
        packed = make_uint4(affine_relu2(a_raw[g].x, s_sh[p], o_sh[p]),
                            affine_relu2(a_raw[g].y, s_sh[p + 1], o_sh[p + 1]),
                            affine_relu2(a_raw[g].z, s_sh[p + 2], o_sh[p + 2]),
                            affine_relu2(a_raw[g].w, s_sh[p + 3], o_sh[p + 3]));
      }
      *reinterpret_cast<uint4*>(As + a_r * kLdA + kq) = packed;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int k = idx / (kBN / 8), n = (idx % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + k * kLdB + n) = b_raw[i];
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  float acc[kMI][4][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int c_steps = (C + kBK - 1) / kBK;
  const int steps = 9 * c_steps;
  __syncthreads();  // s_sh, o_sh
  load(0, 0);
  for (int step = 0; step < steps; ++step) {
    stage((step % c_steps) * kBK);
    __syncthreads();
    if (step + 1 < steps) load((step + 1) / c_steps, ((step + 1) % c_steps) * kBK);
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 16) {
      uint32_t a[kMI][4], b[4][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        // lanes 0-15: rows r..r+15 at k0; lanes 16-31: the same rows at k0 + 8
        const int r = wm * kMI * 16 + i * 16 + (lane % 16);
        ldmatrix_x4(a[i], As + r * kLdA + k0 + (lane / 16) * 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // lanes 0-7: rows k0..k0+7, lanes 8-15: k0+8..k0+15, at column n
        const int n = wn * 32 + j * 8;
        ldmatrix_x2_trans(b[j], Bs + (k0 + (lane % 16)) * kLdB + n);
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // round once into the C tile: accumulator e of tile (i, j) is row
  // (lane / 4) + 8 * (e / 2), column 2 * (lane % 4) + e % 2
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * kMI * 16 + i * 16 + lane / 4 + 8 * h;
        const int n = wn * 32 + j * 8 + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(Cs + r * kLdB + n) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), n = (i % (kBN / 8)) * 8;
    if (m0 + r < M && n0 + n < F)
      *reinterpret_cast<uint4*>(out + (m0 + r) * F + n0 + n) =
          *reinterpret_cast<const uint4*>(Cs + r * kLdB + n);
  }
}

}  // namespace

// x [B, H, W, C], w9 [9, C, F], s, o [C] -> out [B, H, W, F], all bf16.
// Needs C % 8 == 0, C <= 1024, F % 8 == 0, x, w9 and out 16-byte aligned.
extern "C" int conv3x3_launch(const void* x, const void* w9, const void* s,
                              const void* o, void* out, int B, int H, int W,
                              int C, int F, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long M = (long long)B * H * W;
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 || C > kMaxC || F < 8 || F % 8 ||
      (M + kBM - 1) / kBM > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w9);
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  auto* yb = static_cast<__nv_bfloat16*>(out);
  const unsigned m_tiles = (unsigned)((M + kBM - 1) / kBM);
  if (F % 128 == 0) {
    conv3x3_kernel<128><<<dim3(m_tiles, F / 128), kThreads, 0, stream>>>(
        xb, wb, sb, ob, yb, B, H, W, C, F);
  } else {
    conv3x3_kernel<64><<<dim3(m_tiles, (F + 63) / 64), kThreads, 0, stream>>>(
        xb, wb, sb, ob, yb, B, H, W, C, F);
  }
  return (int)cudaGetLastError();
}
