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
// Design.  An implicit GEMM whose A operand is built in shared memory from
// one staged halo block (implicit im2col):
// * A CTA owns a TH x TW block of output pixels of one image (at most
//   kBM = 256; ops/conv3x3_cuda.tile_shape picks the block: the fewest
//   blocks a map, then the smallest halo) and kBN = 64 filters.  It walks
//   the channels in chunks of kKC = 16.  Each chunk stages the block's halo
//   (TH+2) x (TW+2) x 16 channels of x once and w9's [9][16][64] slice.
// * The affine and ReLU are applied once per staged element, shared ->
//   shared, by the thread that copied it (so its own cp.async wait is
//   enough), on bf16 pairs (mul.rn, add.rn, max.NaN: the same two
//   roundings, three instructions for two values); a halo pixel outside
//   the image or a channel past C is written as zero, after the affine.
// * The nine taps are nine shifted ldmatrix base addresses over that one
//   staged block: output pixel (r, c) of tap (dy, dx) reads halo pixel
//   (r + dy, c + dx).  Pixels lie 48 bytes apart, so 8 consecutive pixels
//   of an ldmatrix hit 8 distinct bank groups; w9 rows lie 144 bytes apart.
// * A ring of kStages = 3 stages filled by cp.async (zero-fill past C and
//   F), two chunks ahead of the tensor cores, one barrier a chunk: after its
//   products a thread waits for its own copies of the next chunk and
//   transforms them; the barrier at the top of the next chunk publishes
//   them and frees the oldest slot.
// * Tensor cores through mma.sync m16n8k16 (bf16 operands, fp32
//   accumulation; the products of bf16 values are exact): 8 warps, each 32
//   pixels (two m16 tiles) x 64 filters, 64 fp32 accumulators a thread; two
//   CTAs an SM (110.6 KB of ring each).
// * Epilogue: the accumulators are rounded once to bf16 into a tile in
//   shared memory, which leaves in 16-byte stores.  Every output is one
//   thread's sum in a fixed order (chunks in order, taps in order within a
//   chunk): two runs give the same bits.
// L2 reads (ops/conv3x3_cuda.l2_bytes) at 56², 28² and 14²: x 129 / 118 /
// 103 MB and w9 264 / 302 / 302 MB.  The earlier design, which staged one
// tap of 128 pixels a step, read x nine times (925 / 462 / 462 MB) and w9
// once per 128 pixels (462 MB at each case).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 256;       // output pixel slots per CTA
constexpr int kBN = 64;        // filters per CTA
constexpr int kKC = 16;        // channels per chunk (one k16 step a tap)
constexpr int kHaloMax = 336;  // staged halo pixels at most (ops/conv3x3_cuda.HALO_MAX)
constexpr int kStages = 3;
constexpr int kMaxC = 1024;    // ops/conv3x3_cuda.MAX_CHANNELS
constexpr int kLdA = kKC + 8;  // halo pixel stride (bf16): 48 bytes
constexpr int kLdB = kBN + 8;  // w9 row stride (bf16): 144 bytes
constexpr int kXVals = kHaloMax * kLdA;
constexpr int kStageVals = kXVals + 9 * kKC * kLdB;
constexpr int kXVecs = (kHaloMax * 2 + kThreads - 1) / kThreads;  // x copies a thread
constexpr int kWVecs = (9 * kKC * kBN / 8 + kThreads - 1) / kThreads;
constexpr size_t kRingBytes = (size_t)kStages * kStageVals * sizeof(__nv_bfloat16);
static_assert(kBM * kLdB <= kStages * kStageVals, "the epilogue tile fits in the ring");

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

size_t smem_bytes(int C) { return kRingBytes + (size_t)C * 2 * sizeof(__nv_bfloat16); }

__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w9,
                   const __nv_bfloat16* __restrict__ s,
                   const __nv_bfloat16* __restrict__ o,
                   __nv_bfloat16* __restrict__ out, int H, int W, int C, int F,
                   int TH, int TW, int tiles_h, int tiles_w) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  // bf16 pairs (c, c + 1) of s and o, after the ring
  uint32_t* s_sh = reinterpret_cast<uint32_t*>(ring + kStages * kStageVals);
  uint32_t* o_sh = s_sh + C / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tw_i = blockIdx.x % tiles_w;
  const int th_i = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / tiles_w / tiles_h;
  const int h0 = th_i * TH, w0 = tw_i * TW, n0 = blockIdx.y * kBN;
  const int hw2 = TW + 2, halo = (TH + 2) * hw2, pixels = TH * TW;
  for (int i = tid; i < C / 2; i += kThreads) {
    const __nv_bfloat162 sp = __halves2bfloat162(s[2 * i], s[2 * i + 1]);
    const __nv_bfloat162 op = __halves2bfloat162(o[2 * i], o[2 * i + 1]);
    s_sh[i] = *reinterpret_cast<const uint32_t*>(&sp);
    o_sh[i] = *reinterpret_cast<const uint32_t*>(&op);
  }

  // this thread's x copies: vector j = tid + 256 i is half j % 2 (8
  // channels) of halo pixel j / 2, image pixel x_pix; x_pix < 0 marks a
  // pixel outside the image, j >= 2 * halo a vector that is never read
  int x_pix[kXVecs];
#pragma unroll
  for (int i = 0; i < kXVecs; ++i) {
    const int j = tid + kThreads * i, hp = j >> 1;
    const int hh = h0 - 1 + hp / hw2, ww = w0 - 1 + hp % hw2;
    x_pix[i] = (j < 2 * halo && hh >= 0 && hh < H && ww >= 0 && ww < W)
        ? (b * H + hh) * W + ww : -1;
  }
  auto x_slot = [&](int slot) { return ring + (size_t)slot * kStageVals; };
  auto w_slot = [&](int slot) { return ring + (size_t)slot * kStageVals + kXVals; };
  auto issue = [&](int step) {
    const int c0 = step * kKC, slot = step % kStages;
    __nv_bfloat16* xs = x_slot(slot);
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int j = tid + kThreads * i;
      const int c = c0 + 8 * (j & 1);
      if (x_pix[i] >= 0 && c < C)
        frame_mma::cp_async16(xs + (j >> 1) * kLdA + 8 * (j & 1), x + (long long)x_pix[i] * C + c);
    }
    __nv_bfloat16* ws = w_slot(slot);
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int j = tid + kThreads * i;  // (tap, k, 8-column group)
      if (j < 9 * kKC * kBN / 8) {
        const int tap = j / (kKC * kBN / 8), k = (j / (kBN / 8)) % kKC, q = j % (kBN / 8);
        const int c = c0 + k, n = n0 + 8 * q;
        const bool in = c < C && n < F;
        frame_mma::cp_async16_zfill(ws + (tap * kKC + k) * kLdB + 8 * q,
                                    in ? w9 + ((long long)tap * C + c) * F + n : w9,
                                    in ? 16 : 0);
      }
    }
  };
  // the affine on this thread's own copies of a landed chunk, in place
  auto transform = [&](int step) {
    const int c0 = step * kKC;
    __nv_bfloat16* xs = x_slot(step % kStages);
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int j = tid + kThreads * i;
      if (j >= 2 * halo) continue;
      const int c = c0 + 8 * (j & 1);
      uint4* v = reinterpret_cast<uint4*>(xs + (j >> 1) * kLdA + 8 * (j & 1));
      uint4 t = make_uint4(0, 0, 0, 0);  // zero outside the image and past C
      if (x_pix[i] >= 0 && c < C) {
        const uint4 raw = *v;
        const int p = c / 2;
        t = make_uint4(affine_relu2(raw.x, s_sh[p], o_sh[p]),
                       affine_relu2(raw.y, s_sh[p + 1], o_sh[p + 1]),
                       affine_relu2(raw.z, s_sh[p + 2], o_sh[p + 2]),
                       affine_relu2(raw.w, s_sh[p + 3], o_sh[p + 3]));
      }
      *v = t;
    }
  };

  // A rows of this lane: output pixel p of the block -> halo pixel of tap (0, 0)
  int a_hp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = warp * 32 + i * 16 + frame_mma::ldm_row(lane);
    a_hp[i] = p < pixels ? (p / TW) * hw2 + p % TW : 0;  // a padding slot reads pixel 0
  }
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.0f;

  const int steps = (C + kKC - 1) / kKC;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(st);
    frame_mma::cp_async_commit();
  }
  __syncthreads();  // s_sh, o_sh
  frame_mma::cp_async_wait<kStages - 2>();
  transform(0);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();  // chunk `step` transformed; every warp done with step - 1's slot
    if (step + kStages - 1 < steps) issue(step + kStages - 1);
    frame_mma::cp_async_commit();
    const __nv_bfloat16* xs = x_slot(step % kStages);
    const __nv_bfloat16* ws = w_slot(step % kStages);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * hw2 + tap % 3;
      uint32_t a[2][4], bf[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        frame_mma::ldmatrix_x4(a[i], xs + (a_hp[i] + toff) * kLdA + frame_mma::ldm_k(lane));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        frame_mma::ldmatrix_x4_trans(
            bf[j], ws + (tap * kKC + frame_mma::ldm_row(lane)) * kLdB + 16 * j +
                       frame_mma::ldm_k(lane));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t)
          frame_mma::mma_bf16(acc[i][t], a[i], bf[t / 2][2 * (t & 1)], bf[t / 2][2 * (t & 1) + 1]);
    }
    frame_mma::cp_async_wait<kStages - 2>();  // this thread's copies of step + 1
    if (step + 1 < steps) transform(step + 1);
  }
  frame_mma::cp_async_wait<0>();
  __syncthreads();  // every warp done with the ring: it holds the C tile now

  // round once into the C tile [kBM][kLdB]: accumulator e of tile (i, t) is
  // pixel (lane / 4) + 8 * (e / 2), filter 2 * (lane % 4) + e % 2
  __nv_bfloat16* cs = ring;
  const int g = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int r = warp * 32 + i * 16 + g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(cs + r * kLdB + 8 * t + 2 * cq) =
            __floats2bfloat162_rn(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
      }
  __syncthreads();
  for (int j = tid; j < kBM * (kBN / 8); j += kThreads) {
    const int r = j / (kBN / 8), q = j % (kBN / 8);
    const int hh = h0 + r / TW, ww = w0 + r % TW, n = n0 + 8 * q;
    if (r < pixels && hh < H && ww < W && n < F)
      *reinterpret_cast<uint4*>(out + (((long long)b * H + hh) * W + ww) * F + n) =
          *reinterpret_cast<const uint4*>(cs + r * kLdB + 8 * q);
  }
}

}  // namespace

// x [B, H, W, C], w9 [9, C, F], s, o [C] -> out [B, H, W, F], all bf16, in
// TH x TW output blocks (ops/conv3x3_cuda.tile_shape).  Needs C % 8 == 0,
// C <= 1024, F % 8 == 0, x, w9 and out 16-byte aligned, TH * TW <= 256 and
// (TH + 2) * (TW + 2) <= 336.
extern "C" int conv3x3_launch(const void* x, const void* w9, const void* s,
                              const void* o, void* out, int B, int H, int W,
                              int C, int F, int TH, int TW, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 || C > kMaxC || F < 8 || F % 8 ||
      TH < 1 || TW < 1 || TH > H || TW > W || TH * TW > kBM ||
      (TH + 2) * (TW + 2) > kHaloMax || (F + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const long long ctas = (long long)B * tiles_h * tiles_w;
  if (ctas > 0x7fffffffLL || (long long)B * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_kernel<<<dim3((unsigned)ctas, (F + kBN - 1) / kBN), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w9),
      static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(o),
      static_cast<__nv_bfloat16*>(out), H, W, C, F, TH, TW, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

// The kernel as the card runs it at C channels: info = {registers a thread,
// local (spill) bytes a thread, shared bytes a CTA, threads a CTA, resident
// CTAs per SM}.  Returns 0, or the cudaError_t of the failed query.
extern "C" int conv3x3_kernel_info(int C, int* info) {
  const size_t smem = smem_bytes(C);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, conv3x3_kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, conv3x3_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)(attr.sharedSizeBytes + smem);
  info[3] = kThreads;
  info[4] = ctas;
  return 0;
}
