// Fused constant-Q transform for Hopper (sm_90a), bound through ctypes.
//
// Replaces the JAX package's TPU kernel
//   guitar_tablature_classification_tpu/ops/cqt_pallas.py::cqt_fused_split_chunked
// and, because it takes any hop and either padding mode, also its siblings
// cqt_fused (dense, reflect padding) and cqt_fused_split (hop not a multiple
// of 128).
//
// What it computes, per analysis window b, frame t and bin f:
//   re/im[t, f] = sum_k padded[t*hop + k] * K[k, f | F+f]
//   s[t, f]     = (re^2 + im^2)^(p/2)
//   dB          = 20 log10(max(amin, s)) - 20 log10(max(amin, max_{t,f} s))
//   dB          = max(dB, -top_db);  dB < gate_threshold -> gate_floor
// and writes [B, F, T] fp32.  The sum over k runs only over rows where the
// bin's filter is nonzero, and, with constant padding, only over rows that
// meet the audio: the dropped terms are exact zeros, so this is the same
// function as the dense contraction.
//
// Bound.  The training recipe (hop 1024, 96 bins, 0.2 s at 44.1 kHz) needs
// 4.88 M multiply-adds per window (re and im) on nonzero filter rows that
// meet the audio, 7.46 M with reflect padding (ops/cqt_cuda.needed_macs;
// the TPU split kernel's tile-granular count is ~20.4 M).  It reads 35 KB
// of fp32 audio per window, the nonzero filter rows that meet the audio
// once (ops/cqt_cuda.needed_filter_values; bf16 at the default tier), and
// writes 3.5 KB.  At B=2048 and the default tier that is 20 GFLOP on bf16
// operands against about 81 MB, so the card's bound (chip_smoke.py
// bound_ms) is set by bytes: about 0.024 ms at 3.35 TB/s, above the 0.020
// ms the bf16 tensor-core peak gives the operations.  This kernel runs its
// products on the FP32 pipes in every tier (below), so its own ceiling is
// the 67 TFLOP/s FP32 rate: 0.30 ms for that work, 12x the bound.
//
// Design (simple first; speed is later work).  The products run in fp32 on
// the FP32 pipes (FFMA) in every tier, which is exact for bf16 operands:
//   highest  fp32 operands;
//   bf16x3   hi = bf16(a), lo = bf16(a - hi); hi*hi + hi*lo + lo*hi;
//   default  both operands rounded to bf16 (nearest even).
// * One CTA per (window, tile of kTileFrames = TT frames).  The padded audio the tile
//   reads is staged in shared memory once (zeros or the reflect index are
//   computed on load; the padding is never written to device memory).
// * Bins are grouped by kGroup = 4.  The filterbank is repacked on the host
//   into per-group rows [lo_g, hi_g) holding only the nonzero span, re and
//   im interleaved, so one lane reads 32 contiguous bytes per filter row and
//   a warp reads 1 KB; the whole packed filterbank is 3.6 MB and stays in L2.
// * Each group's row span is cut into work items of kChunk rows.  Warps take
//   items from a shared counter.  A warp's 32 lanes walk the item's rows
//   with stride 32; each lane keeps 2 * kGroup * TT accumulators (every
//   frame of the tile for every bin of the group), so each filter value
//   loaded feeds TT frames and each audio value loaded from shared memory
//   feeds 2 * kGroup products.
// * Item partial sums are reduced across the warp with shuffles and parked
//   in shared memory; the tile then sums them in item order (deterministic)
//   and writes s = |.|^p.  A second small kernel, one CTA per window, takes
//   the max over (T, F) and applies the dB epilogue in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;      // bins per work item (float4 of re, of im)
constexpr int kThreads = 256;  // threads per CTA of the coefficient kernel
constexpr int kTileFrames = 9; // frames per CTA (ops/cqt_cuda.TILE_FRAMES)

enum Precision { kHighest = 0, kBf16x3 = 1, kDefault = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// np.pad(mode='reflect') index of position i (may lie far outside [0, n)).
__device__ __forceinline__ int reflect_idx(int i, int n) {
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

__device__ __forceinline__ void fma4(float* acc, float v, const float4& w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// meta (int32) = [group_lo | group_off | group_item_start |
//                 group_item_count] (n_groups each), then
//                [item_group | item_k0 | item_k1] (n_items each).
// Two CTAs per SM (<= 128 registers a thread) where the accumulators fit;
// the bf16x3 tier holds twice the filter values and takes one.
template <int TT, int PREC>
__global__ void __launch_bounds__(kThreads, PREC == kBf16x3 ? 1 : 2)
    cqt_coeff_kernel(
    const float* __restrict__ x, const float* __restrict__ filt,
    const int* __restrict__ meta, float* __restrict__ out, int num_samples,
    int n_frames, int n_bins, int hop, int pad, int reflect, int n_groups,
    int n_items, int n_tiles, int k_lo_all, int k_hi_all, int buf_cap,
    float half_power) {
  constexpr int kVec = PREC == kBf16x3 ? 4 : 2;  // float4 per filter row
  constexpr int kAcc = 2 * kGroup * TT;          // [t][re 0..3, im 0..3]
  extern __shared__ float smem[];
  __shared__ int s_next;

  const int* group_lo = meta;
  const int* group_off = meta + n_groups;
  const int* group_item_start = meta + 2 * n_groups;
  const int* group_item_count = meta + 3 * n_groups;
  const int* item_group = meta + 4 * n_groups;
  const int* item_k0 = item_group + n_items;
  const int* item_k1 = item_k0 + n_items;

  const int tile = blockIdx.x % n_tiles;
  const int b = blockIdx.x / n_tiles;
  const int t0 = tile * TT;

  // Filter rows this tile needs: with constant padding, rows that meet the
  // audio for at least one frame of the tile.
  int k_lo = k_lo_all, k_hi = k_hi_all;
  if (!reflect) {
    k_lo = max(k_lo, pad - (t0 + TT - 1) * hop);
    k_hi = min(k_hi, pad + num_samples - t0 * hop);
  }
  const int span = max(k_hi - k_lo, 0);
  const int buf_len = (TT - 1) * hop + span;

  float* s_audio = smem;           // padded[t0*hop + k_lo + i]
  float* s_part = smem + buf_cap;  // [n_items][kAcc] partial sums

  const float* xb = x + (size_t)b * num_samples;
  const int src0 = t0 * hop + k_lo - pad;
  for (int i = threadIdx.x; i < buf_len; i += kThreads) {
    int src = src0 + i;
    float v = 0.f;
    if (reflect) {
      v = xb[reflect_idx(src, num_samples)];
    } else if (src >= 0 && src < num_samples) {
      v = xb[src];
    }
    if (PREC == kDefault) v = round_bf16(v);
    s_audio[i] = v;
  }
  if (threadIdx.x == 0) s_next = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (;;) {
    int it = 0;
    if (lane == 0) it = atomicAdd(&s_next, 1);
    it = __shfl_sync(0xffffffffu, it, 0);
    if (it >= n_items) break;

    const int g = item_group[it];
    const int k0 = max(item_k0[it], k_lo);
    const int k1 = min(item_k1[it], k_hi);
    const int glo = group_lo[g];
    const float4* base =
        reinterpret_cast<const float4*>(filt) + (size_t)group_off[g] * kVec;

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    for (int k = k0 + lane; k < k1; k += 32) {
      const float4* row = base + (size_t)(k - glo) * kVec;
      const float* a = s_audio + (k - k_lo);
      if (PREC == kBf16x3) {
        const float4 re_hi = __ldg(row), re_lo = __ldg(row + 1);
        const float4 im_hi = __ldg(row + 2), im_lo = __ldg(row + 3);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float v = a[t * hop];
          const float v_hi = round_bf16(v);
          const float v_lo = round_bf16(v - v_hi);
          float* ar = acc + t * 2 * kGroup;
          float* ai = ar + kGroup;
          fma4(ar, v_hi, re_hi);
          fma4(ar, v_hi, re_lo);
          fma4(ar, v_lo, re_hi);
          fma4(ai, v_hi, im_hi);
          fma4(ai, v_hi, im_lo);
          fma4(ai, v_lo, im_hi);
        }
      } else {
        const float4 re = __ldg(row), im = __ldg(row + 1);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float v = a[t * hop];
          float* ar = acc + t * 2 * kGroup;
          fma4(ar, v, re);
          fma4(ar + kGroup, v, im);
        }
      }
    }

    float* dst = s_part + (size_t)it * kAcc;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      float v = acc[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if ((i & 31) == lane) dst[i] = v;
    }
  }
  __syncthreads();

  // Sum each group's items in order and write s = (re^2 + im^2)^(p/2).
  for (int idx = threadIdx.x; idx < n_groups * kGroup * TT; idx += kThreads) {
    const int t = idx % TT;
    const int gj = idx / TT;
    const int g = gj / kGroup;
    const int j = gj % kGroup;
    const int f = gj;
    const int tt = t0 + t;
    if (f >= n_bins || tt >= n_frames) continue;
    const int start = group_item_start[g];
    const int count = group_item_count[g];
    float re = 0.f, im = 0.f;
    for (int q = 0; q < count; ++q) {
      const float* p = s_part + (size_t)(start + q) * kAcc + t * 2 * kGroup;
      re += p[j];
      im += p[kGroup + j];
    }
    const float mag2 = re * re + im * im;
    out[((size_t)b * n_bins + f) * n_frames + tt] = powf(mag2, half_power);
  }
}

// One CTA per window: ref = max over (F, T) of s, then the dB epilogue in
// place.
__global__ void __launch_bounds__(256) cqt_db_kernel(
    float* __restrict__ out, int per_window, float amin, float top_db,
    float gate_threshold_db, float gate_floor_db) {
  __shared__ float red[32];
  float* o = out + (size_t)blockIdx.x * per_window;
  float m = 0.f;  // s >= 0
  for (int i = threadIdx.x; i < per_window; i += blockDim.x) m = fmaxf(m, o[i]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float ref_db = 20.f * log10f(fmaxf(amin, red[0]));
  for (int i = threadIdx.x; i < per_window; i += blockDim.x) {
    float db = 20.f * log10f(fmaxf(amin, o[i])) - ref_db;
    db = fmaxf(db, -top_db);
    o[i] = db < gate_threshold_db ? gate_floor_db : db;
  }
}

template <int PREC>
cudaError_t launch_coeff(const float* x, const float* filt, const int* meta,
                         float* out, int batch, int num_samples, int n_frames,
                         int n_bins, int hop, int pad, int reflect,
                         int n_groups, int n_items, int k_lo, int k_hi,
                         int buf_cap, float half_power, cudaStream_t stream) {
  constexpr int TT = kTileFrames;
  const int n_tiles = (n_frames + TT - 1) / TT;
  const size_t smem =
      ((size_t)buf_cap + (size_t)n_items * 2 * kGroup * TT) * sizeof(float);
  auto kernel = cqt_coeff_kernel<TT, PREC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch * n_tiles, kThreads, smem, stream>>>(
      x, filt, meta, out, num_samples, n_frames, n_bins, hop, pad, reflect,
      n_groups, n_items, n_tiles, k_lo, k_hi, buf_cap, half_power);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the failed step.
extern "C" int cqt_fused_launch(
    const float* x, const float* filt, const int* meta, float* out, int batch,
    int num_samples, int n_frames, int n_bins, int hop, int pad, int reflect,
    int n_groups, int n_items, int k_lo, int k_hi, int tile_frames,
    int buf_cap, int precision, float magnitude_power, float amin,
    float top_db, float gate_threshold_db, float gate_floor_db,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float half_power = 0.5f * magnitude_power;
  if (tile_frames != kTileFrames) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (precision) {
    case kHighest:
      err = launch_coeff<kHighest>(x, filt, meta, out, batch, num_samples,
                                   n_frames, n_bins, hop, pad, reflect,
                                   n_groups, n_items, k_lo, k_hi, buf_cap,
                                   half_power, stream);
      break;
    case kBf16x3:
      err = launch_coeff<kBf16x3>(x, filt, meta, out, batch, num_samples,
                                  n_frames, n_bins, hop, pad, reflect,
                                  n_groups, n_items, k_lo, k_hi, buf_cap,
                                  half_power, stream);
      break;
    case kDefault:
      err = launch_coeff<kDefault>(x, filt, meta, out, batch, num_samples,
                                   n_frames, n_bins, hop, pad, reflect,
                                   n_groups, n_items, k_lo, k_hi, buf_cap,
                                   half_power, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  cqt_db_kernel<<<batch, 256, 0, stream>>>(out, n_bins * n_frames, amin, top_db,
                                           gate_threshold_db, gate_floor_db);
  return (int)cudaGetLastError();
}
