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
// ms the bf16 tensor-core peak gives the operations.
// At the flagship's B=256 and highest that is 2.5 GFLOP, six bf16 passes
// of it 15 GFLOP: 0.015 ms at the bf16 tensor-core peak, against 0.037 ms
// on the FP32 pipes.
//
// Two kernels, routed by the tier, the hop and the batch
// (ops/cqt_cuda.cqt_route):
// * cqt_mma_kernel on the tensor cores (csrc/frame_mma.cuh; its design is
//   described at the kernel) runs the default tier at any hop, bf16x3 at
//   a hop that is a multiple of 8, and highest there where its grid fills
//   the card's waves (one CTA holds an SM for a whole wave: at the
//   flagship's B=256 its 86 CTAs leave 46 SMs idle and the SIMT kernel is
//   faster).  It splits both operands into
//   bf16 pieces (nearest even; each piece is the bf16 of what the pieces
//   before it leave) and issues products of pieces on mma.sync:
//     default  1 piece,  hi*hi (the operands rounded to bf16);
//     bf16x3   2 pieces, hi*hi + hi*lo + lo*hi (the JAX package's split);
//     highest  3 pieces, the six products down to 2^-16 of hi*hi (the TPU
//              kernel's six-pass HIGHEST, cqt_pallas.py:45-53), as
//              accurate as fp32: each chunk's products are summed from
//              zero and added into a round-to-nearest fp32 total.
//   Its bound at highest is six bf16 tensor-core passes, three at bf16x3
//   (below the FP32 pipes' time for the same products).
// * cqt_coeff_kernel on the FP32 pipes (FFMA; its ceiling is the 67
//   TFLOP/s FP32 rate) runs the rest of highest and bf16x3, exact for
//   bf16 operands:
//     highest  fp32 operands;
//     bf16x3   hi = bf16(a), lo = bf16(a - hi); hi*hi + hi*lo + lo*hi.
// Both write s = |.|^p, then cqt_db_kernel applies the dB epilogue.
//
// Design of cqt_coeff_kernel (simple first; speed is later work).
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

#include "frame_mma.cuh"

namespace {

constexpr int kGroup = 4;      // bins per work item (float4 of re, of im)
constexpr int kThreads = 256;  // threads per CTA of the coefficient kernel
constexpr int kTileFrames = 9; // frames per CTA (ops/cqt_cuda.TILE_FRAMES)

enum Precision { kHighest = 0, kBf16x3 = 1, kDefault = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
      v = xb[frame_mma::reflect_idx(src, num_samples)];
    } else if (src >= 0 && src < num_samples) {
      v = xb[src];
    }
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

// ------------------------------------------------------ the tensor cores

constexpr int kBandGroups = 4;    // bin groups a band (a unit's columns); ops/cqt_cuda.MMA_BAND_GROUPS
constexpr int kPartCols = 8 * kBandGroups;  // (re, im) x 4 bins x groups
constexpr int kMaxGroups = 64;    // ops/cqt_cuda.MMA_MAX_GROUPS
constexpr int kMaxBands = kMaxGroups / kBandGroups;
constexpr int kStageUnroll = 8;   // audio loads a thread keeps in flight

// Threads a CTA at a tier's count of bf16 pieces (ops/cqt_cuda.mma_warps),
// one CTA an SM: 16 warps at up to 128 registers for one piece; the split
// tiers' units hold a round-to-nearest total beside the A and B fragments
// of every piece, so 12 warps at up to 168 registers for two (bf16x3) and
// 8 at up to 255 for three (highest, which spills at 12).
__host__ __device__ constexpr int mma_threads(int parts) {
  return parts == 1 ? 512 : parts == 2 ? 384 : 256;
}
// m16 tiles a unit (ops/cqt_cuda.mma_unit_rows): 4 (64 rows) at one piece,
// 2 (32 rows) at two or three, whose fragments of every piece take the
// registers and whose CTAs hold few rows (the staged pieces fill the
// shared memory), so that more of the partial sums' rows are real.
__host__ __device__ constexpr int unit_tiles(int parts) { return parts == 1 ? 4 : 2; }

// Two bf16 values of a staged row at window-local indices d, d + 1 (zero
// outside [0, L)), packed as an mma operand register: the 16-bit load path.
__device__ __forceinline__ uint32_t pair_at(const unsigned short* row, int d, int L) {
  const uint32_t lo = (unsigned)d < (unsigned)L ? row[d] : 0u;
  const uint32_t hi = (unsigned)(d + 1) < (unsigned)L ? row[d + 1] : 0u;
  return lo | (hi << 16);
}

// floor(a / d) for 0 <= a < 2^24, with inv_d = 1.0f / d.
__device__ __forceinline__ int div_small(int a, int d, float inv_d) {
  int q = __float2int_rz((float)a * inv_d);
  if (q * d > a) --q;
  if ((q + 1) * d <= a) ++q;
  return q;
}

// A warp's unit: this lane's rows (d = roff + x is the row's window-local
// index at the walk's x; its element is rpos + x + skew floor(x / hop); a
// padded row has roff far below 0 and reads zeros) and the walk over the
// chunks (x = 16 (c - c_s) + koff - i0, q = floor(x / hop), rem = x - q hop).
template <int kTiles>
struct UnitRows {
  int roff[kTiles][2];
  int rpos[kTiles][2];
};
struct Walk {
  int x, q, rem;
};

// Where a unit reads its operands: the staged audio (piece p of the value
// at element e lies at e + p * pst; zero_off holds 8 zeros in every piece)
// and the fragment-order filter (piece p's blocks from uint2 p * fpiece).
struct Operands {
  uint32_t sbase;
  const unsigned short* sbuf;
  int zero_off, L, hop, skew, pst;
  const uint2* __restrict__ filt;
  int fpiece;
};

// Chunks [s0, s1) of a unit on which exactly the band's first K groups are
// live (their spans nest): NT m16 tiles x K groups a chunk, no predicate;
// the B fragments of the chunk two ahead are loaded while the current
// chunk's products run.  One piece: mma.sync into acc.  kParts pieces: for
// each (tile, group) the tier's products of pieces, smallest first, into a
// zeroed sum, which is then added to acc, the unit's round-to-nearest fp32
// total (the tensor cores' fp32 accumulation is not round-to-nearest over
// a long chain, and highest must hold fp32's accuracy).
template <bool kLdm, int kParts, int kTiles, int NT, int K>
__device__ __forceinline__ void run_segment(
    int s0, int s1, Walk& wk, const UnitRows<kTiles>& ur, const Operands& op,
    const int (&gblk)[kBandGroups], int lane, float (&acc)[kTiles][kBandGroups][4]) {
  static_assert(kLdm || kParts == 1, "the 16-bit load path takes one piece");
  if (s0 >= s1) return;
  auto load_b = [&](int c, uint2(&b)[kParts][K]) {
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int gi = 0; gi < K; ++gi)
        b[p][gi] = __ldg(op.filt + (size_t)p * op.fpiece + (size_t)(gblk[gi] + c) * 32 + lane);
  };
  auto chunk = [&](const uint2(&b)[kParts][K]) {
    uint32_t a[kParts][NT][4];
    const int cterm = wk.x + op.skew * wk.q;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (kLdm) {
        const int d = ur.roff[i][0] + wk.x;
        const int e = (unsigned)d < (unsigned)op.L ? ur.rpos[i][0] + cterm : op.zero_off;
#pragma unroll
        for (int p = 0; p < kParts; ++p)
          frame_mma::ldmatrix_x4_at(a[p][i], op.sbase + 2u * (uint32_t)(e + p * op.pst));
      } else {
        const unsigned short* lo = op.sbuf + (ur.rpos[i][0] - ur.roff[i][0]);
        const unsigned short* hi = op.sbuf + (ur.rpos[i][1] - ur.roff[i][1]);
        const int d_lo = ur.roff[i][0] + wk.x, d_hi = ur.roff[i][1] + wk.x;
        a[0][i][0] = pair_at(lo, d_lo, op.L);
        a[0][i][1] = pair_at(hi, d_hi, op.L);
        a[0][i][2] = pair_at(lo, d_lo + 8, op.L);
        a[0][i][3] = pair_at(hi, d_hi + 8, op.L);
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int gi = 0; gi < K; ++gi) {
        if constexpr (kParts == 1) {
          frame_mma::mma_bf16(acc[i][gi], a[0][i], b[0][gi].x, b[0][gi].y);
        } else {
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < frame_mma::n_products(kParts); ++q) {
            const int pa = frame_mma::prod_a(kParts, q), pb = frame_mma::prod_b(kParts, q);
            frame_mma::mma_bf16(sum, a[pa][i], b[pb][gi].x, b[pb][gi].y);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][gi][e] += sum[e];
        }
      }
    wk.x += 16;
    wk.rem += 16;
    while (wk.rem >= op.hop) {
      wk.rem -= op.hop;
      ++wk.q;
    }
  };
  uint2 b0[kParts][K], b1[kParts][K];
  load_b(s0, b0);
  if (s0 + 1 < s1) load_b(s0 + 1, b1);
  for (int c = s0; c < s1; c += 2) {
    chunk(b0);
    if (c + 2 < s1) load_b(c + 2, b0);
    if (c + 1 < s1) {
      chunk(b1);
      if (c + 3 < s1) load_b(c + 3, b1);
    }
  }
}

// A unit's piece [ca, cb) of a band: the seven segments of the nested spans
// (1, 2, 3, 4, 3, 2, 1 live groups), each at its own count.
template <bool kLdm, int kParts, int kTiles, int NT>
__device__ __forceinline__ void run_unit(
    int ca, int cb, const int (&glo)[kBandGroups], const int (&ghi)[kBandGroups], Walk& wk,
    const UnitRows<kTiles>& ur, const Operands& op, const int (&gblk)[kBandGroups], int lane,
    float (&acc)[kTiles][kBandGroups][4]) {
  static_assert(kBandGroups == 4, "the segment table below is for four groups");
  // The edges glo[0..3], ghi[3..0]: one piece keeps the table it was tuned
  // with; the split tiers pick by selects (an indexed table lives in local
  // memory, which their kernels otherwise do without).
  const int table[8] = {glo[0], glo[1], glo[2], glo[3], ghi[3], ghi[2], ghi[1], ghi[0]};
  const int live_table[7] = {1, 2, 3, 4, 3, 2, 1};  // live groups a segment
  auto edge = [&](int e) {
    if constexpr (kParts == 1) {
      return table[e];
    } else {
      return e == 0 ? glo[0] : e == 1 ? glo[1] : e == 2 ? glo[2] : e == 3 ? glo[3]
           : e == 4 ? ghi[3] : e == 5 ? ghi[2] : e == 6 ? ghi[1] : ghi[0];
    }
  };
  auto live = [&](int seg) {
    if constexpr (kParts == 1) {
      return live_table[seg];
    } else {
      return seg < 4 ? seg + 1 : 7 - seg;
    }
  };
#pragma unroll 1
  for (int s = 0; s < 7; ++s) {
    const int s0 = max(edge(s), ca), s1 = min(edge(s + 1), cb);
    switch (live(s)) {
      case 1:
        run_segment<kLdm, kParts, kTiles, NT, 1>(s0, s1, wk, ur, op, gblk, lane, acc);
        break;
      case 2:
        run_segment<kLdm, kParts, kTiles, NT, 2>(s0, s1, wk, ur, op, gblk, lane, acc);
        break;
      case 3:
        run_segment<kLdm, kParts, kTiles, NT, 3>(s0, s1, wk, ur, op, gblk, lane, acc);
        break;
      default:
        run_segment<kLdm, kParts, kTiles, NT, 4>(s0, s1, wk, ur, op, gblk, lane, acc);
    }
  }
}

// The CTA's rows are (window, frame) pairs: W windows of its window block
// times TF frames of its frame tile, in m16 tiles.  It stages their audio
// once, then its warps take units from one list over all bands (a band:
// kBandGroups groups, nested spans): a unit is up to kTiles m16 tiles
// over one of the band's pieces of its 16-row filter chunks (band b cut into
// pieces[b], from the plan, so that the units' work is about even), for
// every group of the band: each A fragment feeds the band's groups whose
// span holds the chunk, each B fragment the unit's m16 tiles (up to 16
// mma.sync per 4 ldmatrix and 4 B loads at one piece).  Each unit parks its
// partial sums in shared memory; after one barrier every output sums its
// band's pieces in order (no float sum depends on timing).
//
// kParts: the tier's bf16 pieces of both operands (1 default, 2 bf16x3, 3
// highest).  Each staged sample and each filter value is split once into
// its pieces (piece p is the bf16 of what the pieces before it leave, so
// the pieces add up to the fp32 value); a chunk loads each piece's A and B
// fragments once and issues the tier's products of pieces
// (frame_mma::prod_a, prod_b) for each (tile, group).
//
// gmeta (int32) = [c_lo | c_hi | blk_off] (n_groups each) + [pieces]
// (n_bands): group g's filter rows [16 c_lo, 16 c_hi) are packed blocks
// blk_off .. blk_off + c_hi - c_lo of each piece of filt (fpiece uint2 a
// piece); block (g, c) holds K's rows 16c .. 16c + 15 for the group's 4
// bins (re, im interleaved: column 2j re, 2j + 1 im of bin 4g + j) in the
// mma B-fragment order: lane l's uint2 = {K[16c + 2(l%4) + {0,1}, l/4],
// K[16c + 2(l%4) + 8 + {0,1}, l/4]}.  A warp loads the B fragments of the
// chunk two ahead while the tensor cores run the current one's.
//
// Staged audio: buffer index i in [i0, i1) of window w (i: padded[t0*hop +
// 16 c_s + i]; with constant padding [i0, i1) is the 8-aligned span that
// meets the audio) lies at element p*pst + w*wstride + d + skew * floor(d /
// hop) of piece p, d = i - i0, pst = W*wstride + 8, staged four samples at
// a time (one 16-byte load where the audio is so aligned).  Row (w, tt) at
// chunk c reads from d = tt*hop + x, x = 16 (c - c_s) - i0 (+ the lane's k
// offset), so at w*wstride + tt*(hop + skew) + x + skew * floor(x / hop):
// with hop and skew multiples of 8, each 8-sample row of an ldmatrix stays
// 16-byte aligned and inside one skew block, rows of successive frames lie
// hop + skew apart, which spreads a fragment's frames over the banks, and a
// row outside [i0, i1) reads the piece's block of 8 zeros at W*wstride.
// kLdm = false (hop not a multiple of 8; one piece only): skew 0, 16-bit
// loads, staged one sample at a time.
template <bool kLdm, int kParts>
__global__ void __launch_bounds__(mma_threads(kParts), 1)
    cqt_mma_kernel(const float* __restrict__ x, const uint2* __restrict__ filt,
                   const int* __restrict__ gmeta, float* __restrict__ out, int batch,
                   int num_samples, int n_frames, int n_bins, int hop, int pad, int reflect,
                   int n_groups, int skew, int W, int TF, int wstride, int part_off,
                   int n_ftiles, int fpiece, float half_power) {
  constexpr int kThreads = mma_threads(kParts);
  constexpr int kWarps = kThreads / 32;
  constexpr int kTiles = unit_tiles(kParts);  // m16 tiles a unit
  constexpr int kUnitRows = 16 * kTiles;
  extern __shared__ float smem[];  // the same symbol as cqt_coeff_kernel's
  __shared__ int s_meta[3 * kMaxGroups + kMaxBands];
  __shared__ int s_uoff[kMaxBands + 1];  // first unit of each band
  unsigned short* sbuf = reinterpret_cast<unsigned short*>(smem);
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) + part_off);
  const int n_bands = (n_groups + kBandGroups - 1) / kBandGroups;
  for (int i = threadIdx.x; i < 3 * n_groups + n_bands; i += kThreads) s_meta[i] = gmeta[i];
  const int* c_lo = s_meta;
  const int* c_hi = s_meta + n_groups;
  const int* blk_off = s_meta + 2 * n_groups;
  const int* pieces = s_meta + 3 * n_groups;

  const int t0 = (blockIdx.x % n_ftiles) * TF;
  const int b0 = (blockIdx.x / n_ftiles) * W;
  const int rows = W * TF;
  const int mt = (rows + 15) >> 4;
  const int units_m = (rows + kUnitRows - 1) / kUnitRows;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int b = 0; b < n_bands; ++b) {
      s_uoff[b] = acc;
      acc += units_m * pieces[b];
    }
    s_uoff[n_bands] = acc;
  }
  // Chunks whose rows meet the audio in some frame of the tile (with
  // constant padding; the rest multiply zeros), within those of all groups.
  int clip_lo = 0, clip_hi = 1 << 30;
  if (!reflect) {
    clip_lo = (pad - (t0 + TF - 1) * hop) >> 4;         // floor
    clip_hi = (pad + num_samples - t0 * hop + 15) >> 4;  // ceil
  }
  int c_s = 1 << 30, c_e = 0;
  for (int g = 0; g < n_groups; ++g) {
    c_s = min(c_s, c_lo[g]);
    c_e = max(c_e, c_hi[g]);
  }
  c_s = max(c_s, clip_lo);
  c_e = max(min(c_e, clip_hi), c_s);
  const int len = (TF - 1) * hop + 16 * (c_e - c_s);
  const float inv_hop = 1.0f / (float)hop;

  // 1. Stage the audio the tile reads as its bf16 pieces: buffer indices
  // [i0, i1), 8-aligned; with constant padding only the part that meets the
  // audio (the rest of [0, len) is zero and reads the zero block).  kLdm:
  // four samples a step (4 divides hop, so they share a skew block), with
  // kStageUnroll steps in flight a thread.
  const int p0 = t0 * hop + 16 * c_s - pad;  // audio index of buffer index 0
  int i_lo = 0, i_hi = len;
  if (!reflect) {
    i_lo = min(max(-p0, 0), len);
    i_hi = max(min(num_samples - p0, len), i_lo);
  }
  const int i0 = i_lo & ~7, i1 = max((i_hi + 7) & ~7, i0);
  const int L = i1 - i0;
  const int zero_off = W * wstride;  // 8 zeros in each piece
  const int pst = W * wstride + 8;   // elements a piece
  if (threadIdx.x < 8 * kParts) sbuf[zero_off + (threadIdx.x >> 3) * pst + (threadIdx.x & 7)] = 0;
  constexpr int kVec = kLdm ? 4 : 1;
  const int lv = L / kVec;  // steps a window (L is a multiple of 8)
  // 16-byte loads: the whole step inside the audio and 16-byte aligned
  const bool vec_ok = kLdm && !reflect && num_samples % 4 == 0 && (p0 + i0) % 4 == 0;
  if (lv > 0) {
    const float inv_lv = 1.0f / (float)lv;
    for (int e0 = 0; e0 < W * lv; e0 += kThreads * kStageUnroll) {
      float v[kStageUnroll][kVec];
      int dst[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * kThreads + threadIdx.x;
        const int w = div_small(e, lv, inv_lv);
        const int d = (e - w * lv) * kVec;
        const int i = i0 + d;
        const int b = b0 + w;
        dst[u] = -1;
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[u][k] = 0.f;
        if (e < W * lv) {
          dst[u] = w * wstride + d + (kLdm && skew ? skew * div_small(d, hop, inv_hop) : 0);
          if (b < batch) {
            const float* xb = x + (size_t)b * num_samples;
            if (vec_ok && i >= i_lo && i + kVec <= i_hi) {
              const float4 f = __ldg(reinterpret_cast<const float4*>(xb + p0 + i));
              v[u][0] = f.x;
              v[u][kVec > 1 ? 1 : 0] = f.y;
              v[u][kVec > 2 ? 2 : 0] = f.z;
              v[u][kVec > 3 ? 3 : 0] = f.w;
            } else {
#pragma unroll
              for (int k = 0; k < kVec; ++k) {
                const int a = p0 + i + k;
                if (i + k >= i_lo && i + k < i_hi)
                  v[u][k] = xb[reflect ? frame_mma::reflect_idx(a, num_samples) : a];
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        if (dst[u] < 0) continue;
        if (kLdm) {
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            uint2 q;
            q.x = (uint32_t)frame_mma::take_piece(v[u][0]) |
                  ((uint32_t)frame_mma::take_piece(v[u][kVec > 1 ? 1 : 0]) << 16);
            q.y = (uint32_t)frame_mma::take_piece(v[u][kVec > 2 ? 2 : 0]) |
                  ((uint32_t)frame_mma::take_piece(v[u][kVec > 3 ? 3 : 0]) << 16);
            *reinterpret_cast<uint2*>(sbuf + dst[u] + p * pst) = q;
          }
        } else {
          sbuf[dst[u]] = frame_mma::bf16_bits(v[u][0]);
        }
      }
    }
  }
  __syncthreads();

  // 2. Products: units over all bands (band-major, then piece, then rows).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rstride = hop + (kLdm ? skew : 0);
  const int koff = kLdm ? frame_mma::ldm_k(lane) : 2 * (lane & 3);
  const Operands op{frame_mma::smem_addr(sbuf), sbuf, zero_off, L, hop, skew, pst, filt, fpiece};
  const int n_units = s_uoff[n_bands];
  for (int u = warp; u < n_units; u += kWarps) {
    int band = 0;
    while (s_uoff[band + 1] <= u) ++band;
    const int local = u - s_uoff[band];
    const int um = local % units_m, q = local / units_m, kp = pieces[band];
    const int g0 = band * kBandGroups, g1 = min(g0 + kBandGroups, n_groups);
    int c_a = c_lo[g0], c_b = c_hi[g0];
    for (int g = g0 + 1; g < g1; ++g) {
      c_a = min(c_a, c_lo[g]);
      c_b = max(c_b, c_hi[g]);
    }
    c_a = max(c_a, c_s);
    c_b = max(min(c_b, c_e), c_a);
    const int nc = c_b - c_a;
    const int ca = c_a + (q * nc) / kp, cb = c_a + ((q + 1) * nc) / kp;
    const int ntile = min(kTiles, mt - um * kTiles);
    UnitRows<kTiles> ur;
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (um * kTiles + i) * 16 +
                      (kLdm ? frame_mma::ldm_row(lane) : (lane >> 2) + 8 * h);
        const int w = r / TF, tt = r - (r / TF) * TF;
        ur.roff[i][h] = r < rows ? tt * hop : -(1 << 29);
        ur.rpos[i][h] = r < rows ? w * wstride + tt * rstride : 0;
      }
    // the band's groups (their spans nest); a missing group gets the empty
    // span at the last one's end
    int glo[kBandGroups], ghi[kBandGroups], gblk[kBandGroups];
#pragma unroll
    for (int gi = 0; gi < kBandGroups; ++gi) {
      const int g = min(g0 + gi, g1 - 1);
      glo[gi] = g0 + gi < g1 ? c_lo[g] : c_hi[g];
      ghi[gi] = c_hi[g];
      gblk[gi] = blk_off[g] - c_lo[g];
    }
    float acc[kTiles][kBandGroups][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int gi = 0; gi < kBandGroups; ++gi)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][gi][e] = 0.f;
    Walk wk;
    wk.x = 16 * (ca - c_s) + koff - i0;
    wk.q = wk.x / hop;
    if (wk.x - wk.q * hop < 0) --wk.q;
    wk.rem = wk.x - wk.q * hop;
    switch (ntile) {
      case 1:
        run_unit<kLdm, kParts, kTiles, 1>(ca, cb, glo, ghi, wk, ur, op, gblk, lane, acc);
        break;
      case 2:
        run_unit<kLdm, kParts, kTiles, (kTiles < 2 ? kTiles : 2)>(ca, cb, glo, ghi, wk, ur, op,
                                                                   gblk, lane, acc);
        break;
      case 3:
        run_unit<kLdm, kParts, kTiles, (kTiles < 3 ? kTiles : 3)>(ca, cb, glo, ghi, wk, ur, op,
                                                                   gblk, lane, acc);
        break;
      default:
        run_unit<kLdm, kParts, kTiles, kTiles>(ca, cb, glo, ghi, wk, ur, op, gblk, lane, acc);
    }
    // the unit's partial sums: part[u][row of the unit][group, bin, re|im]
    float* dstp = part + (size_t)u * kUnitRows * kPartCols;
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = dstp + (i * 16 + (lane >> 2) + 8 * h) * kPartCols + 2 * (lane & 3);
#pragma unroll
        for (int gi = 0; gi < kBandGroups; ++gi)
          *reinterpret_cast<float2*>(row + 8 * gi) =
              make_float2(acc[i][gi][2 * h], acc[i][gi][2 * h + 1]);
      }
  }
  __syncthreads();

  // 3. Each output sums its band's pieces in order: s = (re^2 + im^2)^(p/2).
  for (int idx = threadIdx.x; idx < rows * n_bins; idx += kThreads) {
    const int r = idx / n_bins, f = idx - (idx / n_bins) * n_bins;
    const int w = r / TF;
    const int b = b0 + w, t = t0 + r - w * TF;
    if (b >= batch || t >= n_frames) continue;
    const int band = f / (4 * kBandGroups), gj = f % (4 * kBandGroups);
    const float* src = part + ((size_t)(s_uoff[band] + r / kUnitRows) * kUnitRows +
                               r % kUnitRows) * kPartCols + 2 * gj;
    const size_t piece_stride = (size_t)units_m * kUnitRows * kPartCols;
    float re = 0.f, im = 0.f;
    for (int q = 0; q < pieces[band]; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(src + q * piece_stride);
      re += v.x;
      im += v.y;
    }
    out[((size_t)b * n_bins + f) * n_frames + t] = powf(re * re + im * im, half_power);
  }
}

// The tensor-core kernel of a hop's load path (ldm: a hop that is a
// multiple of 8) and a tier's pieces, or null where there is none.
using MmaKernel = void (*)(const float*, const uint2*, const int*, float*, int, int, int, int,
                           int, int, int, int, int, int, int, int, int, int, int, float);
MmaKernel mma_kernel(bool ldm, int parts) {
  if (!ldm) return parts == 1 ? cqt_mma_kernel<false, 1> : nullptr;
  return parts == 1   ? cqt_mma_kernel<true, 1>
         : parts == 2 ? cqt_mma_kernel<true, 2>
         : parts == 3 ? cqt_mma_kernel<true, 3>
                      : nullptr;
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

// The highest and bf16x3 tiers on the FP32 pipes (cqt_coeff_kernel), which
// they take at a hop that is not a multiple of 8 (else cqt_fused_mma_launch).
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
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  cqt_db_kernel<<<batch, 256, 0, stream>>>(out, n_bins * n_frames, amin, top_db,
                                           gate_threshold_db, gate_floor_db);
  return (int)cudaGetLastError();
}

// Every tier on the tensor cores (highest and bf16x3 at a hop that is a
// multiple of 8): cqt_mma_kernel with `parts` bf16 pieces (1 default, 2
// bf16x3, 3 highest), one CTA per (window block, frame tile), then the same
// dB epilogue.  filt holds `parts` pieces of piece_blocks fragment-order
// blocks each; gmeta carries the plan's pieces per band after the group
// table.  Returns 0 on success, else the cudaError_t of the failed step.
extern "C" int cqt_fused_mma_launch(
    const float* x, const void* filt, const int* gmeta, float* out, int batch,
    int num_samples, int n_frames, int n_bins, int hop, int pad, int reflect, int n_groups,
    int skew, int windows, int frames, int wstride, int part_off, int smem_bytes, int parts,
    int piece_blocks, float magnitude_power, float amin, float top_db, float gate_threshold_db,
    float gate_floor_db, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool ldm = hop % 8 == 0;
  const MmaKernel kernel = mma_kernel(ldm, parts);
  if (kernel == nullptr || batch < 1 || windows < 1 || frames < 1 || (!ldm && skew != 0) ||
      n_groups < 1 || n_groups > kMaxGroups || piece_blocks < 1 || piece_blocks > (1 << 25))
    return (int)cudaErrorInvalidValue;
  const int n_ftiles = (n_frames + frames - 1) / frames;
  const long long n_ctas = (long long)n_ftiles * ((batch + windows - 1) / windows);
  if (n_ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_ctas, mma_threads(parts), smem_bytes, stream>>>(
      x, static_cast<const uint2*>(filt), gmeta, out, batch, num_samples, n_frames, n_bins,
      hop, pad, reflect, n_groups, skew, windows, frames, wstride, part_off, n_ftiles,
      32 * piece_blocks, 0.5f * magnitude_power);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cqt_db_kernel<<<batch, 256, 0, stream>>>(out, n_bins * n_frames, amin, top_db,
                                           gate_threshold_db, gate_floor_db);
  return (int)cudaGetLastError();
}

// The tensor-core kernel (ldmatrix variant) with `parts` pieces as the card
// runs it at a plan's shared bytes: info = {registers a thread, local
// (spill) bytes a thread, shared bytes a CTA, threads a CTA, resident CTAs
// per SM}.  Returns 0, or the cudaError_t of the failed query.
extern "C" int cqt_mma_kernel_info(int parts, int smem_bytes, int* info) {
  const MmaKernel kernel = mma_kernel(true, parts);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, (const void*)kernel,
                                                      mma_threads(parts), smem_bytes);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes + smem_bytes;
  info[3] = mma_threads(parts);
  info[4] = ctas;
  return 0;
}
