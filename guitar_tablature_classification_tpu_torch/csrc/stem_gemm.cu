// Stem-front GEMM with BatchNorm statistics in its epilogue, for Hopper
// (sm_90a), bound through ctypes.
//
// Replaces the JAX package's TPU kernel
//   guitar_tablature_classification_tpu/ops/stem_pallas.py::_gemm_stats_pallas
// ops/stem_tail.py::gemm_stats_plain is the plain PyTorch version.
//
// What it computes, for hq [M, K] bf16 and sq [K, N] bf16 (the 224^2 stem
// front's quadrant GEMM: M = B*112, K = 70, N = 7168):
//   y[m, n]    = bf16(sum_k hq[m, k] * sq[k, n])   fp32 products and sums
//   sums[0, n] = sum_m y[m, n],  sums[1, n] = sum_m y[m, n]^2
// in fp32, of the ROUNDED y (what the BatchNorm downstream reads).
//
// Bound.  At M = 28,672 and N = 7,168: 4.0 MB of hq, 1.0 MB of sq, 411 MB
// of y and 57 KB of sums: 0.124 ms of bytes at 3.35 TB/s.  28.8 GFLOP:
// 0.029 ms at the bf16 tensor-core peak.  So the kernel's job is to write y
// at the memory's rate with the products and the statistics out of the way.
//
// Design (replacing one CTA a 128 x 128 tile, 12,544 of them, each staging
// hq with 4-byte loads and its 20 KB sq tile, multiplying, rounding into a
// shared C tile and storing one phase after another, with one thread a
// column adding 128 rows serially into a 12.8 MB partial table; 0.41 ms):
// * Persistent CTAs.  A constant count (ops/stem_cuda.GEMM_CTAS, not read
//   from the card, so the sums' order is the same on every card) is cut by
//   ops/stem_cuda.gemm_plan: CTA (column tile ct, split s) -- block index
//   ct * splits + s -- owns the 128 columns of ct and the contiguous run of
//   row tiles [s * run, min(row tiles, (s + 1) * run)).  At the tool's
//   shape: 56 column tiles x 4 runs of 56 row tiles, two CTAs an SM.
// * sq once.  The CTA stages its column tile of sq once (zero past K and
//   N) and each warp keeps its B fragments (32 columns x K rounded up to
//   16: five k-steps at K = 70, 40 registers) for the whole run.
// * hq through a four-stage cp.async ring, as it lies in memory.  A
//   128-row tile of hq is one contiguous range of 256*K bytes (an hq row,
//   140 bytes, is not 16-byte aligned, but the tile is), fetched as 16-byte
//   copies (the last ones of a ragged tile zero-filled past M; the wrapper
//   checks that hq is 16-byte aligned).  Its rows are not 16-byte aligned,
//   so ldmatrix cannot take them, and repacking them (or copying them a
//   4-byte word at a time into padded rows) cost more time than the reads
//   it saved (PERF.md section 6): the A fragments are read as 4-byte words
//   straight from the tile (two 2-byte reads a word at odd K), zero past K.  A
//   fragment load's eight rows would share banks at a row stride of 35
//   words, so fragment row g of a 16-row step is tile row base + perm(g)
//   (perm(g) = 4g / 35 mod 32 at K = 70), row g + 8 the row after it:
//   their words then fall in distinct banks, and a warp's four steps still
//   cover its 64 rows once.  Each half of the CTA copies the 64 rows it
//   multiplies and waits only for them (a named barrier a half), so the
//   halves drift apart.
// * Tensor cores through mma.sync m16n8k16 (bf16 operands, fp32
//   accumulation; products of bf16 values are exact): 8 warps as 2 x 4, each
//   64 rows x 32 columns of a tile, in four 16-row steps.
// * y leaves through the tensor memory accelerator.  A warp rounds a step
//   to bf16 and writes it with stmatrix into its 2 KB staging block of 32
//   rows (two steps fill one, each row where its A row was), in the 64-byte
//   swizzle; a full block leaves as one box store of 32 x 32 (clipped at M
//   and N), so no warp waits on its stores, and the stores overlap the next
//   steps' copies and products.  Two blocks a warp; a block is rewritten
//   once its last store has read it.
// * Column sums.  Each thread adds its columns' rounded values and their
//   squares in registers across its whole run, in a fixed order (tile,
//   16-row step, fragment row g then g + 8); at the end a fixed shuffle
//   tree adds the eight lanes of a column, the two row halves add in order,
//   and the CTA writes one partial row [2, 128].  A second kernel adds each
//   column's rows in CTA order.  No atomics: two runs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_mma.cuh"

namespace {

constexpr int kThreads = 256;     // ops/stem_cuda.GEMM_THREADS
constexpr int kMinCtas = 2;       // CTAs an SM must hold: <= 128 registers
constexpr int kTile = 128;        // rows and columns of a y tile (ops/stem_cuda.GEMM_TILE)
constexpr int kMaxK = 128;        // ops/stem_cuda.GEMM_MAX_K
constexpr int kPadN = kTile + 8;  // sq staging row stride (bf16)
constexpr int kStages = 4;        // hq tiles in the ring (ops/stem_cuda.GEMM_STAGES)
constexpr int kWarps = kThreads / 32;
constexpr int kBlockBytes = 32 * 64;  // a y staging block: 32 rows of 32 bf16
constexpr int kCBufs = 2;             // staging blocks a warp
static_assert(kThreads == 2 * kTile, "the partial row is written a thread a value");

__host__ __device__ constexpr int padded_k(int K) { return (K + 15) / 16 * 16; }
// bytes of a ring slot: a 128-row tile of hq as it lies in memory, 256*K
// (a multiple of 16)
__host__ __device__ constexpr int slot_bytes(int K) { return 2 * kTile * K; }

// Dynamic shared bytes: the ring and the warps' y staging (after the ring,
// at a 1 KB boundary); sq's tile [KP][136] bf16 lies over slots 1.. and
// the staging before the walk, the column sums [2][2][128] fp32 over the
// staging after it.
__host__ __device__ constexpr long long staging_at(int K) {
  return ((long long)kStages * slot_bytes(K) + 1023) / 1024 * 1024;
}
long long gemm_smem_need(int K) { return staging_at(K) + (long long)kWarps * kCBufs * kBlockBytes; }

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(frame_mma::smem_addr(p)));
}

// Four 8x8 b16 matrices to shared memory: lane l gives the 16-byte row
// address of row l % 8 of matrix l / 8; matrix q comes from r[q] in the
// mma accumulator layout (lane 4g + t: row g, columns 2t, 2t+1).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3));
}

// The tensor-memory-accelerator store of a y staging block: the box of 32
// rows x 32 columns at (row, col) of y (clipped at M and N), from shared
// memory laid out with the 64-byte swizzle (16-byte chunk c of row r at c ^
// (r / 2 % 4)), and its bulk groups.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, uint32_t smem_src, int col,
                                              int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(smem_src)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // all but the newest N have read smem
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's generic shared-memory writes before the async
// proxy's reads (the tensor store's).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two bf16 of hq's tile at elements e and e + 1 (e even at even K: one
// 4-byte word), each zero where its column is K or more (lo_in, hi_in).
template <bool ODD>
__device__ __forceinline__ uint32_t a_pair(const unsigned char* flat, int e, bool lo_in,
                                           bool hi_in) {
  if (!ODD) return lo_in ? *reinterpret_cast<const uint32_t*>(flat + 2 * e) : 0u;
  const uint32_t lo = lo_in ? *reinterpret_cast<const uint16_t*>(flat + 2 * e) : 0u;
  const uint32_t hi = hi_in ? *reinterpret_cast<const uint16_t*>(flat + 2 * e + 2) : 0u;
  return lo | hi << 16;
}

// Where fragment row g of a 16-row step lies in the tile (see step 3 of
// the kernel): 4g / S mod 32 where a row's S = K/2 words are odd in number
// (even K), so that eight rows' words fall in distinct banks; else 4g.
template <bool ODD>
__device__ __forceinline__ int row_perm(int g, int K) {
  const int S = K / 2;
  if (ODD || !(S & 1)) return 4 * g;
  int inv = S;  // S^-1 mod 32 by Newton's iteration
#pragma unroll
  for (int it = 0; it < 4; ++it) inv *= 2 - S * inv;
  return (4 * g * inv) & 31;
}

// KS k-steps of 16 (K <= 16 * KS); ODD: K is odd.
template <int KS, bool ODD>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    gemm_stats_kernel(const __nv_bfloat16* __restrict__ hq,
                      const __nv_bfloat16* __restrict__ sq,
                      const __grid_constant__ CUtensorMap ymap, float* __restrict__ partial,
                      int M, int N, int K, int splits, int run) {
  constexpr int KP = 16 * KS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int sbytes = slot_bytes(K);
  auto slot = [&](int i) { return smem + (i % kStages) * sbytes; };
  unsigned char* staging = smem + staging_at(K);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(slot(1));  // [KP][kPadN], before the walk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // rows wm*64.., columns wn*32.. of a tile
  const int g = lane >> 2, t4 = lane & 3;
  const int ct = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = ct * kTile;
  const int rt0 = split * run;
  const int n_tiles = min((M + kTile - 1) / kTile, rt0 + run) - rt0;  // >= 1 by the plan

  // 1. row tile rt0 + i of hq -> ring slot i % kStages as it lies in
  //    memory (one contiguous range), 16-byte copies, zero past M.  Each
  //    half of the CTA (warps 4wm ..) copies the 64 rows it multiplies
  //    (128*K bytes, a multiple of 16) and waits only for them.
  const int half_bytes = 64 * K * 2;
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const long long m0 = (long long)(rt0 + i) * kTile;
      const int bytes = (int)(min((long long)kTile, M - m0) * K * 2);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(hq) + m0 * K * 2;
      unsigned char* dst = slot(i);
      for (int c = wm * half_bytes + (tid & 127) * 16; c < (wm + 1) * half_bytes; c += 128 * 16) {
        const int n = min(16, max(0, bytes - c));
        frame_mma::cp_async16_zfill(dst + c, n > 0 ? src + c : src, n);
      }
    }
    frame_mma::cp_async_commit();  // past the run an empty group keeps the count
  };
  issue(0);

  // 2. sq's columns n0 .. n0+127 (zero past K and N), then this warp's B
  //    fragments, held for the whole run
  for (int i = tid; i < KP * (kTile / 8); i += kThreads) {
    const int k = i / (kTile / 8), c = (i % (kTile / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K && n0 + c < N) v = *reinterpret_cast<const uint4*>(sq + (long long)k * N + n0 + c);
    *reinterpret_cast<uint4*>(Bs + k * kPadN + c) = v;
  }
  __syncthreads();
  uint32_t bf[KS][4][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldmatrix_x2_trans(bf[ks][j], Bs + (ks * 16 + (lane & 15)) * kPadN + wn * 32 + j * 8);
  __syncthreads();  // Bs is read no more: slots 1.. and the staging take its place
  for (int i = 1; i < kStages - 1; ++i) issue(i);

  // The A fragments come from the tile as it lies (an hq row is K values,
  // not 16-byte aligned: no ldmatrix), as 4-byte words.  Fragment row g of
  // 16-row step s of the warp's half is tile row R(s, g) = wm*64 + 32(s/2)
  // + 2(s%2) + perm(g), fragment row g + 8 the row after it; with S = K/2
  // words a row, S*perm(g) = 4g mod 32 where S is odd: the eight rows'
  // words fall in distinct banks.
  const int perm = row_perm<ODD>(g, K);
  // the last k-step's columns k0 + 2t4 (+1) and k0 + 8 + 2t4 (+1) past K
  // read as zero
  const int klast = 16 * (KS - 1) + 2 * t4;
  const bool in0 = klast < K, in1 = klast + 1 < K, in8 = klast + 8 < K, in9 = klast + 9 < K;

  float s1[4][2], s2[4][2];  // this thread's columns: sum y, sum y^2
#pragma unroll
  for (int j = 0; j < 4; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.0f;
  // the warp's staging blocks, and this lane's stmatrix rows: row l % 8 of
  // matrix (j, h) = (l / 16 + 2x, l / 8 % 2) is fragment row l % 8 + 8h,
  // block row perm(l % 8) + h (+ 2 at odd steps), at its 64-byte swizzled
  // chunk
  const uint32_t blocks = frame_mma::smem_addr(staging) + warp * kCBufs * kBlockBytes;
  const int st_perm = row_perm<ODD>(lane & 7, K) + ((lane >> 3) & 1);
  int n_blk = 0;  // the warp's staging blocks so far: buffer n_blk % kCBufs
  for (int i = 0; i < n_tiles; ++i) {
    frame_mma::cp_async_wait<kStages - 2>();
    // the half's rows of tile i have landed; its warps read tile i - 1's
    // slot no more (named barrier 1 + wm, 128 threads)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wm), "r"(128) : "memory");
    issue(i + kStages - 1);
    const unsigned char* flat = slot(i);
    const int row0 = (rt0 + i) * kTile + wm * 64;
#pragma unroll 1
    for (int sub = 0; sub < 4; ++sub) {
      // 3. the products of 16 rows x 32 columns
      const int r = wm * 64 + 32 * (sub >> 1) + 2 * (sub & 1) + perm;  // tile row of fragment row g
      const int e0 = r * K + 2 * t4;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bool last = ks == KS - 1;
        const bool b0 = !last || in0, b1 = !last || in1, b8 = !last || in8, b9 = !last || in9;
        // rows R and R + 1 at columns 16ks + 2t4 (a0, a1) and + 8 (a2, a3)
        uint32_t a[4];
        a[0] = a_pair<ODD>(flat, e0 + 16 * ks, b0, b1);
        a[1] = a_pair<ODD>(flat, e0 + K + 16 * ks, b0, b1);
        a[2] = a_pair<ODD>(flat, e0 + 16 * ks + 8, b8, b9);
        a[3] = a_pair<ODD>(flat, e0 + K + 16 * ks + 8, b8, b9);
#pragma unroll
        for (int j = 0; j < 4; ++j) frame_mma::mma_bf16(acc[j], a, bf[ks][j][0], bf[ks][j][1]);
      }
      // 4. round: accumulator 2h+e of n8 tile j is fragment row g + 8h,
      //    column 8j + 2*t4 + e; add the rounded values to the sums
      uint32_t w[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
          w[j][h] = *reinterpret_cast<const uint32_t*>(&v2);
          const float v0 = __uint_as_float(w[j][h] << 16);
          const float v1 = __uint_as_float(w[j][h] & 0xffff0000u);
          s1[j][0] += v0;
          s1[j][1] += v1;
          s2[j][0] += v0 * v0;
          s2[j][1] += v1 * v1;
        }
      // 5. stage the step's rows in the warp's block of 32 rows (steps
      //    2b and 2b + 1 fill block b); a full block leaves for y
      const uint32_t blk = blocks + (n_blk % kCBufs) * kBlockBytes;
      if ((sub & 1) == 0) {
        if (lane == 0) bulk_wait_read<kCBufs - 1>();  // the block's last store has read it
        __syncwarp();
      }
      const int brow = st_perm + 2 * (sub & 1);
#pragma unroll
      for (int x = 0; x < 2; ++x)
        stmatrix_x4(blk + brow * 64 + (((2 * x + (lane >> 4)) ^ ((brow >> 1) & 3)) << 4),
                    w[2 * x][0], w[2 * x][1], w[2 * x + 1][0], w[2 * x + 1][1]);
      if (sub & 1) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) tma_store_box(&ymap, blk, n0 + wn * 32, row0 + 32 * (sub >> 1));
        ++n_blk;
      }
    }
  }
  if (lane == 0) bulk_wait_all();

  // 6. the column sums: the eight lanes of a column (g) in a fixed tree,
  //    then the two row halves (wm) in order -> partial[block, 2, 128]
  __syncthreads();  // the staging is read no more (every store is done)
  float* red = reinterpret_cast<float*>(staging);  // [wm][stat][kTile]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = s1[j][e], b = s2[j][e];
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, x);
        b += __shfl_xor_sync(0xffffffffu, b, x);
      }
      if (g == 0) {
        const int col = wn * 32 + j * 8 + 2 * t4 + e;
        red[(wm * 2) * kTile + col] = a;
        red[(wm * 2 + 1) * kTile + col] = b;
      }
    }
  __syncthreads();
  const int stat = tid / kTile, col = tid % kTile;
  partial[((long long)blockIdx.x * 2 + stat) * kTile + col] =
      red[stat * kTile + col] + red[(2 + stat) * kTile + col];
}

// sums[s, n] = sum over the splits p of column tile n / 128, in order, of
// partial[ct * splits + p, s, n % 128].
__global__ void __launch_bounds__(kThreads)
    fold_rows_kernel(const float* __restrict__ partial, int splits, int N,
                     float* __restrict__ sums) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * N) return;
  const int s = i / N, n = i % N, ct = n / kTile, c = n % kTile;
  float acc = 0.0f;
  for (int p = 0; p < splits; ++p)
    acc += partial[((long long)(ct * splits + p) * 2 + s) * kTile + c];
  sums[i] = acc;
}

template <int KS>
const void* kernel_of(int K) {
  return K % 2 ? (const void*)gemm_stats_kernel<KS, true>
               : (const void*)gemm_stats_kernel<KS, false>;
}

// The kernel for K, or nullptr.
const void* kernel_for(int K) {
  switch (padded_k(K) / 16) {
    case 1: return kernel_of<1>(K);
    case 2: return kernel_of<2>(K);
    case 3: return kernel_of<3>(K);
    case 4: return kernel_of<4>(K);
    case 5: return kernel_of<5>(K);
    case 6: return kernel_of<6>(K);
    case 7: return kernel_of<7>(K);
    case 8: return kernel_of<8>(K);
  }
  return nullptr;
}

// Whether the plan's (splits, run, smem) fit the kernel at (M, K): every
// CTA has a row tile, every row tile a CTA, and smem covers what the kernel
// addresses.
bool plan_ok(int M, int K, int splits, int run, int smem) {
  const int row_tiles = (M + kTile - 1) / kTile;
  return splits >= 1 && run >= 1 && (long long)(splits - 1) * run < row_tiles &&
         (long long)splits * run >= row_tiles && smem >= gemm_smem_need(K) &&
         smem <= 232448;
}

// cuTensorMapEncodeTiled, found through the runtime (no link to the driver
// library), once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// y [M, N] bf16 as the tensor stores see it: boxes of 32 rows x 32
// columns, 64-byte swizzle, clipped at the edges.
bool y_map(CUtensorMap* map, void* y, int M, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {32, 32};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// hq [M, K] bf16, sq [K, N] bf16 -> y [M, N] bf16, sums [2, N] fp32;
// partial is scratch of ceil(N / 128) * splits * 2 * 128 floats.  splits,
// run and smem are the plan's (ops/stem_cuda.gemm_plan), checked here.
// Needs 1 <= K <= 128, N % 8 == 0, hq, sq and y 16-byte aligned.
extern "C" int gemm_stats_launch(const void* hq, const void* sq, void* y, void* partial,
                                 void* sums, int M, int N, int K, int splits, int run,
                                 int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const void* kernel = K >= 1 && K <= kMaxK ? kernel_for(K) : nullptr;
  if (M < 1 || N < 8 || N % 8 || kernel == nullptr || !plan_ok(M, K, splits, run, smem))
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)((N + kTile - 1) / kTile) * splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  alignas(64) CUtensorMap ymap;
  if (!y_map(&ymap, y, M, N)) return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  void* args[] = {(void*)&hq, (void*)&sq, (void*)&ymap, (void*)&part, (void*)&M,
                  (void*)&N, (void*)&K, (void*)&splits, (void*)&run};
  err = cudaLaunchKernel(kernel, dim3((unsigned)grid), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  fold_rows_kernel<<<(2 * N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, splits, N, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// The kernel as the card runs it for K and smem dynamic bytes: info =
// {registers a thread, local (spill) bytes a thread, shared bytes a CTA
// (static + dynamic), threads a CTA, resident CTAs per SM}.  Returns 0, or
// the cudaError_t of the failed query.
extern "C" int gemm_stats_kernel_info(int K, int smem, int* info) {
  const void* kernel = K >= 1 && K <= kMaxK ? kernel_for(K) : nullptr;
  if (kernel == nullptr || smem < gemm_smem_need(K) || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes + smem;
  info[3] = kThreads;
  info[4] = ctas;
  return 0;
}
