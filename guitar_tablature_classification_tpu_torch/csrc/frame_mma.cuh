// The bf16 tensor-core core of the CQT frame GEMM, shared by csrc/cqt.cu
// (the fused CQT, B1) at the `default` tier and csrc/cqt_frame_gemm.cu (the
// raw frame GEMM, B9) at every tier (there on bf16 pieces of the operands);
// csrc/conv3x3.cu (B10) uses its ldmatrix, mma and cp.async helpers.  Both
// CQT kernels run the `highest` and `bf16x3` tiers on bf16 pieces of both
// operands (prod_a, prod_b below).  At the `default` tier:
//   out[(b, t), n] = sum_k bf16(padded[b, t*hop + k]) * bf16(K[k, n])
// with the products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 accumulators): the products of bf16 operands are exact and the sums
// are taken in fp32, as the plain version's fp32 matmul of the rounded
// operands does.
//
// Implicit im2col: row (b, t) of the A operand is read from the audio
// itself; the [B, T, Kw] frame stack is never written to device memory.
// Each fp32 sample is rounded to bf16 (nearest even) once: on its way into
// shared memory, or into a bf16 copy of the audio (B9's ring kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace frame_mma {

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// np.pad(mode='reflect') index of position i (may lie far outside [0, n)).
__device__ __forceinline__ int reflect_idx(int i, int n) {
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the 16-byte row address of row l % 8
// of matrix l / 8 (a 32-bit shared-memory address, or a pointer).
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_at(r, smem_addr(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b, m16n8k16, bf16 operands, fp32 accumulators.  Fragments (g =
// lane / 4, c = lane % 4): a = {(g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..),
// (g+8, 2c+8..)} as [row, k]; b = {(2c..2c+1, g), (2c+8.., g)} as [k, n];
// d = {(g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)} as [row, n].  In each
// 32-bit register the lower half holds the smaller k.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared (L2 only), and its groups.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gsrc));
}
// The same copy reading `bytes` (0 to 16) from gsrc and zero-filling the
// rest: bytes = 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gsrc, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gsrc), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The split tiers' products of bf16 pieces (hi = piece 0, then 1, 2; the
// value is the pieces' exact sum): parts = 3 (highest) takes the six whose
// weight is at least 2^-16 of hi*hi, parts = 2 (bf16x3) hi*hi + hi*lo +
// lo*hi, parts = 1 (default) hi*hi.  The q-th product (A piece, B piece),
// smallest weight first (ops/cqt_cuda.FRAME_GEMM_PRODUCTS).
__host__ __device__ constexpr int prod_a(int parts, int q) {
  return parts == 3 ? (q == 0 ? 1 : q == 1 ? 2 : q == 3 ? 1 : 0) : (parts == 2 && q == 0 ? 1 : 0);
}
__host__ __device__ constexpr int prod_b(int parts, int q) {
  return parts == 3 ? (q == 0 ? 1 : q == 2 ? 2 : q == 4 ? 1 : 0) : (parts == 2 && q == 1 ? 1 : 0);
}
__host__ __device__ constexpr int n_products(int parts) { return parts == 3 ? 6 : parts == 2 ? 3 : 1; }

// The next bf16 piece of v (nearest even), as bits; v keeps the rest, exactly.
__device__ __forceinline__ unsigned short take_piece(float& v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  v -= __bfloat162float(h);
  return __bfloat16_as_ushort(h);
}

// Row and k offset of the address lane l gives ldmatrix_x4 for one A
// fragment: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7,
// k 8-15), (rows 8-15, k 8-15), which land in a[0..3] in mma_bf16's order.
__device__ __forceinline__ int ldm_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int ldm_k(int lane) { return (lane >> 4) * 8; }

}  // namespace frame_mma
