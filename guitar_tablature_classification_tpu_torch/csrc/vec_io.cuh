// Vector loads and stores of V consecutive values as fp32, and the BN affine
// + ReLU of the stem kernels.  Shared by csrc/stem.cu, csrc/stem_native.cu
// and csrc/bn.cu (ops/nvcc.py hashes this header into every build's name).
//
// Io<T>::load<V>(p, v) reads p[0..V) into fp32 v (bf16 -> fp32 is exact);
// Io<T>::store<V>(p, v) writes fp32 v rounded to T (round to nearest even).
// V is 2 or a multiple of 8 (bf16) / 4 (fp32); p is aligned to V elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vec_io {

template <typename T>
struct Io;

template <>
struct Io<float> {
  template <int V>
  static __device__ __forceinline__ void load(const float* p, float (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 q = reinterpret_cast<const float4*>(p)[k];
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
      }
    } else {
      static_assert(V == 2, "vector width");
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x;
      v[1] = q.y;
    }
  }
  template <int V>
  static __device__ __forceinline__ void store(float* p, const float (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        reinterpret_cast<float4*>(p)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      }
    } else {
      static_assert(V == 2, "vector width");
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
  }
};

template <>
struct Io<__nv_bfloat16> {
  template <int V>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[V]) {
    if constexpr (V % 8 == 0) {
#pragma unroll
      for (int k = 0; k < V / 8; ++k) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[k];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          v[8 * k + 2 * e] = f.x;
          v[8 * k + 2 * e + 1] = f.y;
        }
      }
    } else {
      static_assert(V == 2, "vector width");
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      v[0] = f.x;
      v[1] = f.y;
    }
  }
  template <int V>
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[V]) {
    if constexpr (V % 8 == 0) {
#pragma unroll
      for (int k = 0; k < V / 8; ++k) {
        uint4 q;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = __floats2bfloat162_rn(v[8 * k + 2 * e], v[8 * k + 2 * e + 1]);
        }
        reinterpret_cast<uint4*>(p)[k] = q;
      }
    } else {
      static_assert(V == 2, "vector width");
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }
};

// jnp.maximum / torch.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// max(y*se + oe, 0): a product, then a sum (no FMA contraction), as the
// plain versions compute it.
__device__ __forceinline__ float bn_relu(float y, float se, float oe) {
  return max_nan(__fadd_rn(__fmul_rn(y, se), oe), 0.0f);
}

enum Dtype { kFloat32 = 0, kBfloat16 = 1 };

}  // namespace vec_io
