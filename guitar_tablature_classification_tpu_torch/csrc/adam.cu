// The fused Adam / AdamW update for Hopper (sm_90a), bound through ctypes:
// one launch a train step over the flat fp32 buffers of train/engine.py's
// Optimizer (gradients g, parameters p, moments m and v).
//
// Replaces no TPU kernel: the JAX package leaves the update to optax, whose
// elementwise chain XLA fuses.  Eager PyTorch runs that chain as ~25
// kernels (Optimizer.apply_plain: the clip, the moments, the bias
// corrections, the root, the decay, the step, the skip's selects and
// copies), each reading and writing whole fp32 buffers.  This kernel reads
// g, p, m, v (and the backbone mask) once and writes p, m, v once.
//
// Bound: bytes at 3.35 TB/s.  28 bytes a parameter (4 reads, 3 writes of
// fp32), 29 with the backbone mask.  DeepSeek-V2-Lite's first stage,
// 2,422,007,154 parameters: 67.82 GB -> 20.24 ms.  About 40 fp32
// operations an element (4 correctly rounded divisions and a root among
// them) lie far below the FP32 rate, so the design only keeps bytes moving:
// * Persistent CTAs, kCtasPerSm a SM, walk the buffer grid-stride, each
//   thread with kUnroll 16-byte vectors of each buffer in flight (loads
//   first, then the arithmetic and the stores), streaming loads and stores
//   (each byte is touched once).  Indices are 64-bit: n passes 2^31.
// * The vector body starts at element `head`, where every buffer is 16-byte
//   aligned; the head and the ragged tail are single elements.  Buffers
//   whose alignments differ take the V = 1 instance (all single elements).
// * The scalars stay on the device: the global gradient norm, the two bias
//   corrections 1 - b^t and the step's `ok` are read once a CTA into
//   shared memory.  Where ok is false the CTA returns: p, m, v keep their
//   values.  Nothing is read back to the host.
// * The arithmetic is Optimizer.apply_plain's, operation for operation and
//   in its order, each rounding once to fp32 (__fmul_rn, __fadd_rn,
//   __fdiv_rn, __fsqrt_rn; -fmad=false besides), with the constants
//   rounded to fp32 as PyTorch rounds a Python scalar.  So on the card the
//   result is the chain's bit for bit (tests/test_torch_cuda.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // ops/adam_cuda.THREADS
constexpr int kCtasPerSm = 4;   // ops/adam_cuda.CTAS_PER_SM
constexpr int kUnroll = 2;      // ops/adam_cuda.UNROLL
constexpr int kNoDecay = 0, kCoupled = 1, kDecoupled = 2;  // ops/adam_cuda.DECAY

struct Params {
  const float* g;
  float* p;
  float* m;
  float* v;
  const unsigned char* mask;  // bool [n]: the backbone's elements
  const float* g_norm;        // nullptr: no clip
  const float* bias1;         // 1 - b1^t
  const float* bias2;         // 1 - b2^t
  const bool* ok;             // nullptr: always update
  long long n, head, nvec;
  float max_norm, one_minus_b1, b1, one_minus_b2, b2, eps, weight_decay,
      neg_lr, mask_scale;
};

struct Scalars {
  float g_norm, bias1, bias2;
  int clip, run;
};

// One element, in Optimizer.apply_plain's order:
//   u = g, or (g / |g|) * max where not |g| < max   (the clip's where)
//   u = u + wd * p                                   (adam's coupled decay)
//   m = (1 - b1) * u + b1 * m;  v = (1 - b2) * (u * u) + b2 * v
//   u = (m / bias1) / (sqrt(v / bias2) + eps)
//   u = u + wd * p                                   (adamw's decoupled decay)
//   u = (-lr) * u, then scale * u on the backbone;  p = p + u
template <int kDecay>
__device__ __forceinline__ void adam_element(const Params& a, const Scalars& s,
                                             float g, float& p, float& m,
                                             float& v, bool backbone) {
  float u = g;
  if (s.clip) u = __fmul_rn(__fdiv_rn(u, s.g_norm), a.max_norm);
  if (kDecay == kCoupled) u = __fadd_rn(u, __fmul_rn(p, a.weight_decay));
  m = __fadd_rn(__fmul_rn(u, a.one_minus_b1), __fmul_rn(m, a.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(u, u), a.one_minus_b2), __fmul_rn(v, a.b2));
  const float m_hat = __fdiv_rn(m, s.bias1);
  const float v_hat = __fdiv_rn(v, s.bias2);
  u = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), a.eps));
  if (kDecay == kDecoupled) u = __fadd_rn(u, __fmul_rn(p, a.weight_decay));
  u = __fmul_rn(u, a.neg_lr);
  if (backbone) u = __fmul_rn(u, a.mask_scale);
  p = __fadd_rn(p, u);
}

template <int V>
struct Vec;

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* q, float (&x)[4]) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(q));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* q, const float (&x)[4]) {
    __stcs(reinterpret_cast<float4*>(q), make_float4(x[0], x[1], x[2], x[3]));
  }
  static __device__ __forceinline__ void load_mask(const unsigned char* q,
                                                   bool (&x)[4]) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(q);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  }
};

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* q, float (&x)[1]) {
    x[0] = __ldcs(q);
  }
  static __device__ __forceinline__ void store(float* q, const float (&x)[1]) {
    __stcs(q, x[0]);
  }
  static __device__ __forceinline__ void load_mask(const unsigned char* q,
                                                   bool (&x)[1]) {
    x[0] = *q;
  }
};

template <int kDecay, bool kMask>
__device__ __forceinline__ void adam_single(const Params& a, const Scalars& s,
                                            long long e) {
  float p = a.p[e], m = a.m[e], v = a.v[e];
  adam_element<kDecay>(a, s, a.g[e], p, m, v, kMask && a.mask[e]);
  a.p[e] = p;
  a.m[e] = m;
  a.v[e] = v;
}

template <int kDecay, bool kMask, int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    adam_update_kernel(const Params a) {
  __shared__ Scalars shared;
  if (threadIdx.x == 0) {
    Scalars s;
    s.run = a.ok == nullptr || *a.ok;
    s.clip = a.g_norm != nullptr && !(*a.g_norm < a.max_norm);
    s.g_norm = s.clip ? *a.g_norm : 1.0f;
    s.bias1 = *a.bias1;
    s.bias2 = *a.bias2;
    shared = s;
  }
  __syncthreads();
  const Scalars s = shared;
  if (!s.run) return;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the body: vectors j of V elements from element head on
  for (long long i = first; i < a.nvec; i += kUnroll * stride) {
    float g[kUnroll][V], p[kUnroll][V], m[kUnroll][V], v[kUnroll][V];
    bool b[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < a.nvec) {
        const long long e = a.head + j * V;
        Vec<V>::load(a.g + e, g[u]);
        Vec<V>::load(a.p + e, p[u]);
        Vec<V>::load(a.m + e, m[u]);
        Vec<V>::load(a.v + e, v[u]);
        if constexpr (kMask) Vec<V>::load_mask(a.mask + e, b[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < a.nvec) {
        const long long e = a.head + j * V;
#pragma unroll
        for (int k = 0; k < V; ++k)
          adam_element<kDecay>(a, s, g[u][k], p[u][k], m[u][k], v[u][k],
                               kMask && b[u][k]);
        Vec<V>::store(a.p + e, p[u]);
        Vec<V>::store(a.m + e, m[u]);
        Vec<V>::store(a.v + e, v[u]);
      }
    }
  }
  // single elements: the head [0, head) and the tail [head + V * nvec, n)
  const long long tail = a.head + (long long)V * a.nvec;
  const long long singles = a.head + (a.n - tail);
  for (long long k = first; k < singles; k += stride)
    adam_single<kDecay, kMask>(a, s, k < a.head ? k : tail + (k - a.head));
}

template <int kDecay, bool kMask>
void launch(const Params& a, int vec, int ctas, cudaStream_t stream) {
  if (vec == 4)
    adam_update_kernel<kDecay, kMask, 4><<<ctas, kThreads, 0, stream>>>(a);
  else
    adam_update_kernel<kDecay, kMask, 1><<<ctas, kThreads, 0, stream>>>(a);
}

template <int kDecay>
void launch_decay(const Params& a, int vec, int ctas, cudaStream_t stream) {
  if (a.mask != nullptr)
    launch<kDecay, true>(a, vec, ctas, stream);
  else
    launch<kDecay, false>(a, vec, ctas, stream);
}

}  // namespace

// One Adam / AdamW step over n elements in place (ops/adam_cuda.update).
// Elements [head, head + vec * nvec) go as vectors of vec (4: every buffer
// 16-byte aligned at head; 1: head == 0, nvec == n); the rest singly.
// decay: 0 none, 1 adam's coupled, 2 adamw's decoupled.  mask, g_norm and
// ok may be null (no backbone scale, no clip, always update).
extern "C" int adam_update_launch(
    const void* g, void* p, void* m, void* v, const void* mask,
    const void* g_norm, const void* bias1, const void* bias2, const void* ok,
    long long n, long long head, long long nvec, int vec, int ctas, int decay,
    float max_norm, float one_minus_b1, float b1, float one_minus_b2, float b2,
    float eps, float weight_decay, float neg_lr, float mask_scale,
    void* stream_ptr) {
  if (n < 0 || head < 0 || nvec < 0 || ctas < 1 || (vec != 1 && vec != 4) ||
      head + (long long)vec * nvec > n || (vec == 1 && (head != 0 || nvec != n)) ||
      (vec == 4 && head > 3) || decay < kNoDecay || decay > kDecoupled ||
      bias1 == nullptr || bias2 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Params a;
  a.g = static_cast<const float*>(g);
  a.p = static_cast<float*>(p);
  a.m = static_cast<float*>(m);
  a.v = static_cast<float*>(v);
  a.mask = static_cast<const unsigned char*>(mask);
  a.g_norm = static_cast<const float*>(g_norm);
  a.bias1 = static_cast<const float*>(bias1);
  a.bias2 = static_cast<const float*>(bias2);
  a.ok = static_cast<const bool*>(ok);
  a.n = n;
  a.head = head;
  a.nvec = nvec;
  a.max_norm = max_norm;
  a.one_minus_b1 = one_minus_b1;
  a.b1 = b1;
  a.one_minus_b2 = one_minus_b2;
  a.b2 = b2;
  a.eps = eps;
  a.weight_decay = weight_decay;
  a.neg_lr = neg_lr;
  a.mask_scale = mask_scale;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (decay == kCoupled)
    launch_decay<kCoupled>(a, vec, ctas, stream);
  else if (decay == kDecoupled)
    launch_decay<kDecoupled>(a, vec, ctas, stream);
  else
    launch_decay<kNoDecay>(a, vec, ctas, stream);
  return (int)cudaGetLastError();
}
