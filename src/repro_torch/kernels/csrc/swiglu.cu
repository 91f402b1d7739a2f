// SwiGLU activation for Hopper (sm_90a): out = silu(g) * u = g / (1 +
// exp(-g)) * u elementwise, f32 math, output in g's type.
//
// Replaces the Pallas TPU kernel `_swiglu_kernel` / `swiglu` of
// src/repro/kernels/swiglu.py (one launch per transformer block on the
// language model's prefill and decode paths).
//
// What bounds it.  Per call it must read g and u once and write one output
// of the same size, with a handful of operations per element: the memory
// rate (3.35 TB/s) bounds it.  At the prefill shape (16384, 9728) in bf16
// that is 956 MB, or 0.285 ms.  At the decode shape (4 rows) the launch
// dominates.
//
// What the design does about it.  A grid-stride loop over 16-byte packs
// (8 bf16 or 4 f32 a thread and access, neighbouring threads on
// neighbouring addresses), so each byte is read once and written once and
// the silu(g) intermediate never reaches device memory, as on the TPU.  The
// exponential is the accurate `expf`, not `__expf`: the comparison with the
// plain version assumes it.  A tail shorter than a pack, or unaligned
// pointers (the wrapper checks), go element by element.

// The backward (`swiglu_bwd`, new with the training path; the Pallas kernel
// has no VJP, so the JAX package differentiates its plain version).  With
// s = sigmoid(g) = 1 / (1 + exp(-g)) and the output gradient dy:
//   du = dy (g s),   dg = dy u (s (1 + g (1 - s))).
// What bounds it: it must read g, u and dy and write dg and du, five
// tensors of the same size, with about a dozen operations an element: the
// memory rate.  At granite-3-2b's training shape (16384, 8192) in bf16 that
// is 1.34 GB, or 0.401 ms.  The design is the forward's: one pass over
// 16-byte packs, f32 math, nothing but the two outputs written.

#include "pack.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

template <typename T>
__global__ void __launch_bounds__(NT)
swiglu_kernel(const T* __restrict__ g, const T* __restrict__ u,
              T* __restrict__ out, long long n, int vec) {
  constexpr int V = pack::Width<T>::N;
  const long long stride = (long long)gridDim.x * NT;
  const long long i0 = (long long)blockIdx.x * NT + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = i0; i < nv; i += stride) {
      float a[V], b[V];
      pack::load16(g + i * V, a);
      pack::load16(u + i * V, b);
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] = silu_mul(a[j], b[j]);
      pack::store16(out + i * V, a);
    }
    done = nv * V;
  }
  for (long long i = done + i0; i < n; i += stride)
    out[i] = pack::from_f<T>(silu_mul(pack::to_f(g[i]), pack::to_f(u[i])));
}

template <typename T>
int launch(const void* g, const void* u, void* out, long long n, int vec,
           cudaStream_t stream) {
  if (n > 0) {
    constexpr int V = pack::Width<T>::N;
    const long long work = vec ? (n + V - 1) / V : n;
    long long blocks = (work + NT - 1) / NT;
    if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then stride
    swiglu_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
        (const T*)g, (const T*)u, (T*)out, n, vec);
  }
  return (int)cudaGetLastError();
}


__device__ __forceinline__ void silu_mul_bwd(float g, float u, float dy,
                                             float& dg, float& du) {
  const float s = 1.0f / (1.0f + expf(-g));
  du = dy * (g * s);
  dg = (dy * u) * (s * (1.0f + g * (1.0f - s)));
}

template <typename T>
__global__ void __launch_bounds__(NT)
swiglu_bwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                  const T* __restrict__ dy, T* __restrict__ dg,
                  T* __restrict__ du, long long n, int vec) {
  constexpr int V = pack::Width<T>::N;
  const long long stride = (long long)gridDim.x * NT;
  const long long i0 = (long long)blockIdx.x * NT + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = i0; i < nv; i += stride) {
      float a[V], b[V], c[V], e[V], f[V];
      pack::load16(g + i * V, a);
      pack::load16(u + i * V, b);
      pack::load16(dy + i * V, c);
#pragma unroll
      for (int j = 0; j < V; ++j) silu_mul_bwd(a[j], b[j], c[j], e[j], f[j]);
      pack::store16(dg + i * V, e);
      pack::store16(du + i * V, f);
    }
    done = nv * V;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float e, f;
    silu_mul_bwd(pack::to_f(g[i]), pack::to_f(u[i]), pack::to_f(dy[i]), e, f);
    dg[i] = pack::from_f<T>(e);
    du[i] = pack::from_f<T>(f);
  }
}

template <typename T>
int launch_bwd(const void* g, const void* u, const void* dy, void* dg,
               void* du, long long n, int vec, cudaStream_t stream) {
  if (n > 0) {
    constexpr int V = pack::Width<T>::N;
    const long long work = vec ? (n + V - 1) / V : n;
    long long blocks = (work + NT - 1) / NT;
    if (blocks > 132 * 32) blocks = 132 * 32;
    swiglu_bwd_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
        (const T*)g, (const T*)u, (const T*)dy, (T*)dg, (T*)du, n, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (g, u and out share it).  vec: 1 when all
// three pointers are 16-byte aligned.
extern "C" int swiglu_fwd(const void* g, const void* u, void* out, int dtype,
                          long long n, int vec, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(g, u, out, n, vec, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, u, out, n, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dg and du from g, u and dy of one type (0 float32, 1
// bfloat16).  vec: 1 when all five pointers are 16-byte aligned.
extern "C" int swiglu_bwd(const void* g, const void* u, const void* dy,
                          void* dg, void* du, int dtype, long long n, int vec,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd<float>(g, u, dy, dg, du, n, vec, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, u, dy, dg, du, n, vec, s);
  return (int)cudaErrorInvalidValue;
}
