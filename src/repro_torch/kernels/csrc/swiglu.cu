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
