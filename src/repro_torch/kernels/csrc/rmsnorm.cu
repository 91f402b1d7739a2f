// RMSNorm for Hopper (sm_90a): out = (x * rsqrt(mean(x^2) + eps)) * w over
// the last dim of a row-major (rows, D) tensor, f32 math, output in x's type.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` / `rmsnorm` of
// src/repro/kernels/rmsnorm.py (2 launches per transformer block and one
// for the final norm on the language model's prefill and decode paths).
//
// What bounds it.  Per call it must read x (rows*D) and w (D) once and write
// rows*D, and it does about 4 operations per element: far fewer than the
// H100's f32 rate per byte of device memory, so the memory rate (3.35 TB/s)
// bounds it.  At the prefill shape (16384, 2560) in bf16 that is 168 MB, or
// 0.050 ms.  At the decode shape (4 rows) the launch itself dominates.
//
// What the design does about it.  One warp per row, four rows per block:
// the sum of squares is reduced with warp shuffles alone (no shared memory,
// no block barrier).  Loads and stores are 16 bytes a lane, neighbouring
// lanes on neighbouring addresses, when D fills whole 16-byte packs and the
// rows are 16-byte aligned (the wrapper checks); otherwise element by
// element.  The second pass re-reads the row, which the first pass left in
// L1.  The TPU wrapper's padding of the rows to a block multiple is a TPU
// tiling matter and has no counterpart: the grid covers the rows exactly.

#include "pack.cuh"

namespace {

constexpr int WARPS = 4;  // rows per block

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, long long rows, int d, float eps,
               int vec) {
  constexpr int V = pack::Width<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.0f;
  if (vec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float f[V];
      pack::load16(xr + c, f);
#pragma unroll
      for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = pack::to_f(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  if (vec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float f[V], g[V];
      pack::load16(xr + c, f);
      pack::load16(w + c, g);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = (f[i] * r) * g[i];
      pack::store16(orow + c, f);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      orow[c] = pack::from_f<T>((pack::to_f(xr[c]) * r) * pack::to_f(w[c]));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, long long rows, int d,
           float eps, int vec, cudaStream_t stream) {
  if (rows > 0) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    rmsnorm_kernel<T><<<(unsigned)blocks, 32 * WARPS, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)out, rows, d, eps, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and out share it).  vec: 1 when d is a
// multiple of the 16-byte pack and every row is 16-byte aligned.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int dtype,
                           long long rows, int d, float eps, int vec,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, out, rows, d, eps, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, rows, d, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}
