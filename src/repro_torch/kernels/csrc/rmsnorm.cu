// RMSNorm for Hopper (sm_90a): out = (x * rsqrt(mean(x^2) + eps)) * w over
// the last dim of a row-major (rows, D) tensor, f32 math, output in x's type
// (f32, bf16 or f16: the 16-bit types share the pack path, 8 a pack).
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
// no block barrier).  Two kernels, chosen by the row width in the wrapper
// (`kernels/rmsnorm.py:one_read_packs`):
//   * one read (`rmsnorm_one_read_kernel`), for the dense configurations'
//     d_model (2048, 2560, 3072, 4096) on 16-byte aligned rows: each lane
//     loads its NP 16-byte packs of the row (lane + 32 p: neighbouring
//     lanes on neighbouring addresses, all loads in flight at once) into
//     registers, sums their squares, and scales the same registers, so the
//     row crosses the memory bus once.  D = 2560 bf16 is 10 packs a lane
//     (40 registers).  The packs are summed in the two-pass kernel's order,
//     so the two give the same bits.
//   * two passes (`rmsnorm_kernel`), every other width: the first pass sums
//     the squares, the second re-reads the row (from L1 when it is still
//     there) to scale it; 16 bytes a lane when D fills whole packs and the
//     rows are 16-byte aligned, element by element otherwise.
// At the decode shape (4 rows) one block of four warps runs on one SM in
// either kernel: a row is 2560 elements, too little to split further.  The
// TPU wrapper's padding of the rows to a block multiple is a TPU tiling
// matter and has no counterpart: the grid covers the rows exactly.

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

// One read of each row: NP 16-byte packs a lane, D = 32 * NP * V.
template <typename T, int NP>
__global__ void __launch_bounds__(32 * WARPS)
rmsnorm_one_read_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, long long rows, float eps) {
  constexpr int V = pack::Width<T>::N;
  constexpr int D = 32 * NP * V;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  uint4 raw[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) raw[p] = xr[lane + 32 * p];

  float ss = 0.0f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float f[V];
    pack::unpack16<T>(raw[p], f);
#pragma unroll
    for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)D + eps);

  T* orow = out + row * D;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c = (lane + 32 * p) * V;
    float f[V], g[V];
    pack::unpack16<T>(raw[p], f);
    pack::load16(w + c, g);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = (f[i] * r) * g[i];
    pack::store16(orow + c, f);
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

template <typename T, int NP>
int launch_one_read(const void* x, const void* w, void* out, long long rows,
                    int d, float eps, cudaStream_t stream) {
  if (d != 32 * NP * pack::Width<T>::N) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    rmsnorm_one_read_kernel<T, NP><<<(unsigned)blocks, 32 * WARPS, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)out, rows, eps);
  }
  return (int)cudaGetLastError();
}

// The one-read kernel's pack counts: d_model 2048, 2560, 3072 and 4096.
template <typename T>
int launch_packs(const void* x, const void* w, void* out, long long rows,
                 int d, float eps, int packs, cudaStream_t stream) {
  constexpr int S = sizeof(T) / 2;  // 1 for bf16 and f16, 2 for f32
  switch (packs) {
    case 8 * S: return launch_one_read<T, 8 * S>(x, w, out, rows, d, eps, stream);
    case 10 * S: return launch_one_read<T, 10 * S>(x, w, out, rows, d, eps, stream);
    case 12 * S: return launch_one_read<T, 12 * S>(x, w, out, rows, d, eps, stream);
    case 16 * S: return launch_one_read<T, 16 * S>(x, w, out, rows, d, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x, w and out share it).  packs: the
// one-read kernel's 16-byte packs a lane (d = 32 * packs * elements a pack),
// or 0 for the two-pass kernel.  vec (two-pass only): 1 when d is a multiple
// of the 16-byte pack and every row is 16-byte aligned.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int dtype,
                           long long rows, int d, float eps, int vec,
                           int packs, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return packs ? launch_packs<float>(x, w, out, rows, d, eps, packs, s)
                 : launch<float>(x, w, out, rows, d, eps, vec, s);
  }
  if (dtype == 1) {
    return packs
               ? launch_packs<__nv_bfloat16>(x, w, out, rows, d, eps, packs, s)
               : launch<__nv_bfloat16>(x, w, out, rows, d, eps, vec, s);
  }
  if (dtype == 2) {
    return packs ? launch_packs<__half>(x, w, out, rows, d, eps, packs, s)
                 : launch<__half>(x, w, out, rows, d, eps, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
