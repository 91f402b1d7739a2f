// Squared distances for the port's center kernels on Hopper (sm_90a):
// ||x||^2 + ||c||^2 - 2 x.c, included by dpmeans_assign.cu (which takes
// the tiling constants, `combine` and `lex_less` and writes the same tile
// loop out itself) and topk_stream.cu (which uses `tile_dots`).
//
// Exactness.  Every dot product, ||x||^2 and ||c||^2 is a chain of fmaf in
// ascending d starting from 0, the distance is combined with
// round-to-nearest intrinsics (no contraction) and clamped at 0, and an
// invalid slot is selected to inf by the caller, never computed to inf.
// So one (row, center) pair gets the same bits in every kernel that
// includes this header, whatever the tile, the block or the batch it is
// met in: the top-1 column of top-k equals the nearest-center kernel, and
// a hierarchical (multi-probe) top-k over every cell equals the flat one.
//
// Tiling.  A block of NT = 256 threads owns BM = 64 query rows and walks
// tiles of BK = 64 centers; each thread keeps a 4x4 register tile of dot
// products, so one pair of shared-memory loads feeds 16 FMAs.  x and
// center tiles are staged transposed through shared memory in chunks of DC
// values of D (any D works); x stays resident when D fits one chunk.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace sqdist {

constexpr int BM = 64;      // query rows per block
constexpr int BK = 64;      // centers per tile
constexpr int DC = 32;      // D chunk staged in shared memory
constexpr int TX = 16;      // threads along centers
constexpr int TY = 16;      // threads along rows
constexpr int RM = BM / TY; // rows per thread (4)
constexpr int RK = BK / TX; // centers per thread (4)
constexpr int NT = TX * TY; // 256 threads

// Transposed tiles, padded by one column against bank conflicts on the
// row-major global loads, and the squared norms of the tile's rows.
struct Tiles {
  float xs[DC][BM + 1];
  float cs[DC][BK + 1];
  float x2s[BM];
  float c2s[BK];
};

__device__ __forceinline__ float combine(float xx, float cc, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(xx, cc), __fmul_rn(2.f, dot)), 0.f);
}

// Strict lexicographic order on (distance, id).
__device__ __forceinline__ bool lex_less(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

// ||x||^2 of the block's BM rows into t.x2s (rows at or past n give 0).
// Read only after a __syncthreads().
__device__ __forceinline__ void x_norms(Tiles& t, const float* __restrict__ x,
                                        int row0, int n, int d) {
  const int tid = threadIdx.x;
  if (tid < BM) {
    float acc = 0.f;
    const int r = row0 + tid;
    if (r < n) {
      const float* xr = x + (size_t)r * d;
      for (int j = 0; j < d; ++j) acc = fmaf(xr[j], xr[j], acc);
    }
    t.x2s[tid] = acc;
  }
}

// One tile: acc[i][q] = x[row0 + ty + TY*i] . c[tx + TX*q] and
// t.c2s[j] = ||c[j]||^2, where `c` points at the tile's first center row
// (row stride d) and rows at or past `rows` read as 0.  x is staged when
// `stage_x` (always when D exceeds one chunk, else on the block's first
// tile).  Returns with the block synchronised and t.c2s written.
__device__ __forceinline__ void tile_dots(Tiles& t, const float* __restrict__ x,
                                          int row0, int n,
                                          const float* __restrict__ c, int rows,
                                          int d, bool stage_x,
                                          float (&acc)[RM][RK]) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;
  float c2 = 0.f;  // ||c||^2 of tile row tid, for tid < BK

  for (int d0 = 0; d0 < d; d0 += DC) {
    const int dw = min(DC, d - d0);
    __syncthreads();  // previous chunk (and tile) fully consumed
    if (stage_x) {
      for (int e = tid; e < BM * DC; e += NT) {
        const int r = e / DC, j = e % DC;
        const int gr = row0 + r;
        t.xs[j][r] = (gr < n && j < dw) ? x[(size_t)gr * d + d0 + j] : 0.f;
      }
    }
    for (int e = tid; e < BK * DC; e += NT) {
      const int r = e / DC, j = e % DC;
      t.cs[j][r] = (r < rows && j < dw) ? c[(size_t)r * d + d0 + j] : 0.f;
    }
    __syncthreads();
    if (tid < BK) {
      for (int j = 0; j < dw; ++j) c2 = fmaf(t.cs[j][tid], t.cs[j][tid], c2);
    }
    for (int j = 0; j < dw; ++j) {
      float a[RM], b[RK];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = t.xs[j][ty + TY * i];
#pragma unroll
      for (int q = 0; q < RK; ++q) b[q] = t.cs[j][tx + TX * q];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int q = 0; q < RK; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
    }
  }
  if (tid < BK) t.c2s[tid] = c2;
  __syncthreads();
}

}  // namespace sqdist
