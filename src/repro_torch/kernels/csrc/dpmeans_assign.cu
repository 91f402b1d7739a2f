// Nearest-center assignment for Hopper (sm_90a): masked min of the squared
// distance ||x||^2 + ||c||^2 - 2 x.c and its argmin over a count-bounded
// active prefix of the center pool.
//
// Replaces the Pallas TPU kernel `_assign_kernel` / `dpmeans_assign` of
// src/repro/kernels/dpmeans_assign.py (the OCC propose primitive behind
// core/occ.py:nearest_center).
//
// What bounds it.  Per call it must read x (N*D), the active centers
// (count*D) and the mask once and write 2*N words, while it does 2*N*count*D
// operations.  At the paper's D=16 the arithmetic intensity is about N/2
// operations per byte of centers, so at N >= a few hundred the f32 FMA rate
// (67 TFLOP/s outside the tensor cores, NVIDIA's H100 SXM data sheet), not
// device memory, is the bound.  The parity tier is full f32, so the tensor
// cores (TF32 or bf16) are not used.
//
// What the design does about it.  Each thread keeps a 4x4 register tile of
// f32 dot products, so one pair of shared-memory loads feeds 16 FMAs; x and
// center tiles are staged through shared memory in chunks of D (any D works)
// and x stays resident when D fits one chunk.  The pool count is read from
// device memory and bounds the center-tile loop at ceil(count/BK) tiles, so
// the work and the traffic track the occupied prefix, not the capacity, and
// no host sync is needed (the TPU kernel's `pl.when` skip and clamped index
// map become this early loop exit).  Not yet done: splitting the center
// loop over blocks when N is small (N=256 fills only 4 of 132 SMs), and
// wgmma/TMA for a lower-precision tier.
//
// Exactness.  Every dot product, ||x||^2 and ||c||^2 is a chain of fmaf in
// ascending d, as in the top-k kernels' `sqdist.cuh` (whose tile size this
// kernel shares); the distance is combined by that header's `combine`
// (round-to-nearest intrinsics, no contraction), and each row keeps the
// lexicographic minimum of (d2, index) starting from (inf, -1).  That
// minimum does not depend on the order in which candidates are met, so a
// row's result depends only on that row and the centers: not on N, on its
// position in the batch, or on the grid.
// Ties go to the lowest index, as the TPU kernel's in-tile argmin plus
// strict-< running merge does.  A row with no valid center returns (inf, -1).
//
// The tile loop is written out here rather than taken from the header's
// `tile_dots`: on the H100, with `tile_dots`, ptxas gave this kernel 48
// registers and spills and it ran 36% slower at the retrieval shape.

#include "sqdist.cuh"

namespace {

using sqdist::BK;
using sqdist::BM;
using sqdist::DC;
using sqdist::NT;
using sqdist::RK;
using sqdist::RM;
using sqdist::TX;
using sqdist::TY;

__device__ __forceinline__ void lex_min(float& d, int& i, float od, int oi) {
  if (sqdist::lex_less(od, oi, d, i)) {
    d = od;
    i = oi;
  }
}

__global__ void __launch_bounds__(NT)
dpmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ count, float* __restrict__ d2_out,
                      int* __restrict__ idx_out, int n, int k, int d) {
  // Transposed tiles, padded by one column against bank conflicts on the
  // row-major global loads.
  __shared__ float xs[DC][BM + 1];
  __shared__ float cs[DC][BK + 1];
  __shared__ float x2s[BM];
  __shared__ float c2s[BK];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;

  int active = *count;
  active = active < k ? active : k;
  active = active > 0 ? active : 0;
  const int n_tiles = (active + BK - 1) / BK;
  const bool x_resident = d <= DC;

  // ||x||^2 per row, fmaf in ascending d.
  if (tid < BM) {
    float acc = 0.f;
    const int r = row0 + tid;
    if (r < n) {
      const float* xr = x + (size_t)r * d;
      for (int j = 0; j < d; ++j) acc = fmaf(xr[j], xr[j], acc);
    }
    x2s[tid] = acc;
  }

  float best_d[RM];
  int best_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    best_d[i] = CUDART_INF_F;
    best_i[i] = INT32_MAX;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float acc[RM][RK];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;
    float c2 = 0.f;  // ||c||^2 of center k0 + tid, for tid < BK

    for (int d0 = 0; d0 < d; d0 += DC) {
      const int dw = min(DC, d - d0);
      __syncthreads();  // previous chunk fully consumed
      if (!x_resident || t == 0) {
        for (int e = tid; e < BM * DC; e += NT) {
          const int r = e / DC, j = e % DC;
          const int gr = row0 + r;
          xs[j][r] = (gr < n && j < dw) ? x[(size_t)gr * d + d0 + j] : 0.f;
        }
      }
      for (int e = tid; e < BK * DC; e += NT) {
        const int r = e / DC, j = e % DC;
        const int gk = k0 + r;
        cs[j][r] = (gk < k && j < dw) ? c[(size_t)gk * d + d0 + j] : 0.f;
      }
      __syncthreads();
      if (tid < BK) {
        for (int j = 0; j < dw; ++j) c2 = fmaf(cs[j][tid], cs[j][tid], c2);
      }
      for (int j = 0; j < dw; ++j) {
        float a[RM], b[RK];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xs[j][ty + TY * i];
#pragma unroll
        for (int q = 0; q < RK; ++q) b[q] = cs[j][tx + TX * q];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int q = 0; q < RK; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
      }
    }
    if (tid < BK) c2s[tid] = c2;
    __syncthreads();

#pragma unroll
    for (int q = 0; q < RK; ++q) {
      const int kc = tx + TX * q;
      const int gk = k0 + kc;
      const bool valid = gk < active && mask[gk] != 0;
      const float cc = c2s[kc];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xx = x2s[ty + TY * i];
        const float v = sqdist::combine(xx, cc, acc[i][q]);
        lex_min(best_d[i], best_i[i], valid ? v : CUDART_INF_F,
                valid ? gk : INT32_MAX);
      }
    }
  }

  // Reduce each row over the 16 threads of its half-warp.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      lex_min(best_d[i], best_i[i], od, oi);
    }
    const int r = row0 + ty + TY * i;
    if (tx == 0 && r < n) {
      const bool found = best_d[i] < CUDART_INF_F;
      d2_out[r] = best_d[i];
      idx_out[r] = found ? best_i[i] : -1;
    }
  }
}

}  // namespace

extern "C" int dpmeans_assign_f32(const float* x, const float* centers,
                                  const uint8_t* mask, const int* count,
                                  float* d2_out, int* idx_out, int n, int k,
                                  int d, void* stream) {
  if (n > 0) {
    const dim3 grid((n + BM - 1) / BM);
    dpmeans_assign_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        x, centers, mask, count, d2_out, idx_out, n, k, d);
  }
  return (int)cudaGetLastError();
}
