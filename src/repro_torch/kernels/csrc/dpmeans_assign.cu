// Nearest-center assignment for Hopper (sm_90a): masked min of the squared
// distance ||x||^2 + ||c||^2 - 2 x.c and its argmin over a count-bounded
// active prefix of the center pool.
//
// Replaces the Pallas TPU kernel `_assign_kernel` / `dpmeans_assign` of
// src/repro/kernels/dpmeans_assign.py (the OCC propose primitive behind
// core/occ.py:nearest_center, the serving plane's score query and the
// routing of serving/snapshot.py:build_hier).
//
// What bounds it.  Per call it must read x (N*D), the active centers
// (count*D) and the mask once and write 2*N words, while it does 2*N*count*D
// operations.  At the paper's D=16 the arithmetic intensity is about N/2
// operations per byte of centers, so at N >= a few hundred the f32 FMA rate
// (67 TFLOP/s outside the tensor cores, NVIDIA's H100 SXM data sheet), not
// device memory, is the bound; at a 64-row score request it is 3.4 us of
// FMAs over 110k centers.  The parity tier is full f32, so the tensor cores
// (TF32 or bf16) are not used.
//
// What the design does about it.
//  - The center range is split over blocks: the grid is (row blocks, S)
//    and split s walks center tiles s, s + S, s + 2S, ... below
//    ceil(count/BK), with the count read from device memory (no host sync;
//    the TPU kernel's `pl.when` skip and clamped index map become this loop
//    bound).  S comes from the shapes alone (`dpmeans_assign.n_split`:
//    about two blocks an SM, at most one split per two tiles of K), so a
//    64-row score request runs on every SM instead of one.  Each block
//    folds its (d2, id) of a row into the row's 64-bit key by atomicMin;
//    the last block of a row block to finish (a ticket counter) unpacks
//    the keys and resets keys and ticket for the next launch.  With S = 1
//    the block writes the output itself: no keys, no ticket.
//  - At D = 16 (the paper's and the retrieval index's width) the fast
//    kernel takes tiles of BK = 256 centers through a 3-stage ring in
//    shared memory filled by 16-byte cp.async copies of only the D columns
//    that exist, the tile's mask staged beside it, so the next tiles' loads
//    overlap this tile's FMAs.  ||c||^2 is computed once per center.  Each
//    thread owns 8 rows of its warp x 8 centers (tx + 32q) of a tile, as
//    two 8 x 4 register tiles of dot products, one per half tile, fed by
//    float4 shared loads: 12 loads per 128 FMAs.  Rows are padded to 20
//    floats so that those loads are free of bank conflicts.  A block-uniform
//    test skips the upper half of a tile that lies past the count.
//  - Other widths take the generic kernel: 64 x 64 tiles staged through
//    shared memory in chunks of 32 values of D, a 4 x 4 register tile,
//    with the same split and merge.
//
// Exactness.  Every dot product, ||x||^2 and ||c||^2 is a chain of fmaf in
// ascending d starting from 0, as in the top-k kernels' `sqdist.cuh`; the
// distance is that header's `combine` (round-to-nearest intrinsics, no
// contraction, clamped at 0), so a (row, center) pair gets the same bits
// here as in `topk_stream`.  Each row keeps the lexicographic minimum of
// (d2, id) among valid centers, starting from (inf, INT32_MAX); NaN is
// never selected; a row with no valid center returns (inf, -1).  The
// lexicographic minimum is associative and commutative, so it does not
// depend on which thread, tile, split or merge step met a candidate first:
// a row's result depends only on that row and the centers -- not on N, its
// position in the batch, the grid or S -- and ties go to the lowest index,
// as the TPU kernel's in-tile argmin plus strict-< running merge does.
// Inside one thread of the fast kernel the candidates come in ascending id
// (tiles ascending, q ascending), so a strict < there is that same minimum.

#include "sqdist.cuh"

namespace {

using sqdist::combine;
using sqdist::lex_less;

constexpr int BM = 64;    // query rows per block (both kernels)
constexpr int NT = 256;   // threads per block (both kernels)

__device__ __forceinline__ void lex_min(float& d, int& i, float od, int oi) {
  if (lex_less(od, oi, d, i)) {
    d = od;
    i = oi;
  }
}

// The per-row minimum of this block is in rd/ri[0..BM).  With one split it
// is the answer.  Else each block folds it into the row's 64-bit key by
// atomicMin, key = bits(d2) << 32 | id: d2 is +0, positive or +inf (the
// clamp in `combine` never yields -0 or NaN), and the bits of such floats
// order as their values, so the keys order as (d2, id) lexicographically
// and the minimum does not depend on the order of the atomics.  The last
// block of the row block to take its ticket unpacks the keys, writes the
// output, and leaves the keys all ones and the ticket 0 for the next launch.
// Every thread of the block calls this.
__device__ __forceinline__ void finish(const float* rd, const int* ri,
                                       int* s_last, float* __restrict__ d2_out,
                                       int* __restrict__ idx_out,
                                       unsigned long long* keys, int* tickets,
                                       int row0, int n) {
  const int tid = threadIdx.x;
  const int r = row0 + tid;
  const bool mine = tid < BM && r < n;
  if (gridDim.y == 1) {
    if (mine) {
      d2_out[r] = rd[tid];
      idx_out[r] = rd[tid] < CUDART_INF_F ? ri[tid] : -1;
    }
    return;
  }
  if (mine)
    atomicMin(keys + r, ((unsigned long long)__float_as_uint(rd[tid]) << 32) |
                            (unsigned)ri[tid]);
  __threadfence();  // the keys are folded before the ticket is taken
  __syncthreads();
  if (tid == 0)
    *s_last = atomicAdd(&tickets[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (mine) {
    const unsigned long long key = __ldcg(keys + r);
    const float d = __uint_as_float((unsigned)(key >> 32));
    d2_out[r] = d;
    idx_out[r] = d < CUDART_INF_F ? (int)(unsigned)key : -1;
    keys[r] = ~0ull;
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

__device__ __forceinline__ int active_count(const int* count, int k) {
  int a = *count;
  a = a < k ? a : k;
  return a > 0 ? a : 0;
}

// ------------------------------------------------------------ fast, D = 16
namespace fast {

constexpr int D = 16;
constexpr int DP = 20;      // padded row stride in floats: 5 x 16 bytes
constexpr int BK = 256;     // centers per tile
constexpr int HALF = BK / 2;
constexpr int NS = 3;       // stages of the ring
constexpr int RM = 8;       // rows per thread: the 8 rows of its warp
constexpr int RK = 4;       // centers per thread and half tile: tx + 32 q

struct Smem {
  float cs[NS][BK * DP];    // center tiles, row-major, padded rows
  float xs[BM * DP];        // the block's rows, row-major, padded
  float x2s[BM];
  float c2s[BK];            // ||c||^2 of the tile being consumed
  uint8_t ms[NS][BK];       // staged mask bytes of each stage's tile
  uint8_t ok[BK];           // valid: below the count and in the mask
  float rd[BM];
  int ri[BM];
  int last;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of center tile `t` (its rows below `active`) and of its
// mask bytes into stage `st`.  `aligned`: centers and mask start on 16
// bytes, so cp.async can copy them; else plain loads do (same bits).
__device__ __forceinline__ void load_tile(Smem& s, int st, int t,
                                          const float* __restrict__ c,
                                          const uint8_t* __restrict__ mask,
                                          int active, bool aligned) {
  const int tid = threadIdx.x;
  const int k0 = t * BK;
  const int rows = min(BK, active - k0);
  for (int e = tid; e < rows * (D / 4); e += NT) {
    const int r = e / (D / 4), q = e % (D / 4);
    float* dst = &s.cs[st][r * DP + 4 * q];
    const float* src = c + (size_t)(k0 + r) * D + 4 * q;
    if (aligned) {
      cp_async16_cg(dst, src);
    } else {
      dst[0] = src[0];
      dst[1] = src[1];
      dst[2] = src[2];
      dst[3] = src[3];
    }
  }
  if (aligned) {
    if (tid < BK / 16 && 16 * tid < rows)
      cp_async16(&s.ms[st][16 * tid], mask + k0 + 16 * tid,
                 min(16, rows - 16 * tid));
  } else if (tid < rows) {
    s.ms[st][tid] = mask[k0 + tid];
  }
}

// At most 128 registers a thread, so that two blocks share an SM.
__global__ void __launch_bounds__(NT, 2)
dpmeans_assign_fast_kernel(const float* __restrict__ x,
                           const float* __restrict__ c,
                           const uint8_t* __restrict__ mask,
                           const int* __restrict__ count,
                           float* __restrict__ d2_out,
                           int* __restrict__ idx_out,
                           unsigned long long* keys, int* tickets, int n,
                           int k, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 32;   // lane: centers tx + 32 q
  const int ty = tid / 32;   // warp: rows 8 ty .. 8 ty + 7
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;

  // The block's rows, zero past n (plain loads: x is read once a block).
  {
    const int r = tid / (D / 4), q = tid % (D / 4);
    const int gr = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n) {
      const float* src = x + (size_t)gr * D + 4 * q;
      v = make_float4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<float4*>(&s.xs[r * DP + 4 * q]) = v;
  }

  const int active = active_count(count, k);
  const int n_tiles = (active + BK - 1) / BK;
  const int mine = split < n_tiles ? (n_tiles - 1 - split) / n_split + 1 : 0;
  const bool al = aligned != 0;

#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < mine) load_tile(s, p, split + p * n_split, c, mask, active, al);
    cp_async_commit();
  }
  __syncthreads();  // xs written
  if (tid < BM) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j)
      a = fmaf(s.xs[tid * DP + j], s.xs[tid * DP + j], a);
    s.x2s[tid] = a;
  }

  float bd[RM];
  int bi[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = INT32_MAX;
  }

  for (int it = 0; it < mine; ++it) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile `it` landed
    __syncthreads();          // everyone's; stage (it - 1) % NS is free
    if (it + NS - 1 < mine)
      load_tile(s, (it + NS - 1) % NS, split + (it + NS - 1) * n_split, c,
                mask, active, al);
    cp_async_commit();
    const int st = it % NS;
    const int k0 = (split + it * n_split) * BK;
    {
      const float4* cr = reinterpret_cast<const float4*>(&s.cs[st][tid * DP]);
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 v = cr[q];
        a = fmaf(v.x, v.x, a);
        a = fmaf(v.y, v.y, a);
        a = fmaf(v.z, v.z, a);
        a = fmaf(v.w, v.w, a);
      }
      s.c2s[tid] = a;
      s.ok[tid] = (k0 + tid < active && s.ms[st][tid] != 0) ? 1 : 0;
    }
    __syncthreads();

    // The tile's two halves of 128 centers, one after the other (q = 0..3
    // of a half is center tx + 32 (q + 4h)); the upper half only where it
    // holds a center below the count (the same for the whole block).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && k0 + HALF >= active) break;
      float acc[RM][RK];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int q = 0; q < RK; ++q) acc[i][q] = 0.f;
      // Not unrolled: unrolled in full, ptxas hoists every x load of the
      // tile ahead of the FMAs and spills at the 128 registers that two
      // blocks an SM leave a thread (unrolled by two it ran no faster).
#pragma unroll 1
      for (int g = 0; g < D / 4; ++g) {
        float4 b[RK];
#pragma unroll
        for (int q = 0; q < RK; ++q)
          b[q] = *reinterpret_cast<const float4*>(
              &s.cs[st][(tx + 32 * (q + RK * h)) * DP + 4 * g]);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              &s.xs[(RM * ty + i) * DP + 4 * g]);
#pragma unroll
          for (int q = 0; q < RK; ++q) {
            acc[i][q] = fmaf(a.x, b[q].x, acc[i][q]);
            acc[i][q] = fmaf(a.y, b[q].y, acc[i][q]);
            acc[i][q] = fmaf(a.z, b[q].z, acc[i][q]);
            acc[i][q] = fmaf(a.w, b[q].w, acc[i][q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RK; ++q) {
        const int kc = tx + 32 * (q + RK * h);
        const float cc = s.c2s[kc];
        const bool ok = s.ok[kc] != 0;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float v = combine(s.x2s[RM * ty + i], cc, acc[i][q]);
          if (ok && v < bd[i]) {
            bd[i] = v;
            bi[i] = k0 + kc;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Reduce each row over the 32 lanes of its warp.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      lex_min(bd[i], bi[i], od, oi);
    }
    if (tx == 0) {
      s.rd[RM * ty + i] = bd[i];
      s.ri[RM * ty + i] = bi[i];
    }
  }
  __syncthreads();
  finish(s.rd, s.ri, &s.last, d2_out, idx_out, keys, tickets, row0, n);
}

}  // namespace fast

// ------------------------------------------------------------ generic D
namespace generic {

constexpr int BK = 64;     // centers per tile
constexpr int DC = 32;     // D chunk staged in shared memory
constexpr int TX = 16;     // threads along centers
constexpr int TY = 16;     // threads along rows
constexpr int RM = BM / TY;
constexpr int RK = BK / TX;

__global__ void __launch_bounds__(NT)
dpmeans_assign_generic_kernel(const float* __restrict__ x,
                              const float* __restrict__ c,
                              const uint8_t* __restrict__ mask,
                              const int* __restrict__ count,
                              float* __restrict__ d2_out,
                              int* __restrict__ idx_out,
                              unsigned long long* keys, int* tickets, int n,
                              int k, int d) {
  // Transposed tiles, padded by one column against bank conflicts on the
  // row-major global loads.
  __shared__ float xs[DC][BM + 1];
  __shared__ float cs[DC][BK + 1];
  __shared__ float x2s[BM];
  __shared__ float c2s[BK];
  __shared__ float rd[BM];
  __shared__ int ri[BM];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int n_split = gridDim.y;

  const int active = active_count(count, k);
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

  bool first = true;
  for (int t = blockIdx.y; t < n_tiles; t += n_split) {
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
      if (!x_resident || first) {
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
    first = false;
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
        const float v = combine(x2s[ty + TY * i], cc, acc[i][q]);
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
    if (tx == 0) {
      rd[ty + TY * i] = best_d[i];
      ri[ty + TY * i] = best_i[i];
    }
  }
  __syncthreads();
  finish(rd, ri, &last, d2_out, idx_out, keys, tickets, row0, n);
}

}  // namespace generic

}  // namespace

// Returns a CUDA error code (0 on success).  With n_split > 1, keys holds
// at least n 64-bit keys that are all ones and tickets at least ceil(n/64)
// ints that are 0; each launch leaves them so again.  D = 16 takes the fast
// kernel, tiles of 256 centers; other widths the generic one, tiles of 64
// (`dpmeans_assign.block_k` says the same).
extern "C" int dpmeans_assign_f32(const float* x, const float* centers,
                                  const uint8_t* mask, const int* count,
                                  float* d2_out, int* idx_out,
                                  unsigned long long* keys, int* tickets,
                                  int n, int k, int d, int n_split,
                                  void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + BM - 1) / BM, n_split);
  if (d == fast::D) {
    static bool configured[64] = {};  // per device
    constexpr int smem = (int)sizeof(fast::Smem);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !configured[dev]) {
      e = cudaFuncSetAttribute(fast::dpmeans_assign_fast_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) configured[dev] = true;
    }
    const int aligned = ((reinterpret_cast<uintptr_t>(centers) |
                          reinterpret_cast<uintptr_t>(mask)) % 16) == 0;
    fast::dpmeans_assign_fast_kernel<<<grid, NT, smem, st>>>(
        x, centers, mask, count, d2_out, idx_out, keys, tickets, n, k,
        aligned);
  } else {
    generic::dpmeans_assign_generic_kernel<<<grid, NT, 0, st>>>(
        x, centers, mask, count, d2_out, idx_out, keys, tickets, n, k, d);
  }
  return (int)cudaGetLastError();
}
