// The nearest-center tile path for Hopper (sm_90a), shared by
// dpmeans_assign.cu (which instantiates it for f32, f16 and bf16 inputs)
// and topk_stream.cu (f32: its k = 1 bucket is this kernel, and its other
// buckets at D = 16 stream their tiles through `fast::sweep`).  Both form
// a pair's distance with this code, so top-1 == assign holds bit for bit
// by construction.
//
// The design (center range split over blocks, the 64-bit key merge, the
// cp.async ring at D = 16, the wide tile for D >= 64) is described in
// dpmeans_assign.cu.  Three kernels, chosen by width alone (the wrapper's
// `dpmeans_assign.block_k` mirrors it): `fast` at D = 16, `wide` at D >= 64
// with D a multiple of 8 (`wide::takes`: rows of every element type are
// then whole 16-byte pieces), `generic` at every other width (D = 8 of the
// examples and `serve_clusters`, odd widths), unchanged in code and bits.
//
// Storage types.  x and the centers are f32, f16 or bf16, one type per
// call.  Every value is widened to f32 where it is read into registers
// (the ring holds the raw elements; x is widened as it lands in shared
// memory), before any fmaf: widening is exact, so an f32 input gets the
// same bits as before the other types were added.  The ring keeps a row
// stride of DP = 20 elements for every type: 80 bytes for f32 (16-byte
// cp.async copies), 40 bytes for f16 / bf16 (8-byte copies, as many as for
// f32 but of half the bytes).  A lane reads 4 elements of a row at a time
// (16 or 8 bytes) from rows tx + 32 q; at either stride the 16 lanes of a
// shared-memory phase hit distinct banks, so the loads stay free of
// conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "sqdist.cuh"

// Everything here has internal linkage (an unnamed namespace): each
// library that includes the header owns its kernels and its per-device
// shared-memory settings, which template statics of external linkage would
// share across the libraries of one process.
namespace assign_tile {
namespace {

using sqdist::combine;
using sqdist::lex_less;

constexpr int BM = 64;    // query rows per block (both kernels)
constexpr int NT = 256;   // threads per block (both kernels)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements at p (aligned to four elements) as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void lex_min(float& d, int& i, float od, int oi) {
  if (lex_less(od, oi, d, i)) {
    d = od;
    i = oi;
  }
}

__device__ __forceinline__ int active_count(const int* count, int k) {
  int a = *count;
  a = a < k ? a : k;
  return a > 0 ? a : 0;
}

// The per-row minimum of this block is in rd/ri[0..BM).  With one split it
// is the answer.  Else each block folds it into the row's 64-bit key by
// atomicMin, key = bits(d2) << 32 | id: d2 is +0, positive or +inf (the
// clamp in `combine` never yields -0 or NaN), and the bits of such floats
// order as their values, so the keys order as (d2, id) lexicographically
// and the minimum does not depend on the order of the atomics.  The last
// block of the row block to take its ticket unpacks the keys, writes the
// output, and leaves the keys all ones and the ticket 0 for the next launch.
// Every thread of the block calls this; ROWS is the block's query rows (BM,
// or the wide kernel's 16), and the block has at least ROWS threads.
template <int ROWS = BM>
__device__ __forceinline__ void finish(const float* rd, const int* ri,
                                       int* s_last, float* __restrict__ d2_out,
                                       int* __restrict__ idx_out,
                                       unsigned long long* keys, int* tickets,
                                       int row0, int n) {
  const int tid = threadIdx.x;
  const int r = row0 + tid;
  const bool mine = tid < ROWS && r < n;
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

// ------------------------------------------------------------ fast, D = 16
namespace fast {

constexpr int D = 16;
constexpr int DP = 20;      // padded row stride in elements
constexpr int BK = 256;     // centers per tile
constexpr int HALF = BK / 2;
constexpr int NS = 3;       // stages of the ring
constexpr int RM = 8;       // rows per thread: the 8 rows of its warp
constexpr int RK = 4;       // centers per thread and half tile: tx + 32 q

template <typename T>
struct Smem {
  T cs[NS][BK * DP];        // center tiles, row-major, padded rows
  float xs[BM * DP];        // the block's rows, widened, padded
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

// Four elements of a center row: 16 bytes (f32, through L2 only) or 8.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
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
template <typename T>
__device__ __forceinline__ void load_tile(Smem<T>& s, int st, int t,
                                          const T* __restrict__ c,
                                          const uint8_t* __restrict__ mask,
                                          int active, bool aligned) {
  const int tid = threadIdx.x;
  const int k0 = t * BK;
  const int rows = min(BK, active - k0);
  for (int e = tid; e < rows * (D / 4); e += NT) {
    const int r = e / (D / 4), q = e % (D / 4);
    T* dst = &s.cs[st][r * DP + 4 * q];
    const T* src = c + (size_t)(k0 + r) * D + 4 * q;
    if (aligned) {
      cp_async4(dst, src);
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

// The tile loop of one split: x's rows widened into s.xs and their norms
// into s.x2s, then tiles split, split + S, ... below ceil(active / BK)
// through the ring; for each half tile that holds a center below the count
// (the same for the whole block), acc[i][q] = x[8 ty + i] . c[tx + 32 (q +
// 4 h)], and `pick.half(s, acc, k0, h)` selects from it.  Returns with the
// ring drained; the caller synchronises before reading another warp's rows.
template <typename T, class Pick>
__device__ __forceinline__ void sweep(Smem<T>& s, const T* __restrict__ x,
                                      const T* __restrict__ c,
                                      const uint8_t* __restrict__ mask,
                                      int n, int active, bool al, Pick& pick) {
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
      const T* src = x + (size_t)gr * D + 4 * q;
      v = make_float4(to_f(src[0]), to_f(src[1]), to_f(src[2]), to_f(src[3]));
    }
    *reinterpret_cast<float4*>(&s.xs[r * DP + 4 * q]) = v;
  }

  const int n_tiles = (active + BK - 1) / BK;
  const int mine = split < n_tiles ? (n_tiles - 1 - split) / n_split + 1 : 0;

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
      const T* cr = &s.cs[st][tid * DP];
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 v = load4(cr + 4 * q);
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
          b[q] = load4(&s.cs[st][(tx + 32 * (q + RK * h)) * DP + 4 * g]);
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
      pick.half(s, acc, k0, h);
    }
  }
  cp_async_wait<0>();
}

// Assign's selection: the running minimum of each of the thread's rows.
// Inside one thread the candidates come in ascending id (tiles ascending,
// q ascending), so a strict < keeps the lexicographic minimum.
struct MinPick {
  float bd[RM];
  int bi[RM];

  template <typename T>
  __device__ __forceinline__ void half(const Smem<T>& s,
                                       const float (&acc)[RM][RK], int k0,
                                       int h) {
    const int tx = threadIdx.x % 32;
    const int ty = threadIdx.x / 32;
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
};

// At most 128 registers a thread, so that two blocks share an SM.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
dpmeans_assign_fast_kernel(const T* __restrict__ x, const T* __restrict__ c,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ count, float* __restrict__ d2_out,
                   int* __restrict__ idx_out, unsigned long long* keys,
                   int* tickets, int n, int k, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  MinPick pick;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    pick.bd[i] = CUDART_INF_F;
    pick.bi[i] = INT32_MAX;
  }
  sweep(s, x, c, mask, n, active_count(count, k), aligned != 0, pick);

  // Reduce each row over the 32 lanes of its warp.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, pick.bd[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, pick.bi[i], off);
      lex_min(pick.bd[i], pick.bi[i], od, oi);
    }
    if (tx == 0) {
      s.rd[RM * ty + i] = pick.bd[i];
      s.ri[RM * ty + i] = pick.bi[i];
    }
  }
  __syncthreads();
  finish(s.rd, s.ri, &s.last, d2_out, idx_out, keys, tickets,
         blockIdx.x * BM, n);
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

template <typename T>
__global__ void __launch_bounds__(NT)
dpmeans_assign_generic_kernel(const T* __restrict__ x, const T* __restrict__ c,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ count,
                      float* __restrict__ d2_out, int* __restrict__ idx_out,
                      unsigned long long* keys, int* tickets, int n, int k,
                      int d) {
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
      const T* xr = x + (size_t)r * d;
      for (int j = 0; j < d; ++j) {
        const float v = to_f(xr[j]);
        acc = fmaf(v, v, acc);
      }
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
          xs[j][r] = (gr < n && j < dw) ? to_f(x[(size_t)gr * d + d0 + j])
                                        : 0.f;
        }
      }
      for (int e = tid; e < BK * DC; e += NT) {
        const int r = e / DC, j = e % DC;
        const int gk = k0 + r;
        cs[j][r] = (gk < k && j < dw) ? to_f(c[(size_t)gk * d + d0 + j]) : 0.f;
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

// ------------------------------------------------------------ wide D
// D >= 64, a multiple of 8 (curation's 2048).  What bounds it: 2 N count D
// FMAs against one read of x and the active centers; at (256, 512, 2048)
// f32 that is 0.54 GFLOP (8.0 us at the 67 TFLOP/s f32 rate) against 5.2
// MB (1.6 us).  Each pair's dot product is one dependent chain of D fmaf,
// so the shape offers only 131,072 chains, about 8 a lane of the card's
// 132 x 128 FP32 lanes: a lane's register tile can hold no more than 8
// pairs, and 8 pairs (4 rows x 2 centers) reuse each value loaded from
// shared memory 1.33 times, so shared-memory bandwidth, not the FMA rate,
// bounds the tile loop.  The design:
//  - Small tiles, so that such a shape fills the card: 16 query rows x 32
//    centers a block of 64 threads (two warps), each thread a 4 x 2
//    register tile; with the center range split a tile a block
//    (`dpmeans_assign.n_split`: about four blocks an SM), (256, 512, 2048)
//    runs 16 x 16 = 256 blocks on the 132 SMs.  Splits merge through the
//    64-bit keys and tickets as the other kernels' do (`finish<16>`).
//  - Rows staged in 256-byte chunks (64 f32 or 128 f16 / bf16 values of D)
//    through a 3-stage ring in shared memory filled by 16-byte cp.async
//    copies (plain loads where x or the centers do not start on 16 bytes:
//    the same bits); the 16 x rows and 32 center rows of a stage are
//    padded to 272 bytes.  A block's sequence of (tile, chunk) steps runs
//    through one ring, so the next tile's first chunks load while this
//    tile's last ones are consumed.  16-bit rows are widened on the way
//    from shared memory into registers.
//  - Vector shared loads feed the register tile: a warp's lanes are 4 row
//    groups x 8 center groups; lane (rg, cg) holds rows rg + 4 i (i < 4)
//    and centers 16 w + cg + 8 q (q < 2).  Per four values of D a lane
//    loads four x vectors (each broadcast to the 8 lanes of a row group)
//    and two center vectors, 6 loads for 32 FMAs; the 272-byte stride puts
//    the 4 or 8 rows of a load in distinct banks.
//  - ||x||^2 and ||c||^2 come from the staged chunks, no prologue: thread
//    tid < 32 chains ||c||^2 of the tile's center tid, threads 32-47 on the
//    split's first tile ||x||^2 of row tid - 32, one fmaf chain each beside
//    the dot products (threads 48-63 chain a copy, unused, so that every
//    lane runs the same code).
//  - The inner loop is straight-line code over a chunk (no branch between
//    its loads and FMAs).  A chunk past the end of a row (D not a multiple
//    of the chunk) is zero-filled by cp.async: a product of zeros adds
//    +0 to an fmaf chain, which leaves a non-zero sum as it is and turns a
//    -0 dot product into +0, and `combine` gives the same distance for
//    either zero, so the distances keep their bits.
// x is staged again for each of a split's tiles: 16 rows of D values
// cannot stay in shared memory beside the ring at D = 4096 (256 KB); a
// split that owns one tile (curation's shape) stages it once.
namespace wide {

constexpr int ROWS = 16;           // query rows per block
constexpr int BK = 32;             // centers per tile
constexpr int NT = 64;             // threads: two warps, side by side on K
constexpr int RM = 4;              // rows a thread: rg + 4 i
constexpr int RK = 2;              // centers a thread: 16 w + cg + 8 q
constexpr int CB = 256;            // bytes of a row a stage holds
constexpr int RB = CB + 16;        // padded row stride in bytes
constexpr int PR = CB / 16;        // 16-byte pieces of a row a stage
constexpr int NS = 3;              // stages of the ring
constexpr int SR = ROWS + BK;      // staged rows a stage: x, then centers

__host__ __device__ constexpr bool takes(int d) {
  return d >= 64 && d % 8 == 0;
}

struct Smem {
  alignas(16) unsigned char ring[NS][SR][RB];
  float x2s[ROWS];
  float c2s[BK];
  float rd[2][ROWS];
  int ri[2][ROWS];
  int last;
};

// Start the copies of chunk `ch` of center tile `t` (its rows below
// `active`) and of the block's x rows (below n) into stage `st`, pieces
// past the end of a row as zeros; rows past those are left as they are
// (their products are never selected).  Thread tid copies piece tid % PR
// of rows tid / PR + 4 m.
template <typename T>
__device__ __forceinline__ void load_stage(Smem& s, int st, int t, int ch,
                                           const T* __restrict__ x,
                                           const T* __restrict__ c, int row0,
                                           int n, int active, int d,
                                           bool aligned) {
  constexpr int E = 16 / (int)sizeof(T);          // elements a piece
  const int q = threadIdx.x % PR;
  const int e = ch * (CB / (int)sizeof(T)) + q * E;   // its first element
  const bool have = e < d;       // d a multiple of 8: whole pieces
  const int k0 = t * BK;
#pragma unroll
  for (int r = threadIdx.x / PR; r < SR; r += NT / PR) {
    const T* row;
    if (r < ROWS) {
      if (row0 + r >= n) continue;
      row = x + (size_t)(row0 + r) * d;
    } else {
      if (k0 + r - ROWS >= active) continue;
      row = c + (size_t)(k0 + r - ROWS) * d;
    }
    unsigned char* dst = &s.ring[st][r][q * 16];
    if (aligned) {
      const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                   "l"(have ? row + e : row), "r"(have ? 16 : 0));
    } else {
      T* out = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int i = 0; i < E; ++i) out[i] = have ? row[e + i] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
dpmeans_assign_wide_kernel(const T* __restrict__ x, const T* __restrict__ c,
                           const uint8_t* __restrict__ mask,
                           const int* __restrict__ count,
                           float* __restrict__ d2_out,
                           int* __restrict__ idx_out,
                           unsigned long long* keys, int* tickets, int n,
                           int k, int d, int aligned) {
  constexpr int VS = 4 * (int)sizeof(T);            // bytes of 4 values
  constexpr int STEPS = CB / VS;                    // 4-value steps a chunk
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int rg = lane >> 3;
  const int cg = lane & 7;
  const int row0 = blockIdx.x * ROWS;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const bool al = aligned != 0;

  const int active = active_count(count, k);
  const int n_tiles = (active + BK - 1) / BK;
  const int mine = split < n_tiles ? (n_tiles - 1 - split) / n_split + 1 : 0;
  const int chunks = (d * (int)sizeof(T) + CB - 1) / CB;
  const int steps = mine * chunks;
  // the staged row this thread's norm chain reads: center tid, x row
  // tid - 32 (threads 48-63: a copy of 32-47's)
  const int norm_row = tid < BK ? ROWS + tid : (tid - BK) % ROWS;

  float bd[RM];
  int bi[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = INT32_MAX;
  }

#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < steps)
      load_stage(s, p, split + (p / chunks) * n_split, p % chunks, x, c, row0,
                 n, active, d, al);
    fast::cp_async_commit();
  }

  float acc[RM][RK];
  float nacc = 0.f;
  int j = 0, ch = 0;     // this step's tile (of the split) and chunk
  for (int it = 0; it < steps; ++it) {
    fast::cp_async_wait<NS - 2>();   // this thread's copies of step it
    __syncthreads();                 // everyone's; stage (it - 1) % NS free
    {
      const int nx = it + NS - 1;
      if (nx < steps)
        load_stage(s, nx % NS, split + (nx / chunks) * n_split, nx % chunks,
                   x, c, row0, n, active, d, al);
      fast::cp_async_commit();
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int q = 0; q < RK; ++q) acc[i][q] = 0.f;
      nacc = 0.f;
    }
    const int st = it % NS;
    const unsigned char* xr = &s.ring[st][rg][0];
    const unsigned char* cr = &s.ring[st][ROWS + 16 * w + cg][0];
    const unsigned char* nr = &s.ring[st][norm_row][0];
#pragma unroll
    for (int g = 0; g < STEPS; ++g) {
      float4 a[RM], b[RK];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = load4(reinterpret_cast<const T*>(xr + 4 * i * RB + g * VS));
#pragma unroll
      for (int q = 0; q < RK; ++q)
        b[q] = load4(reinterpret_cast<const T*>(cr + 8 * q * RB + g * VS));
      const float4 v = load4(reinterpret_cast<const T*>(nr + g * VS));
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int q = 0; q < RK; ++q) {
          acc[i][q] = fmaf(a[i].x, b[q].x, acc[i][q]);
          acc[i][q] = fmaf(a[i].y, b[q].y, acc[i][q]);
          acc[i][q] = fmaf(a[i].z, b[q].z, acc[i][q]);
          acc[i][q] = fmaf(a[i].w, b[q].w, acc[i][q]);
        }
      nacc = fmaf(v.x, v.x, nacc);
      nacc = fmaf(v.y, v.y, nacc);
      nacc = fmaf(v.z, v.z, nacc);
      nacc = fmaf(v.w, v.w, nacc);
    }
    if (++ch == chunks) {
      // The tile's last chunk: share the norms, then select.
      if (tid < BK) s.c2s[tid] = nacc;
      else if (tid < BK + ROWS && j == 0) s.x2s[tid - BK] = nacc;
      __syncthreads();
      const int k0 = (split + j * n_split) * BK;
#pragma unroll
      for (int q = 0; q < RK; ++q) {
        const int kc = 16 * w + cg + 8 * q;
        const int gk = k0 + kc;
        const bool valid = gk < active && mask[gk] != 0;
        const float cc = s.c2s[kc];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float v = combine(s.x2s[rg + 4 * i], cc, acc[i][q]);
          lex_min(bd[i], bi[i], valid ? v : CUDART_INF_F,
                  valid ? gk : INT32_MAX);
        }
      }
      ch = 0;
      ++j;
    }
  }
  fast::cp_async_wait<0>();

  // Each row over the 8 lanes of its row group, then over the two warps.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      lex_min(bd[i], bi[i], od, oi);
    }
    if (cg == 0) {
      s.rd[w][rg + 4 * i] = bd[i];
      s.ri[w][rg + 4 * i] = bi[i];
    }
  }
  __syncthreads();
  if (tid < ROWS) lex_min(s.rd[0][tid], s.ri[0][tid], s.rd[1][tid],
                          s.ri[1][tid]);
  finish<ROWS>(s.rd[0], s.ri[0], &s.last, d2_out, idx_out, keys, tickets,
               row0, n);
}

}  // namespace wide

// Set a kernel's dynamic shared-memory limit once per device (a benign race
// between host threads sets it twice).
template <auto Kernel>
__host__ int smem_attr(int bytes) {
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !configured[dev]) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) configured[dev] = true;
  }
  return 0;
}

// One nearest-center launch on inputs of element type T.  With n_split > 1,
// keys holds at least n 64-bit keys that are all ones and tickets at least
// ceil(n/16) ints that are 0; each launch leaves them so again.  D = 16
// takes the fast kernel, tiles of 256 centers on 64 rows; D >= 64 and a
// multiple of 8 the wide one, tiles of 32 on 16 rows (unless `generic`, a
// hook that holds the generic kernel against it); other widths the generic
// one, tiles of 64 on 64 rows.  Returns a CUDA error code (0 on success).
template <typename T>
int launch(const T* x, const T* centers, const uint8_t* mask,
           const int* count, float* d2_out, int* idx_out,
           unsigned long long* keys, int* tickets, int n, int k, int d,
           int n_split, cudaStream_t st, bool generic = false) {
  if (n <= 0) return 0;
  if (wide::takes(d) && !generic) {
    const dim3 grid((n + wide::ROWS - 1) / wide::ROWS, n_split);
    const int aligned = ((reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(centers)) % 16) == 0;
    wide::dpmeans_assign_wide_kernel<T><<<grid, wide::NT, 0, st>>>(
        x, centers, mask, count, d2_out, idx_out, keys, tickets, n, k, d,
        aligned);
    return (int)cudaGetLastError();
  }
  const dim3 grid((n + BM - 1) / BM, n_split);
  if (d == fast::D) {
    constexpr int smem = (int)sizeof(fast::Smem<T>);
    const int e = smem_attr<fast::dpmeans_assign_fast_kernel<T>>(smem);
    if (e != 0) return e;
    const int aligned = ((reinterpret_cast<uintptr_t>(centers) |
                          reinterpret_cast<uintptr_t>(mask)) % 16) == 0;
    fast::dpmeans_assign_fast_kernel<T><<<grid, NT, smem, st>>>(
        x, centers, mask, count, d2_out, idx_out, keys, tickets, n, k,
        aligned);
  } else {
    generic::dpmeans_assign_generic_kernel<T><<<grid, NT, 0, st>>>(
        x, centers, mask, count, d2_out, idx_out, keys, tickets, n, k, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace assign_tile
