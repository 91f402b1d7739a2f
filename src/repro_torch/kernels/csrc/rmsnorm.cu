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
//     d_model (1024, 2048, 2560, 3072, 3584, 4096) on 16-byte aligned rows: each lane
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

// The backward (`rmsnorm_bwd`, new with the training path; the Pallas kernel
// has no VJP, so the JAX package differentiates its plain version).  Given
// the output gradient dy, with r = rsqrt(mean(x^2) + eps):
//   dx = r (w dy) - x r^3 sum(w dy x) / d,   dw = sum over rows of dy (x r).
// What bounds it: it must read x, dy (rows*D each) and w, and write dx and
// dw, with about 12 operations an element: the memory rate bounds it.  At
// granite-3-2b's training shape (16384, 2048) in bf16 that is 201 MB, or
// 0.060 ms; at zamba2-7b's (16384, 3584) 0.105 ms.  dw is a sum over every
// row and must be deterministic (training resumes bit for bit), so no
// float atomics: each block owns a fixed set of rows and writes one f32
// partial row, and `rmsnorm_dw_kernel` sums the partials in block order.
// Two kernels, chosen by the wrapper (`kernels/rmsnorm.py:
// bwd_one_read_threads`):
//   * one read (`rmsnorm_bwd_one_read_kernel`), for the dense widths
//     (`ONE_READ_WIDTHS`, 1024-4096) on 16-byte aligned rows.  A block of
//     d / 8 threads takes one row at a time; thread t owns the eight
//     columns of its 16-byte packs t + (d / 8) p, fixed for the whole
//     launch.  Rows come in through a ring in shared memory filled by
//     16-byte cp.async copies: each thread copies and reads back only its
//     own packs, so the ring needs no barrier.  A block keeps about 16 KB
//     of later rows in flight (two rows at bf16 d 2048, one at wider rows
//     and in f32: twice that ran slower).  The row's x and dy packs stay
//     in registers from the sums to the dx store, so device memory sees
//     each once; w is read once a block.  (ss, sum w dy x) is reduced by
//     warp shuffles and one exchange of the warps' sums through shared
//     memory, summed in warp order: the order depends on d alone, so a
//     row's dx does not depend on the batch, the grid or the row's
//     position.  Each thread accumulates its columns' dw over its block's
//     rows in row order in f32 registers (no shared-memory read-modify-
//     write, no per-warp rows of shared memory).  The grid is a constant,
//     `BWD_ONE_READ_BLOCKS` = 264 blocks (fewer only for fewer rows);
//     block b takes rows b, b + 264, ..., so the rows in flight lie side by
//     side in memory.  Two blocks fit an SM at every dense width (at most
//     512 threads of 64 registers and 64 KB of ring), so on an H100 the
//     whole grid is resident at once and no second wave runs on an idle
//     card.  The partials are 264 x d f32 (3.8 MB at d 3584), read from L2
//     by `rmsnorm_dw_kernel`.
//   * two sweeps (`rmsnorm_bwd_kernel`, the first design), every other
//     width and unaligned rows: one warp a row, a first sweep over the row
//     sums x^2 and (w dy) x, a second re-reads the row (from L1 or L2) and
//     writes dx; each warp accumulates its rows' dy (x r) into its own f32
//     row of shared memory (a lane owns its columns), and the block sums
//     its warps in order into its partial row.  The grid is a function of
//     (rows, D) alone (`kernels/rmsnorm.py:bwd_blocks`).
// Either way two calls give the same bits.

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

// The one-read kernel's pack counts: d_model 1024, 2048, 2560, 3072, 3584
// and 4096.
template <typename T>
int launch_packs(const void* x, const void* w, void* out, long long rows,
                 int d, float eps, int packs, cudaStream_t stream) {
  constexpr int S = sizeof(T) / 2;  // 1 for bf16 and f16, 2 for f32
  switch (packs) {
    case 4 * S: return launch_one_read<T, 4 * S>(x, w, out, rows, d, eps, stream);
    case 8 * S: return launch_one_read<T, 8 * S>(x, w, out, rows, d, eps, stream);
    case 10 * S: return launch_one_read<T, 10 * S>(x, w, out, rows, d, eps, stream);
    case 12 * S: return launch_one_read<T, 12 * S>(x, w, out, rows, d, eps, stream);
    case 14 * S: return launch_one_read<T, 14 * S>(x, w, out, rows, d, eps, stream);
    case 16 * S: return launch_one_read<T, 16 * S>(x, w, out, rows, d, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------- backward

// dx for every row of the block's range, and the block's dw partial: the
// sum over those rows of dy (x r), into partial[blockIdx.x * d ...].
// Dynamic shared memory: one f32 row per warp, of width d rounded up to
// 32 packs.
template <typename T>
__global__ void __launch_bounds__(128)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d,
                   float eps, int vec, long long rows_per_block) {
  extern __shared__ float acc[];
  constexpr int V = pack::Width<T>::N;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // each warp's row of shared memory: d floats, rounded up to whole
  // groups of 32 packs in the vec sweep (whose slots are permuted)
  const int ld = vec ? (d + 32 * V - 1) / (32 * V) * (32 * V) : d;
  for (int c = threadIdx.x; c < warps * ld; c += blockDim.x) acc[c] = 0.0f;
  __syncthreads();
  float* mine = acc + (size_t)warp * ld;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  long long r1 = r0 + rows_per_block;
  if (r1 > rows) r1 = rows;
  for (long long row = r0 + warp; row < r1; row += warps) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    T* orow = dx + row * d;
    float ss = 0.0f, dot = 0.0f;
    if (vec) {
#pragma unroll 4
      for (int c = lane * V; c < d; c += 32 * V) {
        float a[V], g[V], h[V];
        pack::load16(xr + c, a);
        pack::load16(gr + c, g);
        pack::load16(w + c, h);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ss = fmaf(a[i], a[i], ss);
          dot = fmaf(g[i] * h[i], a[i], dot);
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float a = pack::to_f(xr[c]);
        ss = fmaf(a, a, ss);
        dot = fmaf(pack::to_f(gr[c]) * pack::to_f(w[c]), a, dot);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float c3 = (r * r * r) * (dot / (float)d);
    if (vec) {
      for (int c = lane * V; c < d; c += 32 * V) {
        float a[V], g[V], h[V], o[V];
        pack::load16(xr + c, a);
        pack::load16(gr + c, g);
        pack::load16(w + c, h);
        // column c + i at slot (c - lane V) + 32 i + lane: the warp's
        // lanes touch 32 consecutive floats (no bank conflict)
        float* acc_c = mine + (c - lane * V) + lane;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          o[i] = (g[i] * h[i]) * r - a[i] * c3;
          acc_c[i * 32] += g[i] * (a[i] * r);
        }
        pack::store16(orow + c, o);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float a = pack::to_f(xr[c]);
        const float g = pack::to_f(gr[c]);
        orow[c] = pack::from_f<T>((g * pack::to_f(w[c])) * r - a * c3);
        mine[c] += g * (a * r);
      }
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    // the vec sweep's slot of column c (the scalar sweep's is c)
    const int q = c % (32 * V);
    const int slot = vec ? (c - q) + (q % V) * 32 + q / V : c;
    float s = 0.0f;
    for (int k = 0; k < warps; ++k) s += acc[(size_t)k * ld + slot];
    out[c] = s;
  }
}

// dw[c] = the sum of partial[b * d + c] over the blocks b in order: 32
// columns a block, 8 warps each summing every 8th block's partials in
// order, then warp 0 summing the 8 sums in order.
constexpr int RED_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(32 * RED_WARPS)
rmsnorm_dw_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                  int blocks, int d) {
  __shared__ float part[RED_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < d) {
    // eight loads in flight, then their sums in block order
    int b = warp;
    for (; b + 7 * RED_WARPS < blocks; b += 8 * RED_WARPS) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = partial[(size_t)(b + j * RED_WARPS) * d + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    for (; b < blocks; b += RED_WARPS) s += partial[(size_t)b * d + c];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < RED_WARPS; ++k) t += part[k][lane];
    dw[c] = pack::from_f<T>(t);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* partial, long long rows, int d, float eps,
               int vec, int warps, int blocks, cudaStream_t stream) {
  if (rows <= 0 || blocks <= 0 || warps < 1 || warps > 4)
    return (int)cudaErrorInvalidValue;
  constexpr int G = 32 * pack::Width<T>::N;
  const size_t ld = vec ? (size_t)(d + G - 1) / G * G : (size_t)d;
  const size_t smem = (size_t)warps * ld * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_kernel<T><<<blocks, 32 * warps, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)dy, (T*)dx, partial, rows, d, eps,
      vec, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dw_kernel<T><<<(d + 31) / 32, 32 * RED_WARPS, 0, stream>>>(
      partial, (T*)dw, blocks, d);
  return (int)cudaGetLastError();
}

// One read a row: a block of nt = d / 8 threads, thread t owning columns
// (t + nt p) V .. + V - 1 of its P packs (P = 1 pack of 8 in bf16 / f16,
// 2 of 4 in f32).  Block b of B takes rows b, b + B, b + 2B, ... one at a
// time, so the rows in flight across the grid lie side by side in memory.
// Dynamic shared memory: the ring, S stages x 2 (x, dy) x P x nt packs.
// partial[blockIdx.x * d ...]: the block's dw partial.
constexpr int BWD_COLS = 8;        // columns a thread owns
constexpr int BWD_MAX_THREADS = 512;
// Bytes of x and dy a block keeps in flight ahead of the row it works on
// (S - 1 rows, at least one): about 16 KB a block, 32 KB an SM, ran
// fastest on an H100; twice that ran 8-12 % slower at d 3584 and 4096.
constexpr int BWD_FLIGHT_BYTES = 16 * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// At most 64 registers a thread, so that two blocks of 512 threads share
// an SM.
template <typename T, int S>
__global__ void __launch_bounds__(BWD_MAX_THREADS, 2)
rmsnorm_bwd_one_read_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, long long rows,
                            float eps) {
  constexpr int V = pack::Width<T>::N;
  constexpr int P = BWD_COLS / V;
  extern __shared__ uint4 ring[];
  __shared__ float2 red[2][BWD_MAX_THREADS / 32];  // by row parity, warp
  const int nt = blockDim.x;
  const int d = BWD_COLS * nt;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = nt >> 5;
  const int blocks = gridDim.x;
  const int n = (int)((rows - 1 - blockIdx.x) / blocks + 1);  // its rows

  // This thread's pack p of tensor k (0 x, 1 dy) in stage s.
  auto slot = [&](int s, int k, int p) -> uint4* {
    return ring + ((s * 2 + k) * P + p) * nt + t;
  };
  // The copies of the block's row i into stage s (none past its last), as
  // one commit group.
  auto issue = [&](int i, int s) {
    if (i < n) {
      const long long off = (blockIdx.x + (long long)i * blocks) * d;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = (t + nt * p) * V;
        cp_async16(slot(s, 0, p), x + off + c);
        cp_async16(slot(s, 1, p), dy + off + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s, s);

  uint4 wr[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    wr[p] = *reinterpret_cast<const uint4*>(w + (t + nt * p) * V);
  float acc[P * V];
#pragma unroll
  for (int j = 0; j < P * V; ++j) acc[j] = 0.0f;

  int s = 0;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();   // this thread's copies of row i
    uint4 xa[P], ga[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      xa[p] = *slot(s, 0, p);
      ga[p] = *slot(s, 1, p);
    }
    // stage s - 1 was read into registers in the previous iteration
    issue(i + S - 1, s == 0 ? S - 1 : s - 1);

    float ss = 0.0f, dot = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float a[V], g[V], h[V];
      pack::unpack16<T>(xa[p], a);
      pack::unpack16<T>(ga[p], g);
      pack::unpack16<T>(wr[p], h);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss = fmaf(a[j], a[j], ss);
        dot = fmaf(g[j] * h[j], a[j], dot);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    // The warps' sums through shared memory, one buffer a row parity: a
    // warp writes row i + 2's only after the barrier of row i + 1, which
    // every thread reaches after reading row i's.
    float2* rb = red[i & 1];
    if (lane == 0) rb[warp] = make_float2(ss, dot);
    __syncthreads();
    float tss = 0.0f, tdot = 0.0f;
    for (int k = 0; k < warps; ++k) {
      const float2 v = rb[k];
      tss += v.x;
      tdot += v.y;
    }
    const float r = rsqrtf(tss / (float)d + eps);
    const float c3 = (r * r * r) * (tdot / (float)d);

    T* orow = dx + (blockIdx.x + (long long)i * blocks) * d;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float a[V], g[V], h[V], o[V];
      pack::unpack16<T>(xa[p], a);
      pack::unpack16<T>(ga[p], g);
      pack::unpack16<T>(wr[p], h);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = (g[j] * h[j]) * r - a[j] * c3;
        acc[p * V + j] += g[j] * (a[j] * r);
      }
      pack::store16(orow + (t + nt * p) * V, o);
    }
    s = s == S - 1 ? 0 : s + 1;
  }
  cp_async_wait<0>();

  float* out = partial + (size_t)blockIdx.x * d;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < V; j += 4)
      pack::store16(out + (t + nt * p) * V + j, acc + p * V + j);
}

template <typename T, int S>
int launch_bwd_one_read_s(const T* x, const T* w, const T* dy, T* dx,
                          float* partial, long long rows, int nt, float eps,
                          int blocks, cudaStream_t stream) {
  const int smem = S * 2 * (BWD_COLS / pack::Width<T>::N) * nt * 16;
  // always: the static exchange buffer counts toward the default 48 KB too
  const cudaError_t e = cudaFuncSetAttribute(
      rmsnorm_bwd_one_read_kernel<T, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_one_read_kernel<T, S><<<blocks, nt, smem, stream>>>(
      x, w, dy, dx, partial, rows, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_one_read(const void* x, const void* w, const void* dy,
                        void* dx, void* dw, float* partial, long long rows,
                        int d, float eps, int blocks, cudaStream_t stream) {
  const int nt = d / BWD_COLS;
  if (rows <= 0 || blocks <= 0 || blocks > rows || d % (32 * BWD_COLS) != 0
      || nt > BWD_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  // rows of x and dy in flight ahead: two where two fit BWD_FLIGHT_BYTES
  const int e =
      2 * d * (int)sizeof(T) * 2 <= BWD_FLIGHT_BYTES
          ? launch_bwd_one_read_s<T, 3>((const T*)x, (const T*)w,
                                        (const T*)dy, (T*)dx, partial, rows,
                                        nt, eps, blocks, stream)
          : launch_bwd_one_read_s<T, 2>((const T*)x, (const T*)w,
                                        (const T*)dy, (T*)dx, partial, rows,
                                        nt, eps, blocks, stream);
  if (e != 0) return e;
  rmsnorm_dw_kernel<T><<<(d + 31) / 32, 32 * RED_WARPS, 0, stream>>>(
      partial, (T*)dw, blocks, d);
  return (int)cudaGetLastError();
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

// The backward: dx (rows, d) and dw (d,) in x's type from x, w and dy of one
// type (0 float32, 1 bfloat16, 2 float16).  partial: blocks * d f32 scratch.
// warps (1-4) a block and blocks come from the wrapper
// (`kernels/rmsnorm.py:bwd_warps`, `bwd_blocks`); vec: 1 when d is a
// multiple of the 16-byte pack and x, dy, w and dx are 16-byte aligned.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* partial, int dtype,
                           long long rows, int d, float eps, int vec,
                           int warps, int blocks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partial;
  if (dtype == 0)
    return launch_bwd<float>(x, w, dy, dx, dw, p, rows, d, eps, vec, warps,
                             blocks, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, p, rows, d, eps, vec,
                                     warps, blocks, s);
  if (dtype == 2)
    return launch_bwd<__half>(x, w, dy, dx, dw, p, rows, d, eps, vec, warps,
                              blocks, s);
  return (int)cudaErrorInvalidValue;
}

// The one-read backward (dense widths, 16-byte aligned rows): dx (rows, d)
// and dw (d,) as `rmsnorm_bwd` gives them, on a grid of `blocks` (at most
// rows) blocks of d / 8 threads; d a multiple of 256 up to 4096.  partial:
// blocks * d f32 scratch.
extern "C" int rmsnorm_bwd_one_read(const void* x, const void* w,
                                    const void* dy, void* dx, void* dw,
                                    void* partial, int dtype, long long rows,
                                    int d, float eps, int blocks,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partial;
  if (dtype == 0)
    return launch_bwd_one_read<float>(x, w, dy, dx, dw, p, rows, d, eps,
                                      blocks, s);
  if (dtype == 1)
    return launch_bwd_one_read<__nv_bfloat16>(x, w, dy, dx, dw, p, rows, d,
                                              eps, blocks, s);
  if (dtype == 2)
    return launch_bwd_one_read<__half>(x, w, dy, dx, dw, p, rows, d, eps,
                                       blocks, s);
  return (int)cudaErrorInvalidValue;
}
