// Streaming top-k nearest centers for Hopper (sm_90a): the k smallest
// squared distances per query row and their center ids, over a flat
// count-bounded center prefix (`topk_stream_f32`) or over the probed fine
// shards of a two-level index (`topk_multiprobe_f32`).
//
// Replaces the Pallas TPU kernels `_topk_kernel` / `topk_stream` and
// `_mp_kernel` / `topk_multiprobe_stream` of
// src/repro/kernels/topk_stream.py (the serving plane's ranking queries,
// serving/cluster_service.py).
//
// What bounds it.  Per call the flat kernel must read x (N*D) and the
// active centers (count*D) once and write 2*N*k words, while it does
// 2*N*count*D operations; at the serving shape (N=64, count=110,000, D=16)
// that is 225 MFLOP against 7 MB, so the f32 FMA rate (67 TFLOP/s outside
// the tensor cores, NVIDIA's H100 SXM data sheet) bounds it at 3.4 us.  The
// parity tier is full f32, so the tensor cores are not used.
//
// What the design does about it.  A serving microbatch is 64 rows, one
// block's worth, so the center range is split over blocks: grid (row
// blocks, splits), and split s walks center tiles s, s + S, s + 2S, ... up
// to ceil(count/64), with the count read from device memory (no host sync;
// the TPU kernel's clamped index map becomes this loop bound).  Each block
// computes its 64x64 distance tiles exactly as `dpmeans_assign` does
// (sqdist.cuh), writes them to shared memory, and four threads per row
// each keep a sorted top-k of their quarter of every tile in registers
// (insertion behind a one-compare reject, so most candidates cost one
// compare).  The four lists of a row merge by a bitonic step over warp
// shuffles, and each block writes one partial top-k per row.  A second
// small kernel merges the S partial lists of each row (one warp per row)
// and writes (inf, -1) for exhausted slots.  The multi-probe kernel is the
// same loop over (union rank, shard tile) items: the shard of union rank j
// is addressed as fine + cells[j] * S * D directly (the TPU index-map
// gather as a pointer offset, no gathered copy), the loop ends at
// u_count * ceil(S/64) items read from device memory, and a per-(row, rank)
// membership flag masks candidates after the distance is formed.
//
// Exactness.  Selection keeps the k lexicographically smallest (d2, id)
// pairs among valid candidates, starting from (inf, 2^31-1).  That set
// depends only on the candidate multiset, not on which thread, tile,
// block or split met a candidate first, and the distances are formed
// exactly as in dpmeans_assign (sqdist.cuh).  Hence, bitwise: column 0
// equals `dpmeans_assign`; multi-probe over every cell with all members
// equals the flat kernel, ids included (fine rows are bit-copies of flat
// rows, fine ids their flat ids); a row's answer does not depend on its
// batch, bucket or the split count.  Ties go to the lower id, as the
// reference's lexicographic merge (`ref.topk_merge_ref`) does.
//
// k is a template parameter over the power-of-two buckets 1..64; the
// output keeps the first k_out <= bucket columns.

#include "sqdist.cuh"

namespace {

using namespace sqdist;

constexpr int SENTINEL = 2147483647;  // TOPK_SENTINEL: after every real id
constexpr int PARTS = 4;              // selection threads per row
constexpr int MERGE_ROWS = 4;         // rows (warps) per merge block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cswap(float& da, int& ia, float& db, int& ib) {
  if (lex_less(db, ib, da, ia)) {
    const float td = da;
    const int ti = ia;
    da = db;
    ia = ib;
    db = td;
    ib = ti;
  }
}

template <int KK>
__device__ __forceinline__ void list_init(float (&ld)[KK], int (&li)[KK]) {
#pragma unroll
  for (int m = 0; m < KK; ++m) {
    ld[m] = CUDART_INF_F;
    li[m] = SENTINEL;
  }
}

// Offer a finite candidate to an ascending list: one compare rejects it,
// else it replaces the last entry and bubbles to its place.
template <int KK>
__device__ __forceinline__ void offer(float (&ld)[KK], int (&li)[KK], float v,
                                      int id) {
  if (v < CUDART_INF_F && lex_less(v, id, ld[KK - 1], li[KK - 1])) {
    ld[KK - 1] = v;
    li[KK - 1] = id;
#pragma unroll
    for (int s = KK - 1; s > 0; --s) cswap(ld[s - 1], li[s - 1], ld[s], li[s]);
  }
}

// Merge with the lane `off` away: the k smallest of the union of two
// ascending lists are min(mine[m], theirs[k-1-m]) (a bitonic sequence),
// sorted by a bitonic merge.  Both lanes end with the same list, and the
// lists of lanes that are merged are disjoint candidate sets.
template <int KK>
__device__ __forceinline__ void merge_lanes(float (&ld)[KK], int (&li)[KK],
                                            int off) {
  float od[KK];
  int oi[KK];
#pragma unroll
  for (int m = 0; m < KK; ++m) {
    od[m] = __shfl_xor_sync(FULL, ld[KK - 1 - m], off);
    oi[m] = __shfl_xor_sync(FULL, li[KK - 1 - m], off);
  }
#pragma unroll
  for (int m = 0; m < KK; ++m) {
    if (lex_less(od[m], oi[m], ld[m], li[m])) {
      ld[m] = od[m];
      li[m] = oi[m];
    }
  }
#pragma unroll
  for (int stride = KK / 2; stride > 0; stride >>= 1) {
#pragma unroll
    for (int m = 0; m < KK; ++m) {
      if ((m & stride) == 0) cswap(ld[m], li[m], ld[m + stride], li[m + stride]);
    }
  }
}

// Shared memory of the partial kernels: the distance tiles and, per tile,
// the candidates' ids and the rows' membership.
struct TopkSmem {
  Tiles t;
  float d2s[BM][BK + 1];
  int ids[BK];
  uint8_t member[BM];
};

// After a tile's distances are in s.d2s (inf where invalid): the thread's
// share of its row's candidates goes into its list.
template <int KK>
__device__ __forceinline__ void select_tile(const TopkSmem& s, float (&ld)[KK],
                                            int (&li)[KK]) {
  const int r = threadIdx.x / PARTS;
  const int part = threadIdx.x % PARTS;
#pragma unroll 1
  for (int m = part; m < BK; m += PARTS) offer(ld, li, s.d2s[r][m], s.ids[m]);
}

// The end of a partial block: merge the PARTS lists of each row and write
// the row's list to part[split][row][:].
template <int KK>
__device__ __forceinline__ void write_partial(float (&ld)[KK], int (&li)[KK],
                                              float* __restrict__ part_d,
                                              int* __restrict__ part_i,
                                              int row0, int n) {
#pragma unroll
  for (int off = 1; off < PARTS; off <<= 1) merge_lanes(ld, li, off);
  const int r = row0 + threadIdx.x / PARTS;
  if (threadIdx.x % PARTS == 0 && r < n) {
    const size_t base = ((size_t)blockIdx.y * n + r) * KK;
#pragma unroll
    for (int m = 0; m < KK; ++m) {
      part_d[base + m] = ld[m];
      part_i[base + m] = li[m];
    }
  }
}

template <int KK>
__global__ void __launch_bounds__(NT)
topk_flat_partial(const float* __restrict__ x, const float* __restrict__ c,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ count, float* __restrict__ part_d,
                  int* __restrict__ part_i, int n, int k, int d) {
  __shared__ TopkSmem s;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int n_split = gridDim.y;

  int active = *count;
  active = active < k ? active : k;
  active = active > 0 ? active : 0;
  const int n_tiles = (active + BK - 1) / BK;
  const bool x_resident = d <= DC;

  x_norms(s.t, x, row0, n, d);
  float ld[KK];
  int li[KK];
  list_init(ld, li);

  bool first = true;
  for (int tile = blockIdx.y; tile < n_tiles; tile += n_split) {
    const int k0 = tile * BK;
    float acc[RM][RK];
    tile_dots(s.t, x, row0, n, c + (size_t)k0 * d, k - k0, d,
              !x_resident || first, acc);
    first = false;
#pragma unroll
    for (int q = 0; q < RK; ++q) {
      const int kc = tx + TX * q;
      const int gk = k0 + kc;
      const bool valid = gk < active && mask[gk] != 0;
      const float cc = s.t.c2s[kc];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + TY * i;
        const float v = combine(s.t.x2s[r], cc, acc[i][q]);
        s.d2s[r][kc] = valid ? v : CUDART_INF_F;
      }
    }
    if (tid < BK) s.ids[tid] = k0 + tid;
    __syncthreads();
    select_tile(s, ld, li);
  }
  write_partial(ld, li, part_d, part_i, row0, n);
}

template <int KK>
__global__ void __launch_bounds__(NT)
topk_mp_partial(const float* __restrict__ x, const float* __restrict__ fine,
                const int* __restrict__ fine_ids,
                const uint8_t* __restrict__ fine_mask,
                const int* __restrict__ cells,
                const uint8_t* __restrict__ member,
                const int* __restrict__ u_count, float* __restrict__ part_d,
                int* __restrict__ part_i, int b, int u, int s_cap, int d) {
  __shared__ TopkSmem s;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int n_split = gridDim.y;

  int uc = *u_count;
  uc = uc < u ? uc : u;
  uc = uc > 0 ? uc : 0;
  const int tiles_per_shard = (s_cap + BK - 1) / BK;
  const int n_items = uc * tiles_per_shard;
  const bool x_resident = d <= DC;

  x_norms(s.t, x, row0, b, d);
  float ld[KK];
  int li[KK];
  list_init(ld, li);

  bool first = true;
  for (int item = blockIdx.y; item < n_items; item += n_split) {
    const int j = item / tiles_per_shard;
    const int s0 = (item % tiles_per_shard) * BK;
    const int cell = cells[j];  // the same for the whole block
    if (cell < 0) continue;     // -1 padding inside the union: no candidates
    const size_t shard = (size_t)cell * s_cap;
    if (tid < BM) {
      const int r = row0 + tid;
      s.member[tid] = r < b ? member[(size_t)r * u + j] : 0;
    }
    float acc[RM][RK];
    tile_dots(s.t, x, row0, b, fine + (shard + s0) * d, s_cap - s0, d,
              !x_resident || first, acc);
    first = false;
#pragma unroll
    for (int q = 0; q < RK; ++q) {
      const int kc = tx + TX * q;
      const int sc = s0 + kc;
      const bool cvalid = sc < s_cap && fine_mask[shard + sc] != 0;
      const float cc = s.t.c2s[kc];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + TY * i;
        const float v = combine(s.t.x2s[r], cc, acc[i][q]);
        s.d2s[r][kc] = (cvalid && s.member[r] != 0) ? v : CUDART_INF_F;
      }
    }
    if (tid < BK) {
      const int sc = s0 + tid;
      s.ids[tid] = sc < s_cap ? fine_ids[shard + sc] : SENTINEL;
    }
    __syncthreads();
    select_tile(s, ld, li);
  }
  write_partial(ld, li, part_d, part_i, row0, b);
}

// One warp per row: the n_split partial lists of the row, merged; exhausted
// slots become (inf, -1).
template <int KK>
__global__ void __launch_bounds__(32 * MERGE_ROWS)
topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
           float* __restrict__ d_out, int* __restrict__ i_out, int n,
           int n_split, int k_out) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * MERGE_ROWS + threadIdx.x / 32;
  if (row >= n) return;  // the whole warp
  float ld[KK];
  int li[KK];
  list_init(ld, li);
  for (int sp = lane; sp < n_split; sp += 32) {
    const size_t base = ((size_t)sp * n + row) * KK;
#pragma unroll 1
    for (int m = 0; m < KK; ++m) {
      const float v = part_d[base + m];
      const int id = part_i[base + m];
      if (!(v < CUDART_INF_F && lex_less(v, id, ld[KK - 1], li[KK - 1])))
        break;  // the partial list is ascending: the rest cannot enter
      offer(ld, li, v, id);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge_lanes(ld, li, off);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < KK; ++m) {
      if (m < k_out) {
        const bool found = ld[m] < CUDART_INF_F;
        d_out[(size_t)row * k_out + m] = found ? ld[m] : CUDART_INF_F;
        i_out[(size_t)row * k_out + m] = found ? li[m] : -1;
      }
    }
  }
}

template <int KK>
int launch_flat(const float* x, const float* c, const uint8_t* mask,
                const int* count, float* part_d, int* part_i, float* d_out,
                int* i_out, int n, int k, int d, int k_out, int n_split,
                cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, n_split);
  topk_flat_partial<KK><<<grid, NT, 0, stream>>>(x, c, mask, count, part_d,
                                                 part_i, n, k, d);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  topk_merge<KK><<<(n + MERGE_ROWS - 1) / MERGE_ROWS, 32 * MERGE_ROWS, 0,
                   stream>>>(part_d, part_i, d_out, i_out, n, n_split, k_out);
  return (int)cudaGetLastError();
}

template <int KK>
int launch_mp(const float* x, const float* fine, const int* fine_ids,
              const uint8_t* fine_mask, const int* cells,
              const uint8_t* member, const int* u_count, float* part_d,
              int* part_i, float* d_out, int* i_out, int b, int u, int s_cap,
              int d, int k_out, int n_split, cudaStream_t stream) {
  const dim3 grid((b + BM - 1) / BM, n_split);
  topk_mp_partial<KK><<<grid, NT, 0, stream>>>(
      x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, b,
      u, s_cap, d);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  topk_merge<KK><<<(b + MERGE_ROWS - 1) / MERGE_ROWS, 32 * MERGE_ROWS, 0,
                   stream>>>(part_d, part_i, d_out, i_out, b, n_split, k_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 on success); -1 for an unsupported bucket.
// part_d / part_i are scratch of n_split * n * kk floats / ints.
extern "C" int topk_stream_f32(const float* x, const float* centers,
                               const uint8_t* mask, const int* count,
                               float* part_d, int* part_i, float* d_out,
                               int* i_out, int n, int k, int d, int kk,
                               int k_out, int n_split, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kk) {
    case 1: return launch_flat<1>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    case 2: return launch_flat<2>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    case 4: return launch_flat<4>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    case 8: return launch_flat<8>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    case 16: return launch_flat<16>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    case 32: return launch_flat<32>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    case 64: return launch_flat<64>(x, centers, mask, count, part_d, part_i, d_out, i_out, n, k, d, k_out, n_split, st);
    default: return -1;
  }
}

extern "C" int topk_multiprobe_f32(const float* x, const float* fine,
                                   const int* fine_ids,
                                   const uint8_t* fine_mask, const int* cells,
                                   const uint8_t* member, const int* u_count,
                                   float* part_d, int* part_i, float* d_out,
                                   int* i_out, int b, int u, int s_cap, int d,
                                   int kk, int k_out, int n_split,
                                   void* stream) {
  if (b <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kk) {
    case 1: return launch_mp<1>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    case 2: return launch_mp<2>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    case 4: return launch_mp<4>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    case 8: return launch_mp<8>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    case 16: return launch_mp<16>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    case 32: return launch_mp<32>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    case 64: return launch_mp<64>(x, fine, fine_ids, fine_mask, cells, member, u_count, part_d, part_i, d_out, i_out, b, u, s_cap, d, k_out, n_split, st);
    default: return -1;
  }
}
