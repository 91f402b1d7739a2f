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
// What bounds it.  The flat kernel must read x (N*D) and the active
// centers (count*D) once and write 2*N*k words, while it does 2*N*count*D
// operations; at the serving shape (N=64, count=110,000, D=16) that is 225
// MFLOP against 7 MB, so the f32 FMA rate (67 TFLOP/s outside the tensor
// cores, NVIDIA's H100 SXM data sheet) bounds it at 3.4 us.  The
// multi-probe kernel needs only the member pairs: 2*D operations for each
// (query, valid row of a shard the query probes), about 0.9 MFLOP at the
// serving shape, against one read of the probed shards' rows, ids and mask
// (about 2.8 MB): it is bound by bytes (about 0.8 us).  The parity tier is
// full f32, so the tensor cores are not used.
//
// What the design does about it.
//  - One launch a call, nothing allocated a call.  The grid is (row blocks
//    of 64 queries, S splits of the candidate range); S and the tile width
//    come from the shapes alone (`topk_stream.n_split`, `block_k`,
//    `mp_n_split`).  With S = 1 the flat kernel's block writes the output.
//    Else the splits merge in the same launch, in a tree of at most two
//    levels: every block writes its rows' lists and takes its group's
//    ticket (groups of all S splits up to 16, else of about sqrt(S)); the
//    last block of a group folds the group's lists, and with several
//    groups writes the group's list and takes the row block's ticket, the
//    last group folding the group lists into the output.  Lists and
//    tickets live per (device, stream) on the host side; every launch
//    leaves the tickets reset.
//  - The distances.  At D = 16 the flat kernel runs assign's tile loop
//    (assign_tile.cuh, `fast::sweep`): 256-center tiles through a 3-stage
//    cp.async ring, 8 rows x 8 centers a thread as two 8 x 4 register
//    tiles; at k = 1 the call is assign's kernel itself (its min selection
//    and 64-bit key merge), so top-1 == assign holds by construction.  A
//    pool of one or two fast tiles (the multi-probe routing, K = 512)
//    would give one block, so it, and every other width, takes sqdist.cuh's
//    generic 64 x 64 tile on up to a split a tile.
//  - Selection behind a threshold, in registers.  Four lanes own a row;
//    each keeps an ascending list of its k best (d2, id) in registers.  In
//    the fast tile each warp owns 8 rows: after a half tile it stages its
//    8 x 128 distances in its own 4 KB of shared memory (rows padded to
//    132 floats, so that the writes of a q and the reads of the 32 lanes,
//    each taking every fourth candidate of its row, are free of bank
//    conflicts) and selects with a __syncwarp, no block barrier.  The
//    row's threshold is the least of its four lanes' last entries (a
//    candidate above another lane's full list has k better ones); while no
//    list of the row is full, a bound from the half's own candidates takes
//    its place (in each of k groups of 32 / k candidates of a lane the
//    least, and the greatest of those: k candidates at or below it).  Each
//    candidate is compared with the threshold by the full lexicographic
//    order (ids do not ascend across lanes, tiles or splits, so a compare
//    on d2 alone would drop a lower-id tie); only those that pass are
//    offered to the list (a bubble of compare-exchanges), so a lane's
//    rare insertions do not hold its warp at every candidate.  The four
//    lists of a row merge by bitonic steps over shuffles (mirrored chunks
//    of at most 16 entries, so that k = 64 needs no spill).  The generic
//    tile stages its 64 x 64 distances for the block and offers every one.
//  - Multi-probe computes member pairs only.  A block takes union ranks
//    j = s, s + S, ... below u_count (read on the device; ranks at or past
//    it and -1 cells are skipped).  For rank j each warp ballots the
//    membership flags of its 8 rows (column j of `member`) and, for each
//    member row alone, reads the shard fine + cells[j] * S_cap * D: the
//    mask first (one byte a row), then only the rows in the mask, 32 rows
//    a step across the lanes with four steps' loads in flight.  Each lane
//    selects into its register list, the 32 lists merge over shuffles, and
//    the pair's list is appended to the query's lists (a per-row atomic
//    counter); the last block of the row block folds each row's lists
//    into the output and resets the counters.  The x of other rows is
//    never read and no distance is formed for a non-member pair.  A
//    query's member ranks are arbitrary: its pairs meet in its lists.
//
// Registers.  The lists take 2 k registers a lane: two blocks an SM (128
// registers a thread) up to k = 8, one block (255) from k = 16.
//
// Exactness.  Every dot product, ||x||^2 and ||c||^2 is a chain of fmaf in
// ascending d from 0 and the distance is sqdist.cuh's `combine`, whichever
// tile or loop forms it, so a (row, center) pair has the same bits in every
// kernel here and in dpmeans_assign.  Selection keeps the k
// lexicographically smallest (d2, id) pairs among valid candidates; that
// set depends only on the candidate multiset, not on which lane, tile,
// split or insertion order met a candidate first.  Hence, bitwise: column
// 0 equals `dpmeans_assign`; multi-probe over every cell with all members
// equals the flat kernel, ids included (fine rows are bit-copies of flat
// rows, fine ids their flat ids); a row's answer does not depend on its
// batch, bucket or S; the first columns of a larger k bucket are a
// smaller bucket's.  Exhausted slots are (inf, -1).
//
// k is a template parameter over the power-of-two buckets 1..64; the
// output keeps the first k_out <= bucket columns.
//
// k > 64: the wide route (`topk_wide_f32`, `topk_mp_wide_f32`).  Register
// lists stop at 64, so a larger k keeps its list in memory: one block of
// 256 threads a (query row, split of the candidate range), the grid (rows,
// S) with S from the shapes alone (`topk_stream.wide_n_split`).  A
// candidate is the 64-bit key bits(d2) << 32 | id, whose integer order is
// the (d2, id) order (d2 is +0, positive or finite; invalid and inf
// distances are the key ~0, after every real one).  The block keeps an
// ascending list of L keys (L the power of two at or above min(k, the
// candidates), in shared memory up to 2,048 keys, else in global
// scratch) and walks its range in rounds of 2,048 candidates: each thread
// forms its candidates' distances (the same fmaf chains and `combine` as
// every kernel here, so the same bits), those below the list's last key
// are appended to a shared buffer, and a round that appended any sorts
// the buffer (a block-wide bitonic sort over the next power of two) and
// folds it in: min(list[m], buffer[L-1-m]) is bitonic and holds the L
// smallest of both, so one bitonic merge makes it the new list.  With
// S > 1 every block writes its list to scratch and takes its row's ticket;
// the last folds the other S - 1 lists the same way and writes the row,
// (inf, -1) past the list or where a key is ~0.  The selected set is the
// L smallest keys of the candidate set, which depends on neither S nor the
// order of the rounds, so the route equals the plain version's
// lexicographic selection exactly, ids included.  Multi-probe splits a
// row's union ranks (split s takes ranks s, s + S, ...) and walks only a
// member rank's shard, forming a distance for its valid rows.  A simple
// route: each block reads
// every candidate row of its range for its one query row, so the flat
// route reads the active centers once a query row (no reuse across rows).

#include "assign_tile.cuh"

namespace {

using sqdist::combine;
using sqdist::lex_less;

constexpr int BM = 64;                // query rows per block
constexpr int NT = 256;               // threads per block
constexpr int PARTS = 4;              // lanes (threads) per row
constexpr int SENTINEL = 2147483647;  // TOPK_SENTINEL: after every real id
constexpr unsigned FULL = 0xffffffffu;
// Tickets a row block: the flat merge's groups and their level (at most
// 31 groups: S <= 961), or the multi-probe kernel's one.
constexpr int TICKETS_PER_BLOCK = 32;

// Two blocks an SM where the lists leave room for it.
template <int KK>
constexpr int min_blocks() {
  return KK <= 8 ? 2 : 1;
}

// --------------------------------------------------------- register lists
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

// Offer a candidate to an ascending list: one compare against the last
// entry (the threshold) rejects it, else it replaces the last entry and
// bubbles to its place.  Invalid candidates come as inf.
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
  // Mirrored chunks [c0, c0 + CH) and [KK - c0 - CH, KK - c0) at a time:
  // the upper chunk's new values go aside while the partner still reads
  // this lane's lower chunk, the lower chunk's are made in place while it
  // reads the upper one; so only CH entries of temporaries are live.
  constexpr int CH = KK / 2 < 16 ? (KK / 2 > 0 ? KK / 2 : 1) : 16;
  if (KK == 1) {
    const float od = __shfl_xor_sync(FULL, ld[0], off);
    const int oi = __shfl_xor_sync(FULL, li[0], off);
    if (lex_less(od, oi, ld[0], li[0])) {
      ld[0] = od;
      li[0] = oi;
    }
    return;
  }
#pragma unroll
  for (int c0 = 0; c0 < KK / 2; c0 += CH) {
    float hd[CH];
    int hi[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int m = KK - 1 - c0 - j;
      const float od = __shfl_xor_sync(FULL, ld[c0 + j], off);
      const int oi = __shfl_xor_sync(FULL, li[c0 + j], off);
      const bool take = lex_less(od, oi, ld[m], li[m]);
      hd[j] = take ? od : ld[m];
      hi[j] = take ? oi : li[m];
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int m = c0 + j;
      const float od = __shfl_xor_sync(FULL, ld[KK - 1 - m], off);
      const int oi = __shfl_xor_sync(FULL, li[KK - 1 - m], off);
      if (lex_less(od, oi, ld[m], li[m])) {
        ld[m] = od;
        li[m] = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      ld[KK - 1 - c0 - j] = hd[j];
      li[KK - 1 - c0 - j] = hi[j];
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

// ----------------------------------------------------------- the merges
// Scratch of a launch (see the header note); counts and tickets are reset
// between launches.
struct Scratch {
  float* part_d;   // flat: n * (S + groups) * KK; multi-probe: n * U * KK
  int* part_i;
  int* counts;     // multi-probe: the lists appended to each row
  int* tickets;    // TICKETS_PER_BLOCK a row block
};

// Take the ticket of `counter` for the block (every thread calls this);
// true in the block that arrives `total`-th, which resets the counter.
__device__ __forceinline__ bool last_of(int* counter, int total, int* s_last) {
  __threadfence();  // this block's lists land before its ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(counter, 1) == total - 1;
    if (*s_last) *counter = 0;
  }
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// Lane `part` of a row folds lists part, part + 4, ... of the n_lists
// ascending lists of KK entries at pd / pi into its register list: lists
// are read in chunks (all KK entries up to 16, else 4, which keeps the
// unrolled offers of k = 32 and 64 small), the first chunks of up to four
// lists with their loads in flight together; a chunk whose first entry
// does not beat the lane's threshold ends its list.
template <int KK>
__device__ __forceinline__ void fold_lists(float (&ld)[KK], int (&li)[KK],
                                           const float* pd, const int* pi,
                                           int n_lists, int part) {
  constexpr int C = KK <= 16 ? KK : 4;
  constexpr int NB = KK <= 4 ? 4 : (KK <= 8 ? 2 : 1);
  for (int l0 = part; l0 < n_lists; l0 += PARTS * NB) {
    float v[NB][C];
    int id[NB][C];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int l = l0 + PARTS * b;
#pragma unroll
      for (int m = 0; m < C; ++m) {
        v[b][m] = l < n_lists ? __ldcg(pd + (size_t)l * KK + m) : CUDART_INF_F;
        id[b][m] = l < n_lists ? __ldcg(pi + (size_t)l * KK + m) : SENTINEL;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!(v[b][0] < CUDART_INF_F &&
            lex_less(v[b][0], id[b][0], ld[KK - 1], li[KK - 1])))
        continue;
#pragma unroll
      for (int m = 0; m < C; ++m) offer(ld, li, v[b][m], id[b][m]);
      const size_t at = (size_t)(l0 + PARTS * b) * KK;
#pragma unroll 1
      for (int m0 = C; m0 < KK; m0 += C) {
        float w[C];
        int wi[C];
#pragma unroll
        for (int m = 0; m < C; ++m) {
          w[m] = __ldcg(pd + at + m0 + m);
          wi[m] = __ldcg(pi + at + m0 + m);
        }
        if (!(w[0] < CUDART_INF_F &&
              lex_less(w[0], wi[0], ld[KK - 1], li[KK - 1])))
          break;
#pragma unroll
        for (int m = 0; m < C; ++m) offer(ld, li, w[m], wi[m]);
      }
    }
  }
}

// Write the output row gr (lanes part take entries part, part + 4, ...),
// (inf, -1) where exhausted.
template <int KK>
__device__ __forceinline__ void write_row(const float (&ld)[KK],
                                          const int (&li)[KK], int gr,
                                          int part, int k_out,
                                          float* __restrict__ d_out,
                                          int* __restrict__ i_out) {
#pragma unroll
  for (int m = 0; m < KK; ++m) {
    if (m % PARTS == part && m < k_out) {
      const bool found = ld[m] < CUDART_INF_F;
      d_out[(size_t)gr * k_out + m] = found ? ld[m] : CUDART_INF_F;
      i_out[(size_t)gr * k_out + m] = found ? li[m] : -1;
    }
  }
}

// Splits a merge group holds: all S up to 16, else about sqrt(S).
__device__ __forceinline__ int group_size(int n_split) {
  if (n_split <= 16) return n_split;
  int g = 1;
  while (g * g < n_split) ++g;
  return g;
}

// Write this thread's share of row gr's list (entries part, part + 4, ...)
// at pd / pi.
template <int KK>
__device__ __forceinline__ void put_list(const float (&ld)[KK],
                                         const int (&li)[KK], float* pd,
                                         int* pi, int part) {
#pragma unroll
  for (int m = 0; m < KK; ++m) {
    if (m % PARTS == part) {
      pd[m] = ld[m];
      pi[m] = li[m];
    }
  }
}

// The end of a flat block: the PARTS lists of each row (threads 4 r .. 4 r
// + 3, r = tid / 4) merge; with one split the block writes the row.  Else
// the splits merge in a tree of at most two levels: each block writes its
// rows' lists and takes its group's ticket (groups of `group_size` splits);
// the last block of a group folds the group's lists (lane `part` of a row
// folding lists part, part + 4, ...) and, with one group, writes the
// output; with several it writes the group's list and takes the row
// block's ticket, and the last group folds the group lists and writes the
// output.  Every thread of the block calls this.
template <int KK>
__device__ __forceinline__ void finish_flat(float (&ld)[KK], int (&li)[KK],
                                            int* s_last, int n, int k_out,
                                            float* __restrict__ d_out,
                                            int* __restrict__ i_out,
                                            const Scratch& g) {
#pragma unroll 1
  for (int off = 1; off < PARTS; off <<= 1) merge_lanes(ld, li, off);
  const int part = threadIdx.x % PARTS;
  const int gr = blockIdx.x * BM + threadIdx.x / PARTS;
  const bool live = gr < n;
  const int n_split = gridDim.y;
  if (n_split > 1) {
    const int gs = group_size(n_split);
    const int n_groups = (n_split + gs - 1) / gs;
    const int grp = blockIdx.y / gs;
    const int in_grp = min(gs, n_split - grp * gs);
    int* tickets = g.tickets + (size_t)blockIdx.x * (TICKETS_PER_BLOCK);
    // level 1: the splits' lists, row-major [row][split][KK]
    float* sd = g.part_d + (size_t)gr * n_split * KK;
    int* si = g.part_i + (size_t)gr * n_split * KK;
    if (live) put_list(ld, li, sd + blockIdx.y * KK, si + blockIdx.y * KK,
                       part);
    if (!last_of(tickets + grp, in_grp, s_last)) return;
    list_init(ld, li);
    if (live)
      fold_lists(ld, li, sd + (size_t)grp * gs * KK, si + (size_t)grp * gs * KK,
                 in_grp, part);
#pragma unroll 1
    for (int off = 1; off < PARTS; off <<= 1) merge_lanes(ld, li, off);
    if (n_groups > 1) {
      // level 2: the groups' lists after all the splits' lists
      float* gd = g.part_d + (size_t)n * n_split * KK
                  + (size_t)gr * n_groups * KK;
      int* gi = g.part_i + (size_t)n * n_split * KK
                + (size_t)gr * n_groups * KK;
      if (live) put_list(ld, li, gd + grp * KK, gi + grp * KK, part);
      if (!last_of(tickets + n_groups, n_groups, s_last)) return;
      list_init(ld, li);
      if (live) fold_lists(ld, li, gd, gi, n_groups, part);
#pragma unroll 1
      for (int off = 1; off < PARTS; off <<= 1) merge_lanes(ld, li, off);
    }
  }
  if (live) write_row(ld, li, gr, part, k_out, d_out, i_out);
}

// ------------------------------------------------------- flat, D = 16
namespace fast = assign_tile::fast;

constexpr int STG = 132;   // staged row stride in floats (see the header)

struct FastSmem {
  fast::Smem<float> t;
  float stg[NT / 32][fast::RM * STG];   // each warp's staged half tile
};

// The least (d, id) over the PARTS lanes of a row.
__device__ __forceinline__ void row_min(float& d, int& i) {
#pragma unroll
  for (int off = 1; off < PARTS; off <<= 1) {
    const float od = __shfl_xor_sync(FULL, d, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (lex_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Thread (warp ty, lane tx) computes rows 8 ty .. 8 ty + 7 and selects for
// row 8 ty + tx / 4 the candidates 4 m + tx % 4 of each half tile.
template <int KK>
struct TopkPick {
  float* stg;   // this warp's staging
  float ld[KK];
  int li[KK];

  __device__ __forceinline__ void half(const fast::Smem<float>& s,
                                       const float (&acc)[fast::RM][fast::RK],
                                       int k0, int h) {
    const int tx = threadIdx.x % 32;
    const int ty = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < fast::RK; ++q) {
      const int kc = tx + 32 * (q + fast::RK * h);
      const float cc = s.c2s[kc];
      const bool ok = s.ok[kc] != 0;
#pragma unroll
      for (int i = 0; i < fast::RM; ++i) {
        const float v = combine(s.x2s[fast::RM * ty + i], cc, acc[i][q]);
        stg[i * STG + 32 * q + tx] = ok ? v : CUDART_INF_F;
      }
    }
    __syncwarp();
    const float* row = stg + (tx / PARTS) * STG + tx % PARTS;
    const int id0 = k0 + fast::HALF * h + tx % PARTS;
    // The row's threshold: the least of its four lanes' last entries (a
    // candidate above another lane's full list has k better ones).
    float td = ld[KK - 1];
    int ti = li[KK - 1];
    row_min(td, ti);
    // While no list of the row is full, this half's own candidates give
    // one: in each of k groups of 32 / k consecutive candidates of a lane
    // the least, and the greatest of those k -- k candidates at or below
    // it.
    float bd = CUDART_INF_F;
    int bi = SENTINEL;
    if (KK <= 16 && !(td < CUDART_INF_F)) {
      constexpr int G = KK <= 16 ? 32 / KK : 1;
      bd = -1.f;
      bi = 0;
#pragma unroll
      for (int q = 0; q < KK && q * G < 32; ++q) {
        float gd = CUDART_INF_F;
        int gi = SENTINEL;
#pragma unroll
        for (int m = q * G; m < (q + 1) * G; ++m) {
          const float v = row[PARTS * m];
          if (lex_less(v, id0 + PARTS * m, gd, gi)) {
            gd = v;
            gi = id0 + PARTS * m;
          }
        }
        if (lex_less(bd, bi, gd, gi)) {
          bd = gd;
          bi = gi;
        }
      }
    }
    row_min(bd, bi);
    if (lex_less(bd, bi, td, ti)) {
      td = bd;
      ti = bi;
    }
    // One compare each (at or below the threshold: it may be a candidate
    // of this half itself), then only the candidates that passed are
    // offered, so a lane's rare insertions do not hold its warp at every
    // step.
    unsigned pass = 0;
#pragma unroll
    for (int m = 0; m < fast::HALF / PARTS; ++m) {
      const float v = row[PARTS * m];
      if (v < CUDART_INF_F && !lex_less(td, ti, v, id0 + PARTS * m))
        pass |= 1u << m;
    }
    while (pass != 0) {
      const int m = __ffs(pass) - 1;
      pass &= pass - 1;
      offer(ld, li, row[PARTS * m], id0 + PARTS * m);
    }
    __syncwarp();   // the staging is read before the next half writes it
  }
};

template <int KK>
__global__ void __launch_bounds__(NT, min_blocks<KK>())
topk_fast_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const uint8_t* __restrict__ mask,
                 const int* __restrict__ count, float* __restrict__ d_out,
                 int* __restrict__ i_out, Scratch g, int n, int k, int k_out,
                 int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FastSmem& s = *reinterpret_cast<FastSmem*>(smem_raw);
  TopkPick<KK> pick;
  pick.stg = s.stg[threadIdx.x / 32];
  list_init(pick.ld, pick.li);
  fast::sweep(s.t, x, c, mask, n, assign_tile::active_count(count, k),
              aligned != 0, pick);
  finish_flat(pick.ld, pick.li, &s.t.last, n, k_out, d_out, i_out, g);
}

// ------------------------------------------------------- flat, generic D
struct GenericSmem {
  sqdist::Tiles t;
  float d2s[BM][sqdist::BK + 1];
  int last;
};

template <int KK>
__global__ void __launch_bounds__(NT, min_blocks<KK>())
topk_generic_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ count, float* __restrict__ d_out,
                    int* __restrict__ i_out, Scratch g, int n, int k, int d,
                    int k_out) {
  using sqdist::BK;
  using sqdist::DC;
  using sqdist::RK;
  using sqdist::RM;
  using sqdist::TX;
  using sqdist::TY;
  __shared__ GenericSmem s;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int n_split = gridDim.y;

  const int active = assign_tile::active_count(count, k);
  const int n_tiles = (active + BK - 1) / BK;
  const bool x_resident = d <= DC;

  sqdist::x_norms(s.t, x, row0, n, d);
  float ld[KK];
  int li[KK];
  list_init(ld, li);

  bool first = true;
  for (int tile = blockIdx.y; tile < n_tiles; tile += n_split) {
    const int k0 = tile * BK;
    float acc[RM][RK];
    sqdist::tile_dots(s.t, x, row0, n, c + (size_t)k0 * d, k - k0, d,
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
        s.d2s[r][kc] = valid ? combine(s.t.x2s[r], cc, acc[i][q])
                             : CUDART_INF_F;
      }
    }
    __syncthreads();
    // Row tid / 4 takes candidates tid % 4 + 4 m of the tile.
#pragma unroll 1
    for (int m = tid % PARTS; m < BK; m += PARTS)
      offer(ld, li, s.d2s[tid / PARTS][m], k0 + m);
  }
  finish_flat(ld, li, &s.last, n, k_out, d_out, i_out, g);
}

// ------------------------------------------------------------ multi-probe
// One member pair: query xr against the shard (rows fr, ids fi, mask fm,
// s_cap rows), the whole warp; its list is appended to the query's lists
// (rl / ri, counted by *count).
// V16: D = 16 and 16-byte aligned rows, read as float4.
template <int KK, bool V16>
__device__ __forceinline__ void mp_pair(const float* __restrict__ xr,
                                        const float* __restrict__ fr,
                                        const int* __restrict__ fi,
                                        const uint8_t* __restrict__ fm,
                                        int s_cap, int d, float* rl,
                                        int* ri, int* count, int lane,
                                        unsigned long long* stats) {
  constexpr int B = 4;   // steps of 32 rows with loads in flight together
  float xv[V16 ? 16 : 1];
  float x2 = 0.f;
  if constexpr (V16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr) + q);
      xv[4 * q] = v.x;
      xv[4 * q + 1] = v.y;
      xv[4 * q + 2] = v.z;
      xv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) x2 = fmaf(xv[j], xv[j], x2);
  } else {
    for (int j = 0; j < d; ++j) {
      const float v = __ldg(xr + j);
      x2 = fmaf(v, v, x2);
    }
  }
  float ld[KK];
  int li[KK];
  list_init(ld, li);
  const int steps = (s_cap + 31) / 32;
  for (int g0 = 0; g0 < steps; g0 += 32) {
    // The mask of this lane's rows (g0 + m) * 32 + lane, m < 32.
    unsigned vm = 0;
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      const int sr = (g0 + m) * 32 + lane;
      if (sr < s_cap && __ldg(fm + sr) != 0) vm |= 1u << m;
    }
    const unsigned any = __reduce_or_sync(FULL, vm);
    if (stats != nullptr) {
      const int formed = __reduce_add_sync(FULL, __popc(vm));
      if (lane == 0) atomicAdd(stats, (unsigned long long)formed);
    }
#pragma unroll 1
    for (int m0 = 0; m0 < 32; m0 += B) {
      if (((any >> m0) & ((1u << B) - 1)) == 0) continue;
      float dot[B], c2[B];
      int id[B];
#pragma unroll
      for (int t = 0; t < B; ++t) {
        dot[t] = 0.f;
        c2[t] = 0.f;
        id[t] = 0;
        if (vm >> (m0 + t) & 1) {
          const int sr = (g0 + m0 + t) * 32 + lane;
          id[t] = __ldg(fi + sr);
          if constexpr (V16) {
            const float4* cr = reinterpret_cast<const float4*>(fr) + 4 * sr;
            float4 cv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) cv[q] = __ldg(cr + q);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              c2[t] = fmaf(cv[q].x, cv[q].x, c2[t]);
              c2[t] = fmaf(cv[q].y, cv[q].y, c2[t]);
              c2[t] = fmaf(cv[q].z, cv[q].z, c2[t]);
              c2[t] = fmaf(cv[q].w, cv[q].w, c2[t]);
              dot[t] = fmaf(xv[4 * q], cv[q].x, dot[t]);
              dot[t] = fmaf(xv[4 * q + 1], cv[q].y, dot[t]);
              dot[t] = fmaf(xv[4 * q + 2], cv[q].z, dot[t]);
              dot[t] = fmaf(xv[4 * q + 3], cv[q].w, dot[t]);
            }
          } else {
            const float* cr = fr + (size_t)sr * d;
            for (int j = 0; j < d; ++j) {
              const float cv = __ldg(cr + j);
              c2[t] = fmaf(cv, cv, c2[t]);
              dot[t] = fmaf(__ldg(xr + j), cv, dot[t]);
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < B; ++t)
        if (vm >> (m0 + t) & 1)
          offer(ld, li, combine(x2, c2[t], dot[t]), id[t]);
    }
  }
#pragma unroll 1
  for (int off = 1; off < 32; off <<= 1) merge_lanes(ld, li, off);
  if (!(ld[0] < CUDART_INF_F)) return;   // the shard had no valid row
  int at = 0;
  if (lane == 0) at = atomicAdd(count, 1);
  at = __shfl_sync(FULL, at, 0);
#pragma unroll
  for (int m = 0; m < KK; ++m) {
    if (m % 32 == lane) {
      rl[(size_t)at * KK + m] = ld[m];
      ri[(size_t)at * KK + m] = li[m];
    }
  }
  if (stats != nullptr && lane == 0) atomicAdd(stats + 1, 1ull);
}

template <int KK, bool V16>
__global__ void __launch_bounds__(NT, min_blocks<KK>())
topk_mp_kernel(const float* __restrict__ x, const float* __restrict__ fine,
               const int* __restrict__ fine_ids,
               const uint8_t* __restrict__ fine_mask,
               const int* __restrict__ cells,
               const uint8_t* __restrict__ member,
               const int* __restrict__ u_count, float* __restrict__ d_out,
               int* __restrict__ i_out, Scratch g, int b, int u, int s_cap,
               int d, int k_out, unsigned long long* stats) {
  __shared__ int last;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int row0 = blockIdx.x * BM;
  int uc = *u_count;
  uc = uc < u ? uc : u;
  uc = uc > 0 ? uc : 0;
  for (int j = blockIdx.y; j < uc; j += gridDim.y) {
    const int cell = cells[j];  // the same for the whole block
    if (cell < 0) continue;     // -1 padding inside the union
    const int gq = row0 + 8 * w + (lane & 7);
    const bool mem = lane < 8 && gq < b && member[(size_t)gq * u + j] != 0;
    unsigned mb = __ballot_sync(FULL, mem);
    const size_t shard = (size_t)cell * s_cap;
    while (mb != 0) {
      const int q = row0 + 8 * w + __ffs(mb) - 1;
      mb &= mb - 1;
      mp_pair<KK, V16>(x + (size_t)q * d, fine + shard * d, fine_ids + shard,
                       fine_mask + shard, s_cap, d,
                       g.part_d + (size_t)q * u * KK,
                       g.part_i + (size_t)q * u * KK, g.counts + q, lane,
                       stats);
    }
  }
  // The last block of the row block folds each row's lists (lanes 4 r ..
  // 4 r + 3 of row r) and writes the output.
  if (!last_of(g.tickets + (size_t)blockIdx.x * TICKETS_PER_BLOCK, gridDim.y,
               &last))
    return;
  const int part = threadIdx.x % PARTS;
  const int gr = row0 + threadIdx.x / PARTS;
  float ld[KK];
  int li[KK];
  list_init(ld, li);
  if (gr < b)
    fold_lists(ld, li, g.part_d + (size_t)gr * u * KK,
               g.part_i + (size_t)gr * u * KK, __ldcg(g.counts + gr), part);
#pragma unroll 1
  for (int off = 1; off < PARTS; off <<= 1) merge_lanes(ld, li, off);
  if (gr < b) {
    write_row(ld, li, gr, part, k_out, d_out, i_out);
    if (part == 0) g.counts[gr] = 0;
  }
}

// ---------------------------------------------------------------- launches
template <int KK>
int launch_flat(const float* x, const float* c, const uint8_t* mask,
                const int* count, float* d_out, int* i_out, const Scratch& g,
                int n, int k, int d, int k_out, int bk, int n_split,
                cudaStream_t st) {
  const dim3 grid((n + BM - 1) / BM, n_split);
  if (d == fast::D && bk == fast::BK) {
    constexpr int smem = (int)sizeof(FastSmem);
    const int e = assign_tile::smem_attr<topk_fast_kernel<KK>>(smem);
    if (e != 0) return e;
    const int aligned = ((reinterpret_cast<uintptr_t>(c) |
                          reinterpret_cast<uintptr_t>(mask)) % 16) == 0;
    topk_fast_kernel<KK><<<grid, NT, smem, st>>>(
        x, c, mask, count, d_out, i_out, g, n, k, k_out, aligned);
  } else {
    topk_generic_kernel<KK><<<grid, NT, 0, st>>>(
        x, c, mask, count, d_out, i_out, g, n, k, d, k_out);
  }
  return (int)cudaGetLastError();
}

template <int KK>
int launch_mp(const float* x, const float* fine, const int* fine_ids,
              const uint8_t* fine_mask, const int* cells,
              const uint8_t* member, const int* u_count, float* d_out,
              int* i_out, const Scratch& g, unsigned long long* stats, int b,
              int u, int s_cap, int d, int k_out, int n_split,
              cudaStream_t st) {
  const dim3 grid((b + BM - 1) / BM, n_split);
  const bool v16 = d == 16 && ((reinterpret_cast<uintptr_t>(x) |
                                reinterpret_cast<uintptr_t>(fine)) % 16) == 0;
  if (v16)
    topk_mp_kernel<KK, true><<<grid, NT, 0, st>>>(
        x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g,
        b, u, s_cap, d, k_out, stats);
  else
    topk_mp_kernel<KK, false><<<grid, NT, 0, st>>>(
        x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g,
        b, u, s_cap, d, k_out, stats);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- k > 64: the wide route
namespace wide {

using u64 = unsigned long long;
constexpr u64 NONE = ~0ull;       // an invalid or exhausted slot
constexpr int NTW = 256;          // threads per block
constexpr int CHUNK = 2048;       // candidates a round (8 a thread)
constexpr int LIST_SMEM = 2048;   // lists up to this length live in smem

__device__ __forceinline__ u64 key_of(float d2, int id) {
  if (!(d2 < CUDART_INF_F)) return NONE;
  return ((u64)__float_as_uint(__fadd_rn(d2, 0.f)) << 32) | (unsigned)id;
}

// Compare-exchange of the pairs (i, i + stride) for one bitonic stage over
// a[0, m): ascending where (i & size) == 0 (size = m: all ascending).
__device__ __forceinline__ void stage(u64* a, int m, int size, int stride) {
  for (int t = threadIdx.x; t < (m >> 1); t += NTW) {
    const int i = 2 * t - (t & (stride - 1));
    const int j = i + stride;
    const u64 ai = a[i], aj = a[j];
    if ((ai > aj) == ((i & size) == 0)) {
      a[i] = aj;
      a[j] = ai;
    }
  }
  __syncthreads();
}

// Block-wide bitonic sort of a[0, m), m a power of two, ascending.
__device__ __forceinline__ void sort_keys(u64* a, int m) {
  for (int size = 2; size <= m; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      stage(a, m, size, stride);
}

// A bitonic a[0, m) made ascending.
__device__ __forceinline__ void merge_bitonic(u64* a, int m) {
  for (int stride = m >> 1; stride > 0; stride >>= 1) stage(a, m, m, stride);
}

// Fold the ascending keys b[0, nb) (past them: NONE) into the ascending
// list a[0, kk): the kk smallest of both, ascending.  `other`: b is
// another block's list in global memory, read past L1.
__device__ __forceinline__ void fold(u64* a, int kk, const u64* b,
                                     int nb, bool other) {
  for (int t = threadIdx.x; t < kk; t += NTW) {
    const int j = kk - 1 - t;
    if (j < nb) {
      const u64 v = other ? __ldcg(b + j) : b[j];
      if (v < a[t]) a[t] = v;
    }
  }
  __syncthreads();
  merge_bitonic(a, kk);
}

constexpr int PER = CHUNK / NTW;   // candidates a thread a round

// One round: this thread's PER candidate keys (NONE where it has none)
// below the list's last key are appended to the shared buffer, which is
// sorted and folded into the list if any thread appended.  Every thread
// of the block calls this.  nb holds two counters, this round's and the
// next's: the next one is zeroed here, before this round's barrier, so a
// thread that runs ahead into the next round (no barrier follows a round
// that appended nothing) counts from 0, and one still reading this
// round's counter is not cut short.
__device__ __forceinline__ void offer_round(u64* list, u64* buf, int* nb,
                                            int kk, int round,
                                            const u64 (&keys)[PER]) {
  const int tid = threadIdx.x;
  if (tid == 0) nb[(round + 1) & 1] = 0;
  const u64 thr = list[kk - 1];
  int* nb_at = &nb[round & 1];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (keys[i] < thr) buf[atomicAdd(nb_at, 1)] = keys[i];
  __syncthreads();
  const int n = *nb_at;
  if (n > 0) {
    int m = 1;
    while (m < n) m <<= 1;
    for (int t = n + tid; t < m; t += NTW) buf[t] = NONE;
    __syncthreads();
    sort_keys(buf, m);
    fold(list, kk, buf, m, false);
  }
}

// The distance key of query row xr (||xr||^2 = x2) to the center row cr.
__device__ __forceinline__ u64 pair_key(const float* __restrict__ xr,
                                        float x2,
                                        const float* __restrict__ cr, int d,
                                        int id) {
  float c2 = 0.f, dot = 0.f;
  for (int j = 0; j < d; ++j) {
    const float cv = __ldg(cr + j);
    c2 = fmaf(cv, cv, c2);
    dot = fmaf(__ldg(xr + j), cv, dot);
  }
  return key_of(combine(x2, c2, dot), id);
}

// The start of a block (row blockIdx.x, split blockIdx.y): ||x_row||^2 and
// the two counters into shared memory, the list (shared memory up to
// LIST_SMEM keys, else this block's part of the scratch) filled with NONE.
__device__ __forceinline__ u64* wide_begin(u64* wsm, const float* xr, int d,
                                           int kk, u64* part, int* nb,
                                           float* x2) {
  const int n_split = gridDim.y;
  u64* list = kk <= LIST_SMEM
                  ? wsm + CHUNK
                  : part + ((size_t)blockIdx.x * n_split + blockIdx.y) * kk;
  if (threadIdx.x == 0) {
    float a = 0.f;
    for (int j = 0; j < d; ++j) a = fmaf(__ldg(xr + j), __ldg(xr + j), a);
    *x2 = a;
    nb[0] = nb[1] = 0;
  }
  for (int t = threadIdx.x; t < kk; t += NTW) list[t] = NONE;
  __syncthreads();
  return list;
}

// The end of a block: with S > 1 its list goes to the scratch and the
// row's last block (a ticket a row, left 0) folds the other S - 1 lists;
// that block, or the only one, writes the row: (inf, -1) past the list or
// where a key is NONE.
__device__ __forceinline__ void wide_end(u64* list, int kk, int k_out,
                                         u64* part, int* tickets,
                                         int* s_last,
                                         float* __restrict__ d_out,
                                         int* __restrict__ i_out) {
  const int row = blockIdx.x;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x;
  if (n_split > 1) {
    u64* own = part + ((size_t)row * n_split + blockIdx.y) * kk;
    if (own != list)
      for (int t = tid; t < kk; t += NTW) own[t] = list[t];
    if (!last_of(tickets + row, n_split, s_last)) return;
    for (int s = 0; s < n_split; ++s)
      if (s != (int)blockIdx.y)
        fold(list, kk, part + ((size_t)row * n_split + s) * kk, kk, true);
  }
  for (int m = tid; m < k_out; m += NTW) {
    const u64 v = m < kk ? list[m] : NONE;
    d_out[(size_t)row * k_out + m] =
        v == NONE ? CUDART_INF_F : __uint_as_float((unsigned)(v >> 32));
    i_out[(size_t)row * k_out + m] = v == NONE ? -1 : (int)(v & 0xffffffffu);
  }
}

// Flat: split s of S takes a contiguous range of the row's active prefix,
// masked.  part: rows * S * kk keys (used when S > 1 or kk > LIST_SMEM);
// tickets: one int a row, 0, left 0.
__global__ void __launch_bounds__(NTW, 1)
topk_wide_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const uint8_t* __restrict__ mask,
                 const int* __restrict__ count, float* __restrict__ d_out,
                 int* __restrict__ i_out, u64* part, int* tickets, int k,
                 int d, int kk, int k_out) {
  extern __shared__ __align__(16) u64 wsm[];
  __shared__ int s_nb[2];
  __shared__ float s_x2;
  __shared__ int s_last;
  const float* xr = x + (size_t)blockIdx.x * d;
  u64* list = wide_begin(wsm, xr, d, kk, part, s_nb, &s_x2);
  const float x2 = s_x2;
  const int total = assign_tile::active_count(count, k);
  const int per = (total + (int)gridDim.y - 1) / (int)gridDim.y;
  const int lo = blockIdx.y * per;
  const int hi = min(total, lo + per);
  int round = 0;
  for (int base = lo; base < hi; base += CHUNK, ++round) {
    u64 keys[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = base + threadIdx.x + NTW * i;
      keys[i] = t < hi && mask[t] != 0
                    ? pair_key(xr, x2, c + (size_t)t * d, d, t)
                    : NONE;
    }
    offer_round(list, wsm, s_nb, kk, round, keys);
  }
  wide_end(list, kk, k_out, part, tickets, &s_last, d_out, i_out);
}

// Multi-probe: split s of S takes union ranks s, s + S, ... below u_count
// and walks the shard of each rank the row is a member of (a non-member
// rank or a -1 cell costs one read), forming a distance for its valid
// rows.  stats: null, or two counters of which the first gets the
// distances formed.
__global__ void __launch_bounds__(NTW, 1)
topk_mp_wide_kernel(const float* __restrict__ x, const float* __restrict__ fine,
                    const int* __restrict__ fine_ids,
                    const uint8_t* __restrict__ fine_mask,
                    const int* __restrict__ cells,
                    const uint8_t* __restrict__ member,
                    const int* __restrict__ u_count, float* __restrict__ d_out,
                    int* __restrict__ i_out, u64* part, int* tickets, int u,
                    int s_cap, int d, int kk, int k_out,
                    unsigned long long* stats) {
  extern __shared__ __align__(16) u64 wsm[];
  __shared__ int s_nb[2];
  __shared__ float s_x2;
  __shared__ int s_last;
  const float* xr = x + (size_t)blockIdx.x * d;
  const uint8_t* member_row = member + (size_t)blockIdx.x * u;
  u64* list = wide_begin(wsm, xr, d, kk, part, s_nb, &s_x2);
  const float x2 = s_x2;
  int uc = *u_count;
  uc = uc < u ? uc : u;
  uc = uc > 0 ? uc : 0;
  unsigned formed = 0;
  int round = 0;
  for (int j = blockIdx.y; j < uc; j += gridDim.y) {
    const int cell = cells[j];
    if (cell < 0 || member_row[j] == 0) continue;
    const size_t shard = (size_t)cell * s_cap;
    for (int r0 = 0; r0 < s_cap; r0 += CHUNK, ++round) {
      u64 keys[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int sr = r0 + threadIdx.x + NTW * i;
        const size_t at = shard + sr;
        keys[i] = sr < s_cap && fine_mask[at] != 0
                      ? pair_key(xr, x2, fine + at * d, d,
                                 __ldg(fine_ids + at))
                      : NONE;
        formed += keys[i] != NONE;
      }
      offer_round(list, wsm, s_nb, kk, round, keys);
    }
  }
  if (stats != nullptr) {
    const unsigned sum = __reduce_add_sync(FULL, formed);
    if (threadIdx.x % 32 == 0 && sum != 0)
      atomicAdd(stats, (unsigned long long)sum);
  }
  wide_end(list, kk, k_out, part, tickets, &s_last, d_out, i_out);
}

inline int smem_bytes(int kk) {
  return (int)sizeof(u64) * (CHUNK + (kk <= LIST_SMEM ? kk : 0));
}

}  // namespace wide

}  // namespace

// Both entry points return a CUDA error code (0 on success), -1 for an
// unsupported bucket.  The flat kernel takes tiles of bk centers (256: the
// fast tile, D = 16 only; else 64, the generic one) and, with n_split > 1,
// part_d / part_i of n * (n_split + groups) * kk entries and tickets (32
// ints a row block, 0); at kk = 1 it is the nearest-center kernel, whose
// keys (n 64-bit, all ones) are `keys`.  The multi-probe kernel always
// merges through part_d / part_i (n * U * kk entries), counts (n ints, 0)
// and tickets.  Each launch leaves keys, counts and tickets so again.
// stats: null, or two counters the multi-probe kernel adds to (distances
// formed; lists appended).
extern "C" int topk_stream_f32(const float* x, const float* centers,
                               const uint8_t* mask, const int* count,
                               float* d_out, int* i_out,
                               unsigned long long* keys, float* part_d,
                               int* part_i, int* tickets, int n, int k, int d,
                               int kk, int k_out, int bk, int n_split,
                               void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch g{part_d, part_i, nullptr, tickets};
  switch (kk) {
    case 1: return assign_tile::launch(x, centers, mask, count, d_out, i_out, keys, tickets, n, k, d, n_split, st);
    case 2: return launch_flat<2>(x, centers, mask, count, d_out, i_out, g, n, k, d, k_out, bk, n_split, st);
    case 4: return launch_flat<4>(x, centers, mask, count, d_out, i_out, g, n, k, d, k_out, bk, n_split, st);
    case 8: return launch_flat<8>(x, centers, mask, count, d_out, i_out, g, n, k, d, k_out, bk, n_split, st);
    case 16: return launch_flat<16>(x, centers, mask, count, d_out, i_out, g, n, k, d, k_out, bk, n_split, st);
    case 32: return launch_flat<32>(x, centers, mask, count, d_out, i_out, g, n, k, d, k_out, bk, n_split, st);
    case 64: return launch_flat<64>(x, centers, mask, count, d_out, i_out, g, n, k, d, k_out, bk, n_split, st);
    default: return -1;
  }
}

extern "C" int topk_multiprobe_f32(const float* x, const float* fine,
                                   const int* fine_ids,
                                   const uint8_t* fine_mask, const int* cells,
                                   const uint8_t* member, const int* u_count,
                                   float* d_out, int* i_out, float* part_d,
                                   int* part_i, int* counts, int* tickets,
                                   unsigned long long* stats, int b, int u,
                                   int s_cap, int d, int kk, int k_out,
                                   int n_split, void* stream) {
  if (b <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch g{part_d, part_i, counts, tickets};
  switch (kk) {
    case 1: return launch_mp<1>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    case 2: return launch_mp<2>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    case 4: return launch_mp<4>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    case 8: return launch_mp<8>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    case 16: return launch_mp<16>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    case 32: return launch_mp<32>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    case 64: return launch_mp<64>(x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out, g, stats, b, u, s_cap, d, k_out, n_split, st);
    default: return -1;
  }
}

// The wide route for k > 64 (see the header): one block a (row, split), the
// grid (n, n_split); kk the list length (a power of two), k_out the output
// columns.  part: n * n_split * kk 64-bit keys when n_split > 1 or kk >
// 2,048, else unused; tickets: n ints, 0, left 0.  stats (multi-probe):
// null, or two counters of which the first gets the distances formed.
extern "C" int topk_wide_f32(const float* x, const float* centers,
                             const uint8_t* mask, const int* count,
                             float* d_out, int* i_out,
                             unsigned long long* part, int* tickets, int n,
                             int k, int d, int kk, int k_out, int n_split,
                             void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(n, n_split);
  wide::topk_wide_kernel<<<grid, wide::NTW, wide::smem_bytes(kk),
                           (cudaStream_t)stream>>>(
      x, centers, mask, count, d_out, i_out, part, tickets, k, d, kk, k_out);
  return (int)cudaGetLastError();
}

extern "C" int topk_mp_wide_f32(const float* x, const float* fine,
                                const int* fine_ids, const uint8_t* fine_mask,
                                const int* cells, const uint8_t* member,
                                const int* u_count, float* d_out, int* i_out,
                                unsigned long long* part, int* tickets,
                                unsigned long long* stats, int b, int u,
                                int s_cap, int d, int kk, int k_out,
                                int n_split, void* stream) {
  if (b <= 0) return 0;
  const dim3 grid(b, n_split);
  wide::topk_mp_wide_kernel<<<grid, wide::NTW, wide::smem_bytes(kk),
                              (cudaStream_t)stream>>>(
      x, fine, fine_ids, fine_mask, cells, member, u_count, d_out, i_out,
      part, tickets, u, s_cap, d, kk, k_out, stats);
  return (int)cudaGetLastError();
}
