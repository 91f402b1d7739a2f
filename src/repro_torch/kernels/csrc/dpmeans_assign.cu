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
//  - At D >= 64, a multiple of 8 (curation's 2048), the wide kernel.  There
//    few rows meet few centers over long rows: (256, 512, 2048) is 131,072
//    dot products of 2,048 dependent fmaf each, 8.0 us at the f32 FMA
//    rate.  The generic 64 x 64 tile gives that shape 16 blocks on 132
//    SMs and reaches 1.5 % of that rate there (0.5164 ms on an H100 80GB
//    HBM3 at 700 W, 8.1x its plain version).  The wide kernel takes tiles
//    of 16 rows x 32 centers on blocks of two warps (a 4 x 2 register tile
//    a thread), and its split allows one a tile (about four blocks an SM),
//    so that shape runs on 256 blocks; it streams x and center rows
//    through a 3-stage cp.async ring in 256-byte chunks, feeds the
//    register tile with vector shared loads (6 loads for 32 FMAs, x
//    broadcast to the 8 lanes of a row group, free of bank conflicts), and
//    forms ||x||^2 and ||c||^2 from the staged chunks beside the dot
//    products.  With about 8 pairs a lane at that shape, shared-memory
//    loads bound it: 0.058 ms, 14 % of the FMA rate, against 0.063 ms for
//    the plain version (same card).  assign_tile.cuh gives the details.
//  - Other widths (D = 8 of the examples and `serve_clusters`, odd and
//    narrow widths) take the generic kernel: 64 x 64 tiles staged through
//    shared memory in chunks of 32 values of D, a 4 x 4 register tile,
//    with the same split and merge.
//
// Input types.  x and the centers are f32, f16 or bf16 (one type a call),
// widened to f32 inside the kernel where a value is read into registers,
// as the Pallas kernel casts inside; the widening is exact, so no f32 bit
// moves (assign_tile.cuh says how the ring holds the narrower rows).
//
// The kernels live in assign_tile.cuh, which topk_stream.cu includes too:
// its k = 1 bucket is this kernel, and its other buckets at D = 16 run the
// same tile loop (`fast::sweep`), so a pair's distance has one definition.
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

#include "assign_tile.cuh"

// Returns a CUDA error code (0 on success).  dtype: 0 float32, 1 bfloat16,
// 2 float16 (x and centers share it).  With n_split > 1, keys holds at
// least n 64-bit keys that are all ones and tickets at least ceil(n/16)
// ints that are 0; each launch leaves them so again.  D = 16 takes the
// fast kernel, tiles of 256 centers on 64 rows; D >= 64 and a multiple of
// 8 the wide one, tiles of 32 on 16 rows; other widths the generic one,
// tiles of 64 on 64 rows (`dpmeans_assign.block_k` and `block_n` say the
// same).  generic: 1 runs the generic kernel at a wide width (a hook that
// holds the two against each other).
extern "C" int dpmeans_assign_fwd(const void* x, const void* centers,
                                  const uint8_t* mask, const int* count,
                                  float* d2_out, int* idx_out,
                                  unsigned long long* keys, int* tickets,
                                  int dtype, int n, int k, int d, int n_split,
                                  int generic, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool g = generic != 0;
  switch (dtype) {
    case 0:
      return assign_tile::launch((const float*)x, (const float*)centers, mask,
                                 count, d2_out, idx_out, keys, tickets, n, k,
                                 d, n_split, st, g);
    case 1:
      return assign_tile::launch((const __nv_bfloat16*)x,
                                 (const __nv_bfloat16*)centers, mask, count,
                                 d2_out, idx_out, keys, tickets, n, k, d,
                                 n_split, st, g);
    case 2:
      return assign_tile::launch((const __half*)x, (const __half*)centers,
                                 mask, count, d2_out, idx_out, keys, tickets,
                                 n, k, d, n_split, st, g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
