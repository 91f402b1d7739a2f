// Flash attention forward for Hopper (sm_90a): causal or full GQA attention
// with an online softmax, output in the inputs' type.  Two kernels, chosen
// by the element type in the wrapper (`kernels/flash_attention.py`):
//
//   bfloat16  `tc::flash_tc_kernel`: both products on the tensor cores
//             (wgmma), K/V tiles fed by TMA through a ring of shared-memory
//             stages;
//   float32   `simt::flash_fwd_kernel`: f32 FMA math, the IEEE parity tier of
//             the port (the f32 language-model checks rest on it).
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (one launch per transformer block on
// the language model's prefill path, `models/attention.py:attention_train`
// with attn_impl "flash").
//
// Semantics, as the TPU kernel's: logits of keys above the diagonal (causal)
// or past the sequence are -1e30; a running (m, l, acc) per query row in f32
// takes each key tile as
//   m' = max(m, max s),  p = exp(s - m'),  a = exp(m - m'),
//   l' = a l + sum p,    acc' = a acc + p v;
// the output is acc / max(l, 1e-30).  Query head h reads kv head h / group
// in place: grouped K/V are never repeated in memory.
//
// What bounds it.  At the prefill shape (B 4, H 32, Hkv 8, S 4096, Dh 128,
// causal) the two products are 2*S^2*Dh*B*H = 550 GFLOP (the causal half of
// 4 S^2 Dh a head) and the call moves 335 MB: operations bound it, 0.556 ms
// at the bf16 tensor-core peak (989 TFLOP/s) and 8.2 ms at the f32 rate
// outside the tensor cores (67 TFLOP/s).  Only the tensor cores get under
// the second figure, so the bf16 kernel is built on them.
//
// The bf16 kernel (`tc`).
//   * A block owns 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows each and one producer warpgroup, 384 threads.  Query tiles
//     launch heaviest first (the diagonal's far end), which shortens the
//     causal tail; the loop over key tiles stops at the diagonal, and only
//     the diagonal tile (and a ragged last tile, S < 128) is masked.
//   * The producer's first thread loads the Q tile once and then keeps TMA
//     loads of K and V tiles in flight through a ring of STAGES = 2
//     shared-memory stages: an mbarrier per stage says "K full", "V full"
//     (transaction bytes) and "empty" (one arrival per consumer warpgroup
//     once its wgmma has read the stage).  K and V have separate "full"
//     barriers, so S = Q K^T starts before V has landed.
//   * S = Q K^T: wgmma m64nBKVk16 with A = the warpgroup's 64 Q rows and
//     B = the K tile, both from shared memory and both K-major (contiguous
//     along Dh); Dh/16 instructions, f32 accumulators in registers.
//   * The online softmax runs on the accumulator fragment: a row's values
//     sit in 4 lanes (2 rows a thread), so the row max is two shuffles; l
//     is kept per lane and reduced once at the end.  Logits are scaled by
//     scale * log2(e) in f32 (q * scale is not a bf16 value, so the scale
//     is not folded into Q) and exponentiated with ex2.approx (the
//     special-function unit's 2^x).
//   * O += P V: P is converted to bf16 in place, the accumulator fragment
//     of two 8-key chunks being exactly wgmma's register A fragment of 16
//     keys, so P never touches shared memory.  B = the V tile (keys x Dh,
//     Dh contiguous: MN-major) through wgmma's transpose bit; one
//     m64nDhk16 instruction per 16 keys.  Rounding P to bf16 is the one
//     arithmetic difference from the TPU kernel (which keeps p in f32): each
//     p moves by at most 2^-9 of itself.
//   * TMA: one tensor map per input over the 4-D view (Dh, S, H, B) with
//     the tensor's byte strides (so the transposed (B, S, H, Dh) projections
//     are read in place), built on the host for every call and passed as a
//     __grid_constant__ parameter.  cuTensorMapEncodeTiled is a driver-API
//     function; it is looked up at run time through cudaGetDriverEntryPoint,
//     so the library needs no -lcuda.  The map's S extent is S itself: TMA
//     zero-fills rows past S (S below one tile), which the mask then sets to
//     -1e30.  With a swizzle the inner box is at most the swizzle span, so a
//     tile is DP / BW boxes of BW = min(Dh, 64) columns, swizzled over 2 BW
//     bytes (32, 64 or 128), and the wgmma descriptors name the same
//     swizzle: K-major operands step 32 bytes along Dh inside a box, the
//     V operand's leading byte offset is the box stride.
//   * Tiles (`Cfg<DH>`, the one table of them):
//       Dh 16, 32, 64, 112, 128: BKV = 128 keys;  Dh 256: BKV = 64 keys.
//     Shared memory (Q + 2 stages of K and V): 21, 41, 82, 165, 165 and
//     198 KB, one block an SM.
//   * Dh 112 (zamba2-7b's shared attention) runs the Dh-128 tile: Dh is
//     padded to DP = 128, two 64-column boxes, and the tensor maps' Dh
//     extent stays 112, so TMA fills columns 112-127 of Q, K and V with
//     zeros (and counts them in the transaction bytes, as it counts every
//     box in full).  Q K^T takes the 7 k16 steps of the 112 real columns;
//     P V runs n128, whose last 16 accumulator columns sum P times those
//     zeros and are not stored; the epilogue writes 112 columns at a row
//     stride of 112.  That is 14 % more P V tensor-core work than an n112
//     product would do.
//   * Registers.  A consumer thread holds Dh/2 accumulator floats of O,
//     BKV/2 of S and BKV/4 words of bf16 P: 160 at Dh 128, 176 at Dh 256,
//     before addresses and softmax state.  The launch gives the block 384
//     threads x 168 registers (ptxas's cap at one block of 384 an SM).
//     The split: setmaxnreg drops the producer warpgroup to 24 and raises
//     each consumer to 240 (128 x 24 + 256 x 240 = 64,512 = 384 x 168).
//     ptxas gives a 288-thread block (a single producer warp) no more
//     registers a thread than a 384-thread one, so without the split the
//     consumers would stay at 168, where the Dh=256 kernel spills.
//   * A wait on an mbarrier that has not completed after about 2^34 cycles
//     (~9 s) traps, so a lost transaction fails the launch instead of
//     hanging the card.
//
// The f32 kernel (`simt`).  One block of 256 threads per (b*h, 64-row query
// tile), any Dh that is a multiple of 16 (CPT = Dh/16 output columns a
// thread: 7 at Dh 112); Q (pre-scaled), the K tile and the V tile are staged in shared
// memory as f32 (98 KB at Dh=128, two blocks an SM); the P tile reuses the K
// tile's buffer.  Each thread holds a 4x4 register tile of logits and a 4 x
// Dh/16 tile of the output; a row's 16 threads are one half-warp, so the row
// max and sum are warp shuffles.  Loads from device memory are 16 bytes a
// thread along Dh; any (B, H, S) strides are taken, with Dh contiguous.

#include <cuda.h>
#include <cuda_runtime.h>

#include "pack.cuh"
#include "wgmma.cuh"

namespace simt {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per tile
constexpr int NT = 256;  // threads: 16 (tx, keys / columns) x 16 (ty, rows)
constexpr int PAD = 4;   // floats of padding per shared row
constexpr float NEG = -1e30f;

template <int DH>
struct Layout {
  static constexpr int QS = DH + PAD;    // row stride of the Q and K tiles
  static constexpr int PS = BKV + PAD;   // row stride of the P tile
  static constexpr int KP = QS > PS ? QS : PS;  // K and P share one buffer
  static constexpr int VS = DH;          // row stride of the V tile
  static constexpr int CPT = DH / 16;    // output columns per thread
  static constexpr size_t BYTES =
      sizeof(float) * (size_t)(BQ * QS + BKV * KP + BKV * VS);
};

// Rows [row0, row0 + 64) of a (S, DH) slice with row stride `stride`, as f32
// times `mul`, into a shared tile with row stride `ld`; rows at or past S
// are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long stride, int row0, int s,
                                          float mul) {
  constexpr int CPR = DH / 8;  // 8-element chunks per row
  for (int idx = threadIdx.x; idx < BQ * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 8;
    float f[8];
    if (row0 + r < s) {
      pack::load8(src + (long long)(row0 + r) * stride + c, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.0f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = make_float4(f[0] * mul, f[1] * mul, f[2] * mul, f[3] * mul);
    d4[1] = make_float4(f[4] * mul, f[5] * mul, f[6] * mul, f[7] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int h,
                 int hkv,
                 int s, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, float scale, int causal) {
  using L = Layout<DH>;
  constexpr int CPT = L::CPT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kps = qs + BQ * L::QS;
  float* vs = kps + BKV * L::KP;

  const int nq = (s + BQ - 1) / BQ;
  const int qb = nq - 1 - (int)blockIdx.y;  // heaviest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int kvh = hh / (h / hkv);
  const float* qp = q + b * qsb + hh * qsh;
  const float* kp = k + b * ksb + kvh * ksh;
  const float* vp = v + b * vsb + kvh * vsh;
  const int q0 = qb * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<DH>(qs, L::QS, qp, qss, q0, s, scale);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + BQ, s) - 1;
  const int n_kv = causal ? q_last / BKV + 1 : (s + BKV - 1) / BKV;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * BKV;
    load_tile<DH>(kps, L::QS, kp, kss, k0, s, 1.0f);
    load_tile<DH>(vs, L::VS, vp, vss, k0, s, 1.0f);
    __syncthreads();

    // logits: sc[i][j] = q[ty+16i] . k[tx+16j]
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L::QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(kps + (tx + 16 * j) * L::QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i].x, ka[j].x, sc[i][j]);
          sc[i][j] = fmaf(qa[i].y, ka[j].y, sc[i][j]);
          sc[i][j] = fmaf(qa[i].z, ka[j].z, sc[i][j]);
          sc[i][j] = fmaf(qa[i].w, ka[j].w, sc[i][j]);
        }
    }

    // Masking: only the diagonal tile (causal) and a ragged last tile.
    if ((causal && k0 + BKV - 1 > q0) || k0 + BKV > s) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q0 + ty + 16 * i;
          const int ki = k0 + tx + 16 * j;
          if (ki >= s || (causal && ki > qi)) sc[i][j] = NEG;
        }
    }

    // Online softmax; a row's 16 threads are one half-warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mc = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - mn);
        rs += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kps[(ty + 16 * i) * L::PS + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // acc[i][c] += sum_kk p[ty+16i][kk] * v[kk][tx*CPT + c]
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(kps + (ty + 16 * i) * L::PS + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = vs + (kk + t) * L::VS + tx * CPT;
        float vv[CPT];
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CPT; c += 4) pack::load16(vr + c, vv + c);
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vr[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = t == 0 ? p[i].x : t == 1 ? p[i].y
                         : t == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pi, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites K/P and V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* op = o + ((long long)bh * s + row) * DH + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) op[c] = acc[i][c] / li;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int s, const long long* st, float scale, int causal,
           cudaStream_t stream) {
  using L = Layout<DH>;
  auto kernel = flash_fwd_kernel<DH>;
  static bool opted_in = false;  // once per instantiation (and process)
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  if (b > 0 && h > 0 && s > 0) {
    const dim3 grid(b * h, (s + BQ - 1) / BQ);
    kernel<<<grid, NT, L::BYTES, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, h, hkv,
        s, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

constexpr int BQ = 128;                       // query rows a block
constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
// Registers a thread after the split: 128 x 24 + 256 x 240 = 64,512, the
// 384 x 168 the launch gives the block.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 2;                     // K/V ring depth
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int BKV = DH == 256 ? 64 : 128;   // keys a tile
  static constexpr int BW = DH < 64 ? DH : 64;        // Dh columns a box
  // Dh padded to whole boxes (112 -> 128); TMA zero-fills the padding
  static constexpr int DP = (DH + BW - 1) / BW * BW;
  static constexpr int NBOX = DP / BW;
  static constexpr int ROW = 2 * BW;                  // bytes a box row
  static constexpr uint64_t MODE = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr int Q_BOX = BQ * ROW;
  static constexpr int KV_BOX = BKV * ROW;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;
  // Q, STAGES K tiles, STAGES V tiles, barriers, and slack to align the
  // tiles to 1024 bytes (the 128-byte swizzle's period).
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 64 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.  Traps
// after about 2^34 cycles, so that a transaction that never lands fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

// One TMA box of a 4-D map at coordinates (c0 innermost .. c3) into shared
// memory at dst; completion is counted on bar in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B).
template <uint64_t MODE>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (MODE << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the wgmma fence, issue and wait (the asynchronous unit reads and writes
// them behind its back).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a p
// below 2^-126 is nothing beside a row sum of at least 1): one MUFU.EX2,
// without the subnormal fix-up of exp2f.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int h, int hkv, int s,
                float scale_log2, int causal) {
  using C = Cfg<DH>;
  constexpr int BKV = C::BKV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                         // [NBOX][BQ][BW]
  const uint32_t sk = sq + C::Q_BYTES;              // [STAGES][NBOX][BKV][BW]
  const uint32_t sv = sk + STAGES * C::KV_BYTES;    // [STAGES][NBOX][BKV][BW]
  const uint32_t bars = sv + STAGES * C::KV_BYTES;
  const uint32_t full_q = bars;
  // full_k(i) = bars + 8 (1 + i), full_v(i) = bars + 8 (1 + STAGES + i),
  // empty(i) = bars + 8 (1 + 2 STAGES + i)

  const int nq = (s + BQ - 1) / BQ;
  const int qb = nq - 1 - (int)blockIdx.y;  // heaviest causal tiles first
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = qb * BQ;
  const int q_end = min(q0 + BQ, s);
  const int n_kv = causal ? (q_end + BKV - 1) / BKV : (s + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars + 8 * (1 + i), 1);
      mbar_init(bars + 8 * (1 + STAGES + i), 1);
      mbar_init(bars + 8 * (1 + 2 * STAGES + i), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warpgroup; its first thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x)
        tma_load(sq + x * C::Q_BOX, &tq, full_q, x * C::BW, q0, hh, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % STAGES;
        mbar_wait(bars + 8 * (1 + 2 * STAGES + st), ((j / STAGES) & 1) ^ 1);
        const uint32_t fk = bars + 8 * (1 + st);
        const uint32_t fv = bars + 8 * (1 + STAGES + st);
        mbar_expect_tx(fk, C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x)
          tma_load(sk + st * C::KV_BYTES + x * C::KV_BOX, &tk, fk, x * C::BW,
                   j * BKV, kvh, b);
        mbar_expect_tx(fv, C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x)
          tma_load(sv + st * C::KV_BYTES + x * C::KV_BOX, &tv, fv, x * C::BW,
                   j * BKV, kvh, b);
      }
    }
    return;
  }

  // A consumer warpgroup: query rows q0 + 64 wg + [0, 64).  This thread
  // holds rows r_lo and r_lo + 8, and columns 8 j + cq + {0, 1}.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int w0 = q0 + 64 * wg;
  const int r_lo = w0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  constexpr int DP = C::DP;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.0f, 0.0f};

  mbar_wait(full_q, 0);
  __syncwarp();  // wgmma's .aligned forms need the warp converged
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % STAGES;
    const uint32_t par = (j / STAGES) & 1;
    const int k0 = j * BKV;
    const uint32_t kt = sk + st * C::KV_BYTES;
    const uint32_t vt = sv + st * C::KV_BYTES;

    // S = Q K^T for this warpgroup's 64 rows
    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
    mbar_wait(bars + 8 * (1 + st), par);
    __syncwarp();
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int box = kk * 16 / C::BW;
      const uint32_t inner = (kk * 16 % C::BW) * 2;
      const uint64_t da = desc<C::MODE>(
          sq + box * C::Q_BOX + wg * 64 * C::ROW + inner, 16, 8 * C::ROW);
      const uint64_t db =
          desc<C::MODE>(kt + box * C::KV_BOX + inner, 16, 8 * C::ROW);
      if constexpr (BKV == 64) {
        wgmma::ss_n64(sc, da, db, kk > 0);
      } else {
        wgmma::ss_n128(sc, da, db, kk > 0);
      }
    }
    wg_commit();
    wg_wait();
    pin(sc);

    // scale to log2 units; mask the diagonal tile and a ragged last tile
    const bool edge = k0 + BKV > s || (causal && k0 + BKV - 1 > w0);
#pragma unroll
    for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[4 * jj + 2 * i + c] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * jj + cq + c;
            if (key >= s || (causal && key > r_lo + 8 * i)) x = NEG;
          }
          sc[4 * jj + 2 * i + c] = x;
        }

    // online softmax; a row's values sit in the 4 lanes of one lane / 4
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = ex2(m[i] - mn);
      m[i] = mn;
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = ex2(sc[4 * jj + 2 * i + c] - mn);
          sc[4 * jj + 2 * i + c] = p;
          rs += p;
        }
      l[i] = alpha[i] * l[i] + rs;
    }
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * jj + 2 * i] *= alpha[i];
        acc[4 * jj + 2 * i + 1] *= alpha[i];
      }

    // P as bf16 A fragments: 16 keys = accumulator chunks 2 kk and 2 kk + 1
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V
    mbar_wait(bars + 8 * (1 + STAGES + st), par);
    __syncwarp();
    pin(acc);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t db =
          desc<C::MODE>(vt + kk * 16 * C::ROW, C::KV_BOX, 8 * C::ROW);
      if constexpr (DP == 16) {
        wgmma::rs_n16(acc, pa[kk], db);
      } else if constexpr (DP == 32) {
        wgmma::rs_n32(acc, pa[kk], db);
      } else if constexpr (DP == 64) {
        wgmma::rs_n64(acc, pa[kk], db);
      } else if constexpr (DP == 128) {
        wgmma::rs_n128(acc, pa[kk], db);
      } else {
        wgmma::rs_n256(acc, pa[kk], db);
      }
    }
    wg_commit();
    wg_wait();
    pin(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (1 + 2 * STAGES + st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
    const int row = r_lo + 8 * i;
    if (row >= s) continue;
    __nv_bfloat16* op = o + ((long long)bh * s + row) * DH + cq;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * jj) = __floats2bfloat162_rn(
          acc[4 * jj + 2 * i] / li, acc[4 * jj + 2 * i + 1] / li);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over the 4-D view (Dh, S, H, B) of a bf16 tensor: g holds
// the four extents and the byte strides of S, H and B; boxes of `cols` x
// `rows` x 1 x 1, swizzled over 2 * cols bytes.  Returns 0, or
// ENCODE_ERROR + the driver's error code.
constexpr int ENCODE_ERROR = 100000;

int encode(CUtensorMap* map, const void* ptr, const long long* g, int cols,
           int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                              (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                 (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* g, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<DH>;
  auto kernel = flash_tc_kernel<DH>;
  static bool opted_in = false;  // once per instantiation (and process)
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int s = (int)g[1], h = (int)g[2], b = (int)g[3];
  const int hkv = (int)g[7 + 2];
  if (b <= 0 || h <= 0 || s <= 0) return (int)cudaGetLastError();
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, g, C::BW, BQ);
  if (!err) err = encode(&tk, k, g + 7, C::BW, C::BKV);
  if (!err) err = encode(&tv, v, g + 14, C::BW, C::BKV);
  if (err) return err;
  const dim3 grid(b * h, (s + BQ - 1) / BQ);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, (__nv_bfloat16*)o, h,
                                             hkv, s, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// float32: q (B, H, S, Dh), k and v (B, Hkv, S, Dh) with element strides
// (qsb, qsh, qss), (ksb, ksh, kss), (vsb, vsh, vss) and Dh contiguous; o a
// contiguous (B, H, S, Dh).  Dh in {16, 32, 64, 112, 128, 256}; H a
// multiple of Hkv; every row 16-byte aligned (the wrapper checks all of
// it).
extern "C" int flash_attention_f32_fwd(const void* q, const void* k,
                                       const void* v, void* o, int b, int h,
                                       int hkv, int s, int dh, long long qsb,
                                       long long qsh, long long qss,
                                       long long ksb, long long ksh,
                                       long long kss, long long vsb,
                                       long long vsh, long long vss,
                                       float scale, int causal, void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (dh) {
    case 16: return simt::launch<16>(q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
    case 32: return simt::launch<32>(q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
    case 64: return simt::launch<64>(q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
    case 112: return simt::launch<112>(q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
    case 128: return simt::launch<128>(q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
    case 256: return simt::launch<256>(q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bfloat16: the tensor-core kernel.  geom holds, for q, k and v in turn, the
// extents (Dh, S, H or Hkv, B) and the byte strides of S, H and B (7 values
// each); the tiles are this file's (`tc::Cfg`).  o a contiguous
// (B, H, S, Dh).  Returns
// a CUDA error code, or 100000 + a driver error code from encoding a tensor
// map.
extern "C" int flash_attention_bf16_fwd(const void* q, const void* k,
                                        const void* v, void* o, int dh,
                                        const long long* geom, float scale,
                                        int causal, void* stream) {
  const cudaStream_t cs = (cudaStream_t)stream;
  switch (dh) {
    case 16: return tc::launch<16>(q, k, v, o, geom, scale, causal, cs);
    case 32: return tc::launch<32>(q, k, v, o, geom, scale, causal, cs);
    case 64: return tc::launch<64>(q, k, v, o, geom, scale, causal, cs);
    case 112: return tc::launch<112>(q, k, v, o, geom, scale, causal, cs);
    case 128: return tc::launch<128>(q, k, v, o, geom, scale, causal, cs);
    case 256: return tc::launch<256>(q, k, v, o, geom, scale, causal, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
