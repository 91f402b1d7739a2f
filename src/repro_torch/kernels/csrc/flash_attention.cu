// Flash attention forward for Hopper (sm_90a): causal or full GQA attention
// with an online softmax, f32 math, output in the inputs' type.
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (one launch per transformer block on
// the language model's prefill path, `models/attention.py:attention_train`
// with attn_impl "flash").
//
// Semantics, as the TPU kernel's: q is scaled before the dot; logits of keys
// above the diagonal (causal) or past the sequence are -1e30; a running
// (m, l, acc) per query row in f32 takes each key tile as
//   m' = max(m, max s),  p = exp(s - m'),  a = exp(m - m'),
//   l' = a l + sum p,    acc' = a acc + p v;
// the output is acc / max(l, 1e-30).  Query head h reads kv head h / group
// in place: grouped K/V are never repeated in memory.
//
// What bounds it.  At the prefill shape (B 4, H 32, Hkv 8, S 4096, Dh 128,
// causal) it does 2*S^2*Dh*B*H = 550 GFLOP of the two products and moves
// 335 MB: operations bound it.  That is 0.556 ms at the bf16 tensor-core
// peak (989 TFLOP/s) and 8.2 ms at the f32 rate outside the tensor cores
// (67 TFLOP/s), where this kernel computes: it uses no tensor cores yet
// (mma.sync or wgmma with TMA is later work).
//
// What the design does about it.  One block of 256 threads per (b*h,
// 64-row query tile); the tile loop over 64-key tiles takes the place of the
// TPU's sequential grid dimension, and under causal masking it stops at the
// diagonal (the counterpart of the `pl.when(needed)` skip), so the causal
// run does about half the work of the full one.  Q (pre-scaled), the K tile
// and the V tile are staged in shared memory as f32 (98 KB at Dh=128, above
// the 48 KB default, so the launch opts in to dynamic shared memory); the
// P tile reuses the K tile's buffer once the logits are in registers, which
// keeps two blocks resident per SM.  Each thread holds a 4x4 register tile
// of logits (rows ty+16i, keys tx+16j) fed by 16-byte shared-memory loads
// along Dh (rows padded by 4 floats: conflict-free quarter-warps), and a
// 4 x Dh/16 tile of the output (rows ty+16i, contiguous columns).  A row's
// 16 threads are one half-warp, so the row max and sum are warp shuffles.
// Query tiles are launched heaviest first (the diagonal's far end), which
// shortens the causal tail.  Loads from device memory are 16 bytes a
// thread along Dh; any (B, H, S) strides are taken, with Dh contiguous.

#include "pack.cuh"

namespace {

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
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
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

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int h, int hkv,
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
  const T* qp = q + b * qsb + hh * qsh;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;
  const int q0 = qb * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DH>(qs, L::QS, qp, qss, q0, s, scale);

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
    load_tile<T, DH>(kps, L::QS, kp, kss, k0, s, 1.0f);
    load_tile<T, DH>(vs, L::VS, vp, vss, k0, s, 1.0f);
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
    T* op = o + ((long long)bh * s + row) * DH + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) op[c] = pack::from_f<T>(acc[i][c] / li);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int s, const long long* st, float scale, int causal,
           cudaStream_t stream) {
  using L = Layout<DH>;
  auto kernel = flash_fwd_kernel<T, DH>;
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
        (const T*)q, (const T*)k, (const T*)v, (T*)o, h, hkv, s, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int b, int h, int hkv, int s, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, b, h, hkv, s, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, h, hkv, s, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, h, hkv, s, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, h, hkv, s, st, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, h, hkv, s, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, S, Dh), k and v (B, Hkv, S, Dh) with element strides
// (qsb, qsh, qss), (ksb, ksh, kss), (vsb, vsh, vss) and Dh contiguous; o a
// contiguous (B, H, S, Dh).  dtype: 0 float32, 1 bfloat16 (all four share
// it).  Dh in {16, 32, 64, 128, 256}; H a multiple of Hkv; every row
// 16-byte aligned (the wrapper checks all of it).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int b, int h, int hkv,
                                   int s, int dh, long long qsb, long long qsh,
                                   long long qss, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh,
                                   long long vss, float scale, int causal,
                                   void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, o, b, h, hkv, s, st, scale, causal, cs);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, b, h, hkv, s, st, scale,
                                    causal, cs);
  return (int)cudaErrorInvalidValue;
}
