// Design variants of the nearest-center kernel's wide tile (D >= 64),
// timed on the card beside the kernel the port ships (`assign_tile::launch`)
// and the generic tile, each held to the shipped kernel's output bit for
// bit.  The variants keep the shipped lane layout (4 row groups x 8 center
// groups, a 4 x 2 register tile a lane) and vary the block's tile (16 x 32
// on two warps, as shipped; 32 x 32 on four warps; 16 x 64 on four; 32 x 16
// on two), the ring (stages x bytes of a row a stage), the cp.async cache
// policy, and whether the norms are chained at all ("no norms": timing
// only, its distances differ).  f32, random data, a mask with 30 % holes,
// count = K - 12.  Prints one JSON line a (shape, variant).
//
// Build and run on a machine with the card: tools/run_kernel_variants.sh
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "../src/repro_torch/kernels/csrc/assign_tile.cuh"

namespace var {
using assign_tile::active_count;
using assign_tile::combine;
using assign_tile::finish;
using assign_tile::lex_min;
using assign_tile::load4;
namespace fast = assign_tile::fast;

constexpr int RM = 4, RK = 2;   // a lane's register tile
constexpr int WM = 16, WK = 16; // a warp's tile: 4 x 8 lanes

template <int ROWS, int BK, int NS, int CB, int WC>
struct Smem {
  alignas(16) unsigned char ring[NS][ROWS + BK][CB + 16];
  float x2s[ROWS];
  float c2s[BK];
  float rd[WC][ROWS];
  int ri[WC][ROWS];
  int last;
};

// WR x WC warps, a WM x WK tile each; NS stages of CB bytes of a row; CG:
// cp.async.cg (else .ca); NORMS: chain the norms (else zeros).
template <int WR, int WC, int NS, int CB, bool CG, bool NORMS>
__global__ void __launch_bounds__(32 * WR * WC)
kern(const float* __restrict__ x, const float* __restrict__ c,
     const uint8_t* __restrict__ mask, const int* __restrict__ count,
     float* __restrict__ d2_out, int* __restrict__ idx_out,
     unsigned long long* keys, int* tickets, int n, int k, int d) {
  constexpr int NT = 32 * WR * WC;
  constexpr int ROWS = WR * WM, BK = WC * WK, SR = ROWS + BK;
  constexpr int RB = CB + 16, PR = CB / 16, STEPS = CB / 16;
  static_assert(SR <= NT, "a norm chain a staged row");
  __shared__ Smem<ROWS, BK, NS, CB, WC> s;
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = (tid >> 5) % WC, wr = (tid >> 5) / WC;
  const int rg = lane >> 3, cg = lane & 7;
  const int row0 = blockIdx.x * ROWS, split = blockIdx.y;
  const int n_split = gridDim.y;
  const int active = active_count(count, k);
  const int n_tiles = (active + BK - 1) / BK;
  const int mine = split < n_tiles ? (n_tiles - 1 - split) / n_split + 1 : 0;
  const int chunks = (d * 4 + CB - 1) / CB;
  const int steps = mine * chunks;
  const int norm_row = tid < BK ? ROWS + tid : (tid - BK) % ROWS;

  auto load_stage = [&](int st, int t, int ch) {
    const int q = tid % PR;
    const int e = ch * (CB / 4) + q * 4;
    const bool have = e < d;
    for (int r = tid / PR; r < SR; r += NT / PR) {
      const float* row;
      if (r < ROWS) {
        if (row0 + r >= n) continue;
        row = x + (size_t)(row0 + r) * d;
      } else {
        if (t * BK + r - ROWS >= active) continue;
        row = c + (size_t)(t * BK + r - ROWS) * d;
      }
      const unsigned sa = (unsigned)__cvta_generic_to_shared(&s.ring[st][r][q * 16]);
      if (CG)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                     "l"(have ? row + e : row), "r"(have ? 16 : 0));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                     "l"(have ? row + e : row), "r"(have ? 16 : 0));
    }
  };

  float bd[RM];
  int bi[RM];
  for (int i = 0; i < RM; ++i) {
    bd[i] = CUDART_INF_F;
    bi[i] = INT32_MAX;
  }
  for (int p = 0; p < NS - 1; ++p) {
    if (p < steps) load_stage(p, split + (p / chunks) * n_split, p % chunks);
    fast::cp_async_commit();
  }
  float acc[RM][RK];
  float nacc = 0.f;
  int j = 0, ch = 0;
  for (int it = 0; it < steps; ++it) {
    fast::cp_async_wait<NS - 2>();
    __syncthreads();
    const int nx = it + NS - 1;
    if (nx < steps) load_stage(nx % NS, split + (nx / chunks) * n_split, nx % chunks);
    fast::cp_async_commit();
    if (ch == 0) {
      for (int i = 0; i < RM; ++i)
        for (int q = 0; q < RK; ++q) acc[i][q] = 0.f;
      nacc = 0.f;
    }
    const int st = it % NS;
    const unsigned char* xr = &s.ring[st][wr * WM + rg][0];
    const unsigned char* cr = &s.ring[st][ROWS + WK * w + cg][0];
    const unsigned char* nr = &s.ring[st][norm_row][0];
#pragma unroll
    for (int g = 0; g < STEPS; ++g) {
      float4 a[RM], b[RK];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = load4(reinterpret_cast<const float*>(xr + 4 * i * RB + g * 16));
#pragma unroll
      for (int q = 0; q < RK; ++q) b[q] = load4(reinterpret_cast<const float*>(cr + 8 * q * RB + g * 16));
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int q = 0; q < RK; ++q) {
          acc[i][q] = fmaf(a[i].x, b[q].x, acc[i][q]);
          acc[i][q] = fmaf(a[i].y, b[q].y, acc[i][q]);
          acc[i][q] = fmaf(a[i].z, b[q].z, acc[i][q]);
          acc[i][q] = fmaf(a[i].w, b[q].w, acc[i][q]);
        }
      if (NORMS) {
        const float4 v = load4(reinterpret_cast<const float*>(nr + g * 16));
        nacc = fmaf(v.x, v.x, nacc);
        nacc = fmaf(v.y, v.y, nacc);
        nacc = fmaf(v.z, v.z, nacc);
        nacc = fmaf(v.w, v.w, nacc);
      }
    }
    if (++ch == chunks) {
      if (tid < BK) s.c2s[tid] = nacc;
      else if (tid < BK + ROWS && j == 0) s.x2s[tid - BK] = nacc;
      __syncthreads();
      const int k0 = (split + j * n_split) * BK;
      for (int q = 0; q < RK; ++q) {
        const int kc = WK * w + cg + 8 * q, gk = k0 + kc;
        const bool valid = gk < active && mask[gk] != 0;
        for (int i = 0; i < RM; ++i) {
          const float v = combine(s.x2s[wr * WM + rg + 4 * i], s.c2s[kc], acc[i][q]);
          lex_min(bd[i], bi[i], valid ? v : CUDART_INF_F, valid ? gk : INT32_MAX);
        }
      }
      ch = 0;
      ++j;
    }
  }
  fast::cp_async_wait<0>();
  for (int i = 0; i < RM; ++i) {
    for (int off = 1; off < 8; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      lex_min(bd[i], bi[i], od, oi);
    }
    if (cg == 0) {
      s.rd[w][wr * WM + rg + 4 * i] = bd[i];
      s.ri[w][wr * WM + rg + 4 * i] = bi[i];
    }
  }
  __syncthreads();
  if (tid < ROWS)
    for (int k2 = 1; k2 < WC; ++k2) lex_min(s.rd[0][tid], s.ri[0][tid], s.rd[k2][tid], s.ri[k2][tid]);
  finish<ROWS>(s.rd[0], s.ri[0], &s.last, d2_out, idx_out, keys, tickets, row0, n);
}
}  // namespace var

#define CK(e)                                                            \
  do {                                                                   \
    cudaError_t e_ = (e);                                                \
    if (e_ != cudaSuccess) {                                             \
      printf("CUDA %s at line %d\n", cudaGetErrorString(e_), __LINE__);  \
      exit(1);                                                           \
    }                                                                    \
  } while (0)

int main() {
  struct Shape { int n, k, d; };
  const std::vector<Shape> shapes = {
      {256, 512, 2048}, {2048, 512, 2048}, {256, 512, 4096}, {1000, 1000, 768}};
  std::mt19937 rng(1);
  std::normal_distribution<float> nd;
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  unsigned long long* keys;
  int* tickets;
  CK(cudaMalloc(&keys, 1 << 20));
  CK(cudaMemset(keys, 0xff, 1 << 20));
  CK(cudaMalloc(&tickets, 1 << 16));
  CK(cudaMemset(tickets, 0, 1 << 16));
  for (const Shape& sh : shapes) {
    const int n = sh.n, k = sh.k, d = sh.d;
    std::vector<float> hx((size_t)n * d), hc((size_t)k * d);
    for (float& v : hx) v = nd(rng);
    for (float& v : hc) v = nd(rng);
    std::vector<uint8_t> hm(k);
    for (uint8_t& m : hm) m = (rng() % 10) < 7;
    const int cnt = k - 12;
    float *x, *c, *d2;
    int *idx, *count;
    uint8_t* mask;
    CK(cudaMalloc(&x, hx.size() * 4));
    CK(cudaMalloc(&c, hc.size() * 4));
    CK(cudaMalloc(&d2, n * 4));
    CK(cudaMalloc(&idx, n * 4));
    CK(cudaMalloc(&count, 4));
    CK(cudaMalloc(&mask, k));
    CK(cudaMemcpy(x, hx.data(), hx.size() * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(c, hc.data(), hc.size() * 4, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(mask, hm.data(), k, cudaMemcpyHostToDevice));
    CK(cudaMemcpy(count, &cnt, 4, cudaMemcpyHostToDevice));
    // the wrapper's split rules (`dpmeans_assign._split`) at 132 SMs
    auto split = [&](int rows, int bk, int per_sm, int min_tiles) {
      const int rb = (n + rows - 1) / rows, tiles = (k + bk - 1) / bk;
      return std::max(1, std::min((per_sm * 132 + rb - 1) / rb, tiles / min_tiles));
    };
    std::vector<float> rd0(n), rd(n);
    std::vector<int> ri0(n), ri(n);
    auto run = [&](const char* name, auto fn) {
      fn();
      CK(cudaDeviceSynchronize());
      CK(cudaGetLastError());
      CK(cudaMemcpy(rd.data(), d2, n * 4, cudaMemcpyDeviceToHost));
      CK(cudaMemcpy(ri.data(), idx, n * 4, cudaMemcpyDeviceToHost));
      const bool same = !memcmp(rd.data(), rd0.data(), n * 4) &&
                        !memcmp(ri.data(), ri0.data(), n * 4);
      std::vector<float> ts;
      for (int rep = 0; rep < 5; ++rep) {
        CK(cudaEventRecord(a));
        for (int l = 0; l < 20; ++l) fn();
        CK(cudaEventRecord(b));
        CK(cudaEventSynchronize(b));
        float ms;
        CK(cudaEventElapsedTime(&ms, a, b));
        ts.push_back(ms / 20);
      }
      std::sort(ts.begin(), ts.end());
      printf("{\"tool\": \"assign_wide_variants\", \"n\": %d, \"k\": %d, \"d\": %d, "
             "\"variant\": \"%s\", \"ms\": %.5f, \"bitwise_eq_shipped\": %s}\n",
             n, k, d, name, ts[2], same ? "true" : "false");
    };
    const int S = split(16, 32, 4, 1);
    assign_tile::launch(x, c, mask, count, d2, idx, keys, tickets, n, k, d, S, 0);
    CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(rd0.data(), d2, n * 4, cudaMemcpyDeviceToHost));
    CK(cudaMemcpy(ri0.data(), idx, n * 4, cudaMemcpyDeviceToHost));
    run("shipped: 16x32, 2 warps, 3 x 256 B ring", [&] {
      assign_tile::launch(x, c, mask, count, d2, idx, keys, tickets, n, k, d, S, 0);
    });
    const int Sg = split(64, 64, 2, 2);
    run("generic 64x64 tile", [&] {
      assign_tile::launch(x, c, mask, count, d2, idx, keys, tickets, n, k, d, Sg, 0, true);
    });
#define V(NAME, WR, WC, NS, CB, CG, NORMS, PER)                                 \
  {                                                                             \
    constexpr int rows = WR * var::WM, bk = WC * var::WK;                       \
    const dim3 grid((n + rows - 1) / rows, split(rows, bk, PER, 1));            \
    run(NAME, [&] {                                                             \
      var::kern<WR, WC, NS, CB, CG, NORMS><<<grid, 32 * WR * WC>>>(             \
          x, c, mask, count, d2, idx, keys, tickets, n, k, d);                  \
    });                                                                         \
  }
    V("16x32, 2 warps, 4 x 128 B ring", 1, 2, 4, 128, true, true, 4);
    V("16x32, 2 warps, 3 x 256 B ring, cp.async.ca", 1, 2, 3, 256, false, true, 4);
    V("16x32, 2 warps, 3 x 256 B ring, no norms", 1, 2, 3, 256, true, false, 4);
    V("32x32, 4 warps, 3 x 128 B ring", 2, 2, 3, 128, true, true, 2);
    V("32x32, 4 warps, 2 x 256 B ring", 2, 2, 2, 256, true, true, 2);
    V("16x64, 4 warps, 3 x 128 B ring", 1, 4, 3, 128, true, true, 2);
    V("32x16, 2 warps, 3 x 256 B ring", 2, 1, 3, 256, true, true, 4);
#undef V
    CK(cudaFree(x));
    CK(cudaFree(c));
    CK(cudaFree(d2));
    CK(cudaFree(idx));
    CK(cudaFree(count));
    CK(cudaFree(mask));
  }
  return 0;
}
