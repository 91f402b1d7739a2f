// Design variants of the one-read rmsnorm backward, timed on the card
// beside the kernel the port ships (`rmsnorm_bwd_one_read`) and the
// two-sweep kernel, each variant's dx held to the shipped kernel's bit for
// bit (dw sums in another order where the rows a block owns differ).  The
// variants vary the rows a step (R), whether a block owns a contiguous
// range of rows or every 264th row, the ring's stages (S: S - 1 rows in
// flight ahead) and the grid (264 or 132 blocks).  Random data; the dw fold
// (`rmsnorm_dw_kernel`) is timed with each.  Prints one JSON line a (shape,
// variant).
//
// Build and run on a machine with the card: tools/run_kernel_variants.sh
#include <cstdio>
#include <vector>
#include <algorithm>
#include <random>
#include "../src/repro_torch/kernels/csrc/rmsnorm.cu"

namespace var {
constexpr int MAXT = 512;
__device__ __forceinline__ void cpa(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
template <int N> __device__ __forceinline__ void cpw() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <typename T, int R, bool STRIDED, int S>
__global__ void __launch_bounds__(MAXT, 2)
kern(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
     T* __restrict__ dx, float* __restrict__ partial, long long rows, float eps) {
  constexpr int V = pack::Width<T>::N;
  constexpr int P = 8 / V;
  extern __shared__ uint4 ring[];
  __shared__ float4 red[2][MAXT / 32];
  const int nt = blockDim.x, d = 8 * nt, t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = nt >> 5;
  long long r0; int n; long long stride;
  if (STRIDED) { r0 = blockIdx.x; stride = gridDim.x; n = (int)((rows - 1 - blockIdx.x) / gridDim.x + 1); }
  else { r0 = (long long)blockIdx.x * rows / gridDim.x; stride = 1; n = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x - r0); }
  auto slot = [&](int s, int r, int k, int p) -> uint4* { return ring + (((s * R + r) * 2 + k) * P + p) * nt + t; };
  auto issue = [&](int i, int s) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i * R + r < n) {
        const long long off = (r0 + (long long)(i * R + r) * stride) * d;
#pragma unroll
        for (int p = 0; p < P; ++p) { const int c = (t + nt * p) * V; cpa(slot(s, r, 0, p), x + off + c); cpa(slot(s, r, 1, p), dy + off + c); }
      }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s, s);
  uint4 wr[P];
#pragma unroll
  for (int p = 0; p < P; ++p) wr[p] = *reinterpret_cast<const uint4*>(w + (t + nt * p) * V);
  float acc[P * V];
#pragma unroll
  for (int j = 0; j < P * V; ++j) acc[j] = 0.f;
  int s = 0;
  for (int i = 0; i * R < n; ++i) {
    cpw<S - 2>();
    uint4 xa[R][P], ga[R][P];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < P; ++p) { xa[r][p] = *slot(s, r, 0, p); ga[r][p] = *slot(s, r, 1, p); }
    issue(i + S - 1, s == 0 ? S - 1 : s - 1);
    float sum[2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float a[V], g[V], h[V];
        pack::unpack16<T>(xa[r][p], a); pack::unpack16<T>(ga[r][p], g); pack::unpack16<T>(wr[p], h);
#pragma unroll
        for (int j = 0; j < V; ++j) { ss = fmaf(a[j], a[j], ss); dot = fmaf(g[j] * h[j], a[j], dot); }
      }
      sum[2 * r] = ss; sum[2 * r + 1] = dot;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < 2 * R; ++j) sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
    float4* rb = red[i & 1];
    if (lane == 0) { float4 v = make_float4(sum[0], sum[1], 0.f, 0.f); if constexpr (R > 1) { v.z = sum[2]; v.w = sum[3]; } rb[warp] = v; }
    __syncthreads();
    float tot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < warps; ++k) { const float4 v = rb[k]; tot[0] += v.x; tot[1] += v.y; if constexpr (R > 1) { tot[2] += v.z; tot[3] += v.w; } }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i * R + r >= n) break;
      const float rs = rsqrtf(tot[2 * r] / (float)d + eps);
      const float c3 = (rs * rs * rs) * (tot[2 * r + 1] / (float)d);
      T* orow = dx + (r0 + (long long)(i * R + r) * stride) * d;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float a[V], g[V], h[V], o[V];
        pack::unpack16<T>(xa[r][p], a); pack::unpack16<T>(ga[r][p], g); pack::unpack16<T>(wr[p], h);
#pragma unroll
        for (int j = 0; j < V; ++j) { o[j] = (g[j] * h[j]) * rs - a[j] * c3; acc[p * V + j] += g[j] * (a[j] * rs); }
        pack::store16(orow + (t + nt * p) * V, o);
      }
    }
    s = s == S - 1 ? 0 : s + 1;
  }
  cpw<0>();
  float* out = partial + (size_t)blockIdx.x * d;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < V; j += 4) pack::store16(out + (t + nt * p) * V + j, acc + p * V + j);
}

template <typename T, int R, bool STRIDED, int S>
int launch(const T* x, const T* w, const T* dy, T* dx, T* dw, float* partial, long long rows, int d, int blocks) {
  const int nt = d / 8;
  const int smem = S * R * 2 * (8 / pack::Width<T>::N) * nt * 16;
  cudaFuncSetAttribute(kern<T, R, STRIDED, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<T, R, STRIDED, S><<<blocks, nt, smem>>>(x, w, dy, dx, partial, rows, 1e-6f);
  rmsnorm_dw_kernel<T><<<(d + 31) / 32, 32 * RED_WARPS>>>(partial, dw, blocks, d);
  return (int)cudaGetLastError();
}
}  // namespace var

#define CK(e) do { cudaError_t _e = (e); if (_e != cudaSuccess) { printf("CUDA %s at %d\n", cudaGetErrorString(_e), __LINE__); exit(1);} } while (0)

template <typename T>
void shape(long long rows, int d, const char* tag) {
  std::mt19937 rng(3);
  std::normal_distribution<float> nd;
  std::vector<T> hx(rows * d), hg(rows * d), hw(d);
  for (auto& v : hx) v = T(nd(rng));
  for (auto& v : hg) v = T(nd(rng));
  for (auto& v : hw) v = T(nd(rng));
  T *x, *g, *w, *dx, *dw, *dx0; float* part;
  const size_t bytes = rows * d * sizeof(T);
  CK(cudaMalloc(&x, bytes)); CK(cudaMalloc(&g, bytes)); CK(cudaMalloc(&dx, bytes)); CK(cudaMalloc(&dx0, bytes));
  CK(cudaMalloc(&w, d * sizeof(T))); CK(cudaMalloc(&dw, d * sizeof(T)));
  CK(cudaMalloc(&part, 1024 * (size_t)d * 4));
  CK(cudaMemcpy(x, hx.data(), bytes, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(g, hg.data(), bytes, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(w, hw.data(), d * sizeof(T), cudaMemcpyHostToDevice));
  const int dtype = sizeof(T) == 4 ? 0 : 1;
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  const int blocks = 264;
  CK((cudaError_t)rmsnorm_bwd_one_read(x, w, g, dx0, dw, part, dtype, rows, d, 1e-6f, blocks, 0));
  CK(cudaDeviceSynchronize());
  std::vector<char> h0(bytes), h1(bytes);
  CK(cudaMemcpy(h0.data(), dx0, bytes, cudaMemcpyDeviceToHost));
  auto run = [&](const char* name, auto fn) {
    CK((cudaError_t)fn()); CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(h1.data(), dx, bytes, cudaMemcpyDeviceToHost));
    const bool same = h0 == h1;
    std::vector<float> ts;
    for (int rep = 0; rep < 5; ++rep) {
      cudaEventRecord(a);
      for (int l = 0; l < 20; ++l) fn();
      cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b); ts.push_back(ms / 20);
    }
    std::sort(ts.begin(), ts.end());
    const double bound = (3.0 * bytes + 2 * d * sizeof(T)) / 3.35e12 * 1e3;
    printf("{\"tool\": \"rmsnorm_bwd_variants\", \"shape\": [%lld, %d], \"dtype\": \"%s\", \"variant\": \"%s\", \"ms\": %.5f, \"share_of_bound\": %.3f, \"dx_eq_shipped\": %s}\n",
           rows, d, tag, name, ts[2], bound / ts[2], same ? "true" : "false");
  };
  run("shipped", [&] { return rmsnorm_bwd_one_read(x, w, g, dx, dw, part, dtype, rows, d, 1e-6f, blocks, 0); });
  run("two sweeps", [&] { return rmsnorm_bwd(x, w, g, dx, dw, part, dtype, rows, d, 1e-6f, 1, 4, 512, 0); });
  run("R1 contiguous S3", [&] { return var::launch<T, 1, false, 3>(x, w, g, dx, dw, part, rows, d, blocks); });
  run("R1 strided S2", [&] { return var::launch<T, 1, true, 2>(x, w, g, dx, dw, part, rows, d, blocks); });
  run("R1 strided S3", [&] { return var::launch<T, 1, true, 3>(x, w, g, dx, dw, part, rows, d, blocks); });
  run("R1 strided S4", [&] { return var::launch<T, 1, true, 4>(x, w, g, dx, dw, part, rows, d, blocks); });
  if (sizeof(T) == 2) {
    run("R2 contiguous S3", [&] { return var::launch<T, 2, false, 3>(x, w, g, dx, dw, part, rows, d, blocks); });
    run("R2 strided S3", [&] { return var::launch<T, 2, true, 3>(x, w, g, dx, dw, part, rows, d, blocks); });
  }
  run("R1 strided S3, 132 blocks", [&] { return var::launch<T, 1, true, 3>(x, w, g, dx, dw, part, rows, d, 132); });
  cudaFree(x); cudaFree(g); cudaFree(dx); cudaFree(dx0); cudaFree(w); cudaFree(dw); cudaFree(part);
}

int main() {
  shape<__nv_bfloat16>(16384, 2048, "bf16");
  shape<__nv_bfloat16>(16384, 2560, "bf16");
  shape<__nv_bfloat16>(16384, 3584, "bf16");
  shape<__nv_bfloat16>(16384, 4096, "bf16");
  shape<float>(16384, 2048, "f32");
  return 0;
}
