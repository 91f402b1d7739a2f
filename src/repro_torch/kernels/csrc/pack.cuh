// 16-byte loads and stores between f32, bf16 or f16 memory and f32
// registers,
// shared by the language-model kernels (rmsnorm.cu, swiglu.cu,
// flash_attention.cu).  A 16-byte access is the widest one a thread can make
// and keeps neighbouring threads on neighbouring addresses.  Callers check
// the 16-byte alignment of every address they pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace pack {

// Elements of T in 16 bytes.
template <typename T>
struct Width {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
// Round to nearest even, as torch's and XLA's casts to bf16 do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// Round to nearest even, as torch's cast to f16 does.
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes held in registers (4 f32, or 8 bf16 or f16) as floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& raw,
                                                        float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <>
__device__ __forceinline__ void unpack16<__half>(const uint4& raw, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 16 bytes at p (4 f32, or 8 bf16 or f16) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  unpack16<T>(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store16(__half* p, const float* f) {
  uint4 raw;
  __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 8 consecutive f32 elements at p (32 bytes) as floats.
__device__ __forceinline__ void load8(const float* p, float* f) {
  load16(p, f);
  load16(p + 4, f + 4);
}

}  // namespace pack
