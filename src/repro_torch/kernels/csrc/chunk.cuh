// Sixteen bytes of a row of fp32 or bf16, widened to fp32 and back, for the
// per-leaf kernels (aggregate.cu, quantize.cu). bf16 is widened exactly and
// stored by round-to-nearest-even (`__float2bfloat16_rn`).
//
// `kernels/build.py` keys each library by its source and every header in
// this directory, so an edit here rebuilds every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    union { uint4 u; __nv_bfloat162 h[4]; } a;
    a.u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(a.h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    union { uint4 u; __nv_bfloat16 h[8]; } a;
#pragma unroll
    for (int i = 0; i < 8; ++i) a.h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = a.u;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
