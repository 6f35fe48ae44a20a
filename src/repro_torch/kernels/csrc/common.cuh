// Device code shared by fused_agg.cu, aggregate.cu and quantize.cu: the
// total weight of an aggregation and the int8 wire format's arithmetic.
// Each is defined once here, so every kernel that aggregates or quantises
// adds the weights and rounds a code alike, bit for bit.
//
//   scale = max(absmax, 1e-12) / 127          (IEEE division)
//   code  = (int8) clip(rint(v / scale), -127, 127)   (half to even)
//
// `kernels/build.py` keys each library by its source and every header in
// this directory, so an edit here rebuilds every library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Sum of the P weights, in row order, the same in every thread.
__device__ __forceinline__ float total_weight(const float* __restrict__ w,
                                              int P) {
  float total = 0.0f;
  for (int p = 0; p < P; ++p) total = __fadd_rn(total, __ldg(w + p));
  return total;
}

// Largest of the block's `v`, in every thread of a block of THREADS.
template <int THREADS>
__device__ __forceinline__ float block_absmax(float v) {
  __shared__ float warp_max[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = warp_max[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) r = fmaxf(r, warp_max[i]);
  return r;
}

__device__ __forceinline__ float tile_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-12f), 127.0f);
}

__device__ __forceinline__ signed char quantize_lane(float v, float scale) {
  float q = rintf(__fdiv_rn(v, scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (signed char)(int)q;
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}
