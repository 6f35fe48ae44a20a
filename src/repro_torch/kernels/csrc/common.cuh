// Device code shared by fused_agg.cu, aggregate.cu and quantize.cu: the
// total weight of an aggregation and the int8 wire format's arithmetic.
// Each is defined once here, so every kernel that aggregates or quantises
// adds the weights and rounds a code alike, bit for bit.
//
//   scale = max(absmax, 1e-12) / 127          (IEEE division)
//   code  = (int8) clip(rint(v / scale), -127, 127)   (half to even)
//
// Non-finite values quantise as the reference's do (`jnp.max`, then an
// int8 cast of a NaN quotient): a NaN anywhere in a tile makes its absmax
// and scale NaN and every code 0; a tile that holds +-Inf has scale Inf,
// and a code 0 at every lane (finite / Inf is 0, Inf / Inf is NaN). So the
// absmax propagates NaN (`max_nan`, where `fmaxf` would drop it) and a NaN
// quotient is code 0 (where `fmaxf`/`fminf` would clamp it to -127).
// Finite values take the same codes and scales as with `fmaxf`.
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

// The larger of a and b, NaN if either is NaN (PTX `max.NaN`, sm_80 on).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Largest of the block's `v` (NaN if any is), in every thread of a block
// of `threads` (a multiple of 32, at most MAX_THREADS). Its shared memory
// is reused by the next call: the block synchronises between two calls.
template <int MAX_THREADS>
__device__ __forceinline__ float block_absmax(float v,
                                              int threads = MAX_THREADS) {
  __shared__ float warp_max[MAX_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = warp_max[0];
  for (int i = 1; i < threads / 32; ++i) r = max_nan(r, warp_max[i]);
  return r;
}

__device__ __forceinline__ float tile_scale(float absmax) {
  return __fdiv_rn(max_nan(absmax, 1e-12f), 127.0f);
}

__device__ __forceinline__ signed char quantize_lane(float v, float scale) {
  float q = rintf(__fdiv_rn(v, scale));
  if (isnan(q)) return 0;
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (signed char)(int)q;
}

__host__ __device__ inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}
