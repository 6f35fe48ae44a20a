// Whole-model one-pass aggregation kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the reference package's
// kernels/fused.py: `_agg_kernel` (entry `aggregate_flat_onepass`) and
// `_agg_quant_kernel` (entry `aggregate_quantize_flat`).
//
//   mean[n]  = (sum_p w[p] * x[p, n]) / (sum_p w[p])      x: (P, N) fp32
//              rounded half-to-even where int_mask[n] != 0
//   per 16384-lane subtile (fused_agg_quant only):
//   scale    = max(absmax(mean), 1e-12) / 127
//   codes[n] = (int8) clip(rint(mean[n] / scale), -127, 127)
//
// What bounds it on this card: bytes. The work is a stream: (P+1)*N words
// read, N written (plus N bytes and N/16384 words for the quantised form),
// with P multiply-adds per lane; the floor is bytes / HBM bandwidth. At the
// session's shape (P <= sample size, N = 136,672) the whole stack is a few
// MB, sits in L2, and the launch itself dominates.
//
// What the design does about it: every lane is independent, so a grid over
// lanes with 16-byte loads (4 lanes a thread, neighbouring threads on
// neighbouring addresses) streams each row once and nothing is staged in
// shared memory. The quantised form needs one reduction per subtile, so it
// runs one block per subtile: each thread keeps its means in registers (64
// at 256 threads, 16 at 1024), the block reduces absmax by warp shuffles
// and one shared-memory step, and every thread quantises its own registers:
// the mean is written once and never read back.
//
// Bit-exactness: both kernels (and the masked variants that follow them)
// share `weighted_mean_lane`, so their means are equal bit for bit and do
// not depend on the grid. Rows are added in row order with an explicit
// fused multiply-add, the total weight is added in row order by every
// thread alike, both divisions are IEEE (`__fdiv_rn`), rounding is `rintf`
// (half to even, never `roundf`). Build without -use_fast_math.
//
// Plain C interface for ctypes: each launcher enqueues on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSubtile = 16384;               // quantisation granularity
constexpr int kThreads = 256;                 // mean-only kernel
// The quantised kernel runs one block per subtile in one of two widths:
// 256 threads (64 means a thread) when there are subtiles enough to fill
// the card, 1024 threads (16 a thread) when there are few, so that a small
// model still has loads in flight. Results do not depend on the width.
constexpr int kQuantThreadsWide = 1024;
constexpr int kQuantThreads = 256;
constexpr int kFewSubtiles = 264;             // fewer blocks than 2 per SM

__device__ __forceinline__ float total_weight(const float* __restrict__ w,
                                              int P) {
  float total = 0.0f;
  for (int p = 0; p < P; ++p) total = __fadd_rn(total, __ldg(w + p));
  return total;
}

// The one definition of the mean of a lane: shared by every kernel here.
__device__ __forceinline__ float finish_lane(float acc, float total,
                                             bool is_int) {
  float mean = __fdiv_rn(acc, total);
  return is_int ? rintf(mean) : mean;
}

__device__ __forceinline__ float weighted_mean_lane(
    const float* __restrict__ x, const float* __restrict__ w,
    const unsigned char* __restrict__ mask, int P, long long N,
    long long lane, float total) {
  float acc = 0.0f;
#pragma unroll 4
  for (int p = 0; p < P; ++p)
    acc = __fmaf_rn(__ldg(w + p), __ldg(x + (long long)p * N + lane), acc);
  return finish_lane(acc, total, mask != nullptr && mask[lane] != 0);
}

// Four consecutive lanes through 16-byte loads; lane % 4 == 0, N % 4 == 0
// and 16-byte aligned rows are the launcher's to guarantee. Per lane the
// arithmetic is that of weighted_mean_lane, in the same order.
__device__ __forceinline__ float4 weighted_mean_lane4(
    const float* __restrict__ x, const float* __restrict__ w,
    const unsigned char* __restrict__ mask, int P, long long N,
    long long lane, float total) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    const float wp = __ldg(w + p);
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(x + (long long)p * N + lane));
    acc.x = __fmaf_rn(wp, v.x, acc.x);
    acc.y = __fmaf_rn(wp, v.y, acc.y);
    acc.z = __fmaf_rn(wp, v.z, acc.z);
    acc.w = __fmaf_rn(wp, v.w, acc.w);
  }
  uchar4 m = make_uchar4(0, 0, 0, 0);
  if (mask != nullptr) m = *reinterpret_cast<const uchar4*>(mask + lane);
  float4 out;
  out.x = finish_lane(acc.x, total, m.x != 0);
  out.y = finish_lane(acc.y, total, m.y != 0);
  out.z = finish_lane(acc.z, total, m.z != 0);
  out.w = finish_lane(acc.w, total, m.w != 0);
  return out;
}

// ---------------------------------------------------------------- mean only

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int P, long long N) {
  const float total = total_weight(w, P);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (VEC) {
    const long long lane = t * 4;
    if (lane < N) {
      *reinterpret_cast<float4*>(out + lane) =
          weighted_mean_lane4(x, w, mask, P, N, lane, total);
    }
  } else {
    if (t < N) out[t] = weighted_mean_lane(x, w, mask, P, N, t, total);
  }
}

// ------------------------------------------------------- mean + int8 codes

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

__device__ __forceinline__ signed char quantize_lane(float mean, float scale) {
  float q = rintf(__fdiv_rn(mean, scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (signed char)(int)q;
}

// One block per subtile. Lanes at or beyond N (the ragged last subtile)
// count as exact zeros for absmax and are never read or written.
template <bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
fused_agg_quant_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ mean_out,
                       signed char* __restrict__ codes,
                       float* __restrict__ scales, int P, long long N) {
  const float total = total_weight(w, P);
  constexpr int kPerThread = kSubtile / THREADS;
  const long long base = (long long)blockIdx.x * kSubtile;
  float m[kPerThread];
  float amax = 0.0f;

  if (VEC) {
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      const long long lane = base + ((long long)j * THREADS + threadIdx.x) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lane < N) {
        v = weighted_mean_lane4(x, w, mask, P, N, lane, total);
        *reinterpret_cast<float4*>(mean_out + lane) = v;
      }
      m[4 * j + 0] = v.x;
      m[4 * j + 1] = v.y;
      m[4 * j + 2] = v.z;
      m[4 * j + 3] = v.w;
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long lane = base + (long long)i * THREADS + threadIdx.x;
      float v = 0.0f;
      if (lane < N) {
        v = weighted_mean_lane(x, w, mask, P, N, lane, total);
        mean_out[lane] = v;
      }
      m[i] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }

  amax = block_absmax<THREADS>(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;

  if (VEC) {
#pragma unroll
    for (int j = 0; j < kPerThread / 4; ++j) {
      const long long lane = base + ((long long)j * THREADS + threadIdx.x) * 4;
      if (lane < N) {
        char4 q;
        q.x = quantize_lane(m[4 * j + 0], scale);
        q.y = quantize_lane(m[4 * j + 1], scale);
        q.z = quantize_lane(m[4 * j + 2], scale);
        q.w = quantize_lane(m[4 * j + 3], scale);
        *reinterpret_cast<char4*>(codes + lane) = q;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long lane = base + (long long)i * THREADS + threadIdx.x;
      if (lane < N) codes[lane] = quantize_lane(m[i], scale);
    }
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

}  // namespace

extern "C" {

int fused_agg_launch(const float* x, const float* w,
                     const unsigned char* mask, float* out, int P,
                     long long N, void* stream) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (N % 4 == 0) && aligned(x, 16) && aligned(out, 16) &&
                   (mask == nullptr || aligned(mask, 4));
  if (vec) {
    const long long blocks = (N / 4 + kThreads - 1) / kThreads;
    fused_agg_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, w, mask, out, P, N);
  } else {
    const long long blocks = (N + kThreads - 1) / kThreads;
    fused_agg_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, w, mask, out, P, N);
  }
  return (int)cudaGetLastError();
}

int fused_agg_quant_launch(const float* x, const float* w,
                           const unsigned char* mask, float* mean,
                           signed char* codes, float* scales, int P,
                           long long N, void* stream) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (N + kSubtile - 1) / kSubtile;
  const bool vec = (N % 4 == 0) && aligned(x, 16) && aligned(mean, 16) &&
                   aligned(codes, 4) &&
                   (mask == nullptr || aligned(mask, 4));
  const bool wide = blocks < kFewSubtiles;
  const unsigned g = (unsigned)blocks;
  if (vec && wide) {
    fused_agg_quant_kernel<true, kQuantThreadsWide>
        <<<g, kQuantThreadsWide, 0, s>>>(x, w, mask, mean, codes, scales, P, N);
  } else if (vec) {
    fused_agg_quant_kernel<true, kQuantThreads>
        <<<g, kQuantThreads, 0, s>>>(x, w, mask, mean, codes, scales, P, N);
  } else if (wide) {
    fused_agg_quant_kernel<false, kQuantThreadsWide>
        <<<g, kQuantThreadsWide, 0, s>>>(x, w, mask, mean, codes, scales, P, N);
  } else {
    fused_agg_quant_kernel<false, kQuantThreads>
        <<<g, kQuantThreads, 0, s>>>(x, w, mask, mean, codes, scales, P, N);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
