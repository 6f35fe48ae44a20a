// Per-leaf weighted multi-model aggregation for Hopper (sm_90a).
//
// Replaces the reference package's Pallas kernel `_agg_kernel`
// (src/repro/kernels/aggregate.py, entry `aggregate_tiles`): the per-leaf
// path of `aggregate_flat` / `aggregate_pytree`.
//
//   out[n] = (sum_p w[p] * x[p, n]) / (sum_p w[p])     x: (P, N), w: (P,)
//
// x is fp32 or bf16 and out has x's type; w and every sum are fp32. There
// is no integer mask here: `aggregate_pytree` sends integer leaves through
// as fp32 and rounds them afterwards, as the reference does.
//
// What bounds it on this card: bytes. Each lane reads P elements and one
// is written, with P multiply-adds, so the floor is
// (P + 1) * N * sizeof(x) / HBM bandwidth; at TinyLlama's embedding leaf
// (P = 4, N = 65,536,000, bf16) that is 655 MB, 0.196 ms at 3.35 TB/s.
//
// What the design does about it: every lane is independent, so a grid over
// lanes in which each thread owns one 16-byte chunk of every row (4 fp32
// lanes, or 8 bf16 lanes), neighbouring threads on neighbouring chunks,
// streams each row once with 16-byte loads; nothing is staged in shared
// memory. The reference's TILE (16384 lanes) is a TPU block size and plays
// no part in the result, so the kernel takes any N: the tail is masked and
// the wrapper makes no padded copy of the stack. A chunk that the 16-byte
// path cannot take (N not a multiple of the chunk, or a row not 16-byte
// aligned) sends the whole launch to the one-lane-a-thread form.
//
// Exactness: rows are added in row order with an explicit fused
// multiply-add, the total weight is added in row order by every thread
// alike, the division is IEEE (`__fdiv_rn`), and bf16 is stored by
// round-to-nearest-even (`__float2bfloat16_rn`). Build without
// -use_fast_math.
//
// Plain C interface for ctypes: the launcher enqueues on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
           T* __restrict__ out, int P, long long N) {
  const float total = total_weight(w, P);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (VEC) {
    constexpr int V = Chunk<T>::V;
    const long long lane = t * V;
    if (lane >= N) return;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float wp = __ldg(w + p);
      float v[V];
      Chunk<T>::load(x + (long long)p * N + lane, v);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fmaf_rn(wp, v[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fdiv_rn(acc[e], total);
    Chunk<T>::store(out + lane, acc);
  } else {
    if (t >= N) return;
    float acc = 0.0f;
    for (int p = 0; p < P; ++p)
      acc = __fmaf_rn(__ldg(w + p), to_f32(x[(long long)p * N + t]), acc);
    out[t] = from_f32<T>(__fdiv_rn(acc, total));
  }
}

template <typename T>
int launch(const void* xv, const float* w, void* outv, int P, long long N,
           cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  constexpr int V = Chunk<T>::V;
  // row p starts at x + p*N: N % V == 0 keeps every row 16-byte aligned
  const bool vec = (N % V == 0) && aligned(x, 16) && aligned(out, 16);
  if (vec) {
    const long long blocks = (N / V + kThreads - 1) / kThreads;
    agg_kernel<T, true><<<(unsigned)blocks, kThreads, 0, s>>>(x, w, out, P,
                                                              N);
  } else {
    const long long blocks = (N + kThreads - 1) / kThreads;
    agg_kernel<T, false><<<(unsigned)blocks, kThreads, 0, s>>>(x, w, out, P,
                                                               N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x and out); w is fp32 (P,).
int aggregate_launch(const void* x, const float* w, void* out, int dtype,
                     int P, long long N, void* stream) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, P, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, P, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
