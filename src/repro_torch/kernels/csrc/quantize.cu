// Per-tile symmetric int8 quantisation and its inverse, for Hopper (sm_90a).
//
// Replaces the reference package's Pallas kernels `_quant_kernel` (entry
// `quantize_tiles`) and `_dequant_kernel` (entry `dequantize_tiles`) of
// src/repro/kernels/quantize.py: the compressed model push of
// `quantized_delta_push` / `quantized_delta_pull`.
//
//   per 16384-lane tile t of x (N,):
//   scale[t] = max(absmax(x[tile t]), 1e-12) / 127
//   codes[n] = (int8) clip(rint(x[n] / scale[t]), -127, 127)
//   dequant:  out[n] = (float) codes[n] * scale[n / 16384]   (in out's type)
//
// x is fp32 or bf16 (widened exactly to fp32); the dequantised output is
// fp32 or bf16. Lanes at or past N (a ragged last tile) count as exact
// zeros, so the result is that of the reference's wrapper, which pads x to
// a whole tile with zeros; here nothing is padded or copied.
//
// What bounds them on this card: bytes. Quantise reads N elements and
// writes N codes and N/16384 scales; dequantise reads N codes and writes N
// elements. At TinyLlama's embedding leaf (N = 65,536,000, fp32) each moves
// 328 MB: 0.098 ms at 3.35 TB/s. A handful of operations a lane.
//
// What the design does about it. Quantise needs the tile's absmax before
// its first code, so one block of 1024 threads takes one tile: every
// thread loads its 16 lanes with 16-byte loads (neighbouring threads on
// neighbouring chunks) into registers, the block reduces absmax by warp
// shuffles and one shared-memory step, and every thread quantises its own
// registers. The tile is read from device memory once. Dequantise is
// elementwise: each thread writes one 16-byte chunk of output (4 fp32 or 8
// bf16 lanes, never straddling a tile) from one 4- or 8-byte load of codes
// and its tile's scale, so the loads and the stores of a warp are both
// contiguous. Where the vector path cannot be taken (N not a multiple of
// the chunk, or a pointer not aligned), the launch goes to a
// one-lane-at-a-time form of the same arithmetic.
//
// Exactness: both divisions are IEEE (`__fdiv_rn`; PyTorch's and XLA's
// jitted `x / 127.0` is a reciprocal multiply, see ROADMAP C1), rounding is
// `rintf` (half to even, as jnp.round and torch.round), the product is one
// `__fmul_rn`, and bf16 is stored by round-to-nearest-even. A NaN or +-Inf
// lane quantises as the reference's does (common.cuh: the absmax keeps a
// NaN, a NaN quotient is code 0). Codes and scales equal the plain
// `quantize_ref` bit for bit, the dequantised values `dequantize_ref`'s.
// Build without -use_fast_math.
//
// Plain C interface for ctypes: each launcher enqueues on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "common.cuh"

namespace {

constexpr int kTile = 16384;                    // part of the wire format
constexpr int kQuantThreads = 1024;             // one block a tile
constexpr int kPerThread = kTile / kQuantThreads;
constexpr int kDequantThreads = 256;

// V codes (4 or 8) as one 4- or 8-byte store.
template <int V>
__device__ __forceinline__ void store_codes(signed char* p,
                                            const signed char* c);
template <>
__device__ __forceinline__ void store_codes<4>(signed char* p,
                                               const signed char* c) {
  *reinterpret_cast<char4*>(p) = make_char4(c[0], c[1], c[2], c[3]);
}
template <>
__device__ __forceinline__ void store_codes<8>(signed char* p,
                                               const signed char* c) {
  union { uint2 u; signed char b[8]; } a;
#pragma unroll
  for (int i = 0; i < 8; ++i) a.b[i] = c[i];
  *reinterpret_cast<uint2*>(p) = a.u;
}

// ------------------------------------------------------------- quantise

template <typename T, bool VEC>
__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const T* __restrict__ x, signed char* __restrict__ codes,
             float* __restrict__ scales, long long N) {
  const long long base = (long long)blockIdx.x * kTile;
  float v[kPerThread];
  float amax = 0.0f;
  if (VEC) {
    constexpr int V = Chunk<T>::V;
#pragma unroll
    for (int j = 0; j < kPerThread / V; ++j) {
      const long long lane =
          base + ((long long)j * kQuantThreads + threadIdx.x) * V;
      if (lane < N) {
        Chunk<T>::load(x + lane, v + j * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[j * V + e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) amax = max_nan(amax, fabsf(v[j * V + e]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long lane = base + (long long)i * kQuantThreads + threadIdx.x;
      v[i] = lane < N ? to_f32(x[lane]) : 0.0f;
      amax = max_nan(amax, fabsf(v[i]));
    }
  }

  amax = block_absmax<kQuantThreads>(amax);
  const float scale = tile_scale(amax);
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;

  if (VEC) {
    constexpr int V = Chunk<T>::V;
#pragma unroll
    for (int j = 0; j < kPerThread / V; ++j) {
      const long long lane =
          base + ((long long)j * kQuantThreads + threadIdx.x) * V;
      if (lane < N) {
        signed char c[V];
#pragma unroll
        for (int e = 0; e < V; ++e) c[e] = quantize_lane(v[j * V + e], scale);
        store_codes<V>(codes + lane, c);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long lane = base + (long long)i * kQuantThreads + threadIdx.x;
      if (lane < N) codes[lane] = quantize_lane(v[i], scale);
    }
  }
}

// ----------------------------------------------------------- dequantise

// V codes (4 or 8, the lanes of one 16-byte output chunk) in one load.
template <int V>
__device__ __forceinline__ void load_codes(const signed char* p, float* v);
template <>
__device__ __forceinline__ void load_codes<4>(const signed char* p,
                                              float* v) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  v[0] = (float)c.x; v[1] = (float)c.y; v[2] = (float)c.z; v[3] = (float)c.w;
}
template <>
__device__ __forceinline__ void load_codes<8>(const signed char* p,
                                              float* v) {
  union { uint2 u; signed char b[8]; } a;
  a.u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (float)a.b[i];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const signed char* __restrict__ codes,
               const float* __restrict__ scales, T* __restrict__ out,
               long long N) {
  const long long t = (long long)blockIdx.x * kDequantThreads + threadIdx.x;
  if (VEC) {
    constexpr int V = Chunk<T>::V;
    const long long lane = t * V;
    if (lane >= N) return;
    const float s = __ldg(scales + lane / kTile);   // V lanes, one tile
    float v[V];
    load_codes<V>(codes + lane, v);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __fmul_rn(v[e], s);
    Chunk<T>::store(out + lane, v);
  } else {
    if (t >= N) return;
    out[t] = from_f32<T>(__fmul_rn((float)codes[t], __ldg(scales + t / kTile)));
  }
}

template <typename T>
int launch_quant(const void* xv, signed char* codes, float* scales,
                 long long N, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  constexpr int V = Chunk<T>::V;
  const bool vec = (N % V == 0) && aligned(x, 16) && aligned(codes, V);
  const unsigned blocks = (unsigned)((N + kTile - 1) / kTile);
  if (vec)
    quant_kernel<T, true><<<blocks, kQuantThreads, 0, s>>>(x, codes, scales,
                                                           N);
  else
    quant_kernel<T, false><<<blocks, kQuantThreads, 0, s>>>(x, codes, scales,
                                                            N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequant(const signed char* codes, const float* scales, void* outv,
                   long long N, cudaStream_t s) {
  T* out = static_cast<T*>(outv);
  constexpr int V = Chunk<T>::V;
  const bool vec = (N % V == 0) && aligned(codes, V) && aligned(out, 16);
  if (vec) {
    const long long blocks = (N / V + kDequantThreads - 1) / kDequantThreads;
    dequant_kernel<T, true><<<(unsigned)blocks, kDequantThreads, 0, s>>>(
        codes, scales, out, N);
  } else {
    const long long blocks = (N + kDequantThreads - 1) / kDequantThreads;
    dequant_kernel<T, false><<<(unsigned)blocks, kDequantThreads, 0, s>>>(
        codes, scales, out, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x). codes: (N,) int8; scales: (ceil(N/16384),).
int quantize_launch(const void* x, int dtype, signed char* codes,
                    float* scales, long long N, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quant<float>(x, codes, scales, N, s);
  if (dtype == 1) return launch_quant<__nv_bfloat16>(x, codes, scales, N, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = fp32, 1 = bf16 (out). out: (N,).
int dequantize_launch(const signed char* codes, const float* scales,
                      void* out, int dtype, long long N, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dequant<float>(codes, scales, out, N, s);
  if (dtype == 1)
    return launch_dequant<__nv_bfloat16>(codes, scales, out, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
