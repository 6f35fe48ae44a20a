// Whole-model one-pass aggregation kernels for Hopper (sm_90a), plain and
// over rows sealed by secure aggregation.
//
// Replaces the Pallas kernels of the reference package's kernels/fused.py:
// `_agg_kernel` (entry `aggregate_flat_onepass`), `_agg_quant_kernel`
// (`aggregate_quantize_flat`), `_unmask_agg_kernel` (`unmask_aggregate_flat`),
// `_unmask_agg_quant_kernel` (`unmask_aggregate_quantize_flat`), and its
// jitted `apply_mask_flat` (the seal).
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
// Sealed rows (secure aggregation): a trainer seals its model by adding,
// in the uint32 ring, a mask word to each lane's fp32 bit pattern,
//
//   sealed[l] = bits[l] + sum_j sign_j * prg(seed_j, l)   (mod 2^32)
//
// with the lane index as the PRG's counter (`fused_mask_kernel`; unsealing
// is the same call with the signs negated, a -1 sign is 0xFFFFFFFF, ring
// negation by multiplication, no branch). The aggregator's kernels take
// the rows through `SealedRows`, which regenerates row p's mask from its R
// seeds and signs, subtracts it and reads the restored bits as fp32, and
// then run the plain kernels' code unchanged. What bounds them here is the
// PRG, not bytes: each lane of each row costs R words of ~18 integer
// operations (P*R*N words in all), against (P+1)*N words of traffic. The
// (P, R) seeds and signs are tiny and are staged in shared memory once per
// block. A sealed row is arbitrary bits (NaNs with payloads, subnormals),
// so it is read as uint32 and no float operation touches it before the
// mask is gone.
//
// Bit-exactness: every kernel here shares `weighted_mean_lane` (templated
// on how a row is read), so the means of all four aggregation kernels are
// equal bit for bit, masked or not, and do not depend on the grid. Rows are added in row order with an explicit
// fused multiply-add, the total weight is added in row order by every
// thread alike, both divisions are IEEE (`__fdiv_rn`), rounding is `rintf`
// (half to even, never `roundf`). Build without -use_fast_math.
//
// Plain C interface for ctypes: each launcher enqueues on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

// The one definition of the mean of a lane: shared by every kernel here.
__device__ __forceinline__ float finish_lane(float acc, float total,
                                             bool is_int) {
  float mean = __fdiv_rn(acc, total);
  return is_int ? rintf(mean) : mean;
}

// ------------------------------------------------------------ mask PRG
// Mirrors repro_torch.secureagg.prg.prg_word bit for bit; unsigned 32-bit
// arithmetic wraps mod 2^32 and its shifts are logical.

constexpr uint32_t kPrgMix1 = 0x7FEB352Du;
constexpr uint32_t kPrgMix2 = 0x846CA68Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kPrgMix1;
  x = (x ^ (x >> 15)) * kPrgMix2;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t prg_word(uint32_t seed, uint32_t ctr) {
  uint32_t x = ctr ^ (seed * kPrgMix1);
  x = mix32(x) + seed;
  return mix32(x);
}

// sum_j signs[j] * prg(seeds[j], ctr) mod 2^32 (seeds/signs in shared memory).
__device__ __forceinline__ uint32_t mask_word(const uint32_t* seeds,
                                              const uint32_t* signs, int R,
                                              uint32_t ctr) {
  uint32_t m = 0u;
  for (int j = 0; j < R; ++j) m += signs[j] * prg_word(seeds[j], ctr);
  return m;
}

// Copies n int64 seeds and signs into shared memory as uint32 (mod 2^32, so
// a -1 sign becomes 0xFFFFFFFF). Every thread of the block must call it.
__device__ __forceinline__ void stage_mask_terms(
    const long long* __restrict__ seeds, const long long* __restrict__ signs,
    int n, uint32_t* staged) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    staged[i] = (uint32_t)seeds[i];
    staged[n + i] = (uint32_t)signs[i];
  }
  __syncthreads();
}

// ------------------------------------------------------------- row access
// How the aggregation kernels read lane `lane` of row `p`. `bind` runs once
// at the top of a kernel, with every thread of the block, and returns the
// reader the kernel uses.

struct PlainRows {                  // x: (P, N) fp32
  const float* x;
  long long N;
  __device__ __forceinline__ PlainRows bind(uint32_t*, int) const {
    return *this;
  }
  __device__ __forceinline__ float row(int p, long long lane) const {
    return __ldg(x + (long long)p * N + lane);
  }
  __device__ __forceinline__ float4 row4(int p, long long lane) const {
    return __ldg(reinterpret_cast<const float4*>(x + (long long)p * N + lane));
  }
};

struct SealedRows {                 // y: (P, N) sealed bits; (P, R) terms
  const uint32_t* y;
  long long N;
  const long long* seeds;           // device memory, until bound
  const long long* signs;
  int R;
  const uint32_t* sd;               // shared memory, after bind
  const uint32_t* sg;

  __device__ __forceinline__ SealedRows bind(uint32_t* staged, int P) const {
    stage_mask_terms(seeds, signs, P * R, staged);
    SealedRows r = *this;
    r.sd = staged;
    r.sg = staged + P * R;
    return r;
  }
  __device__ __forceinline__ float unseal(int p, uint32_t bits,
                                          uint32_t ctr) const {
    return __uint_as_float(bits - mask_word(sd + p * R, sg + p * R, R, ctr));
  }
  __device__ __forceinline__ float row(int p, long long lane) const {
    return unseal(p, __ldg(y + (long long)p * N + lane), (uint32_t)lane);
  }
  __device__ __forceinline__ float4 row4(int p, long long lane) const {
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(y + (long long)p * N + lane));
    const uint32_t c = (uint32_t)lane;
    return make_float4(unseal(p, v.x, c), unseal(p, v.y, c + 1),
                       unseal(p, v.z, c + 2), unseal(p, v.w, c + 3));
  }
};

template <class Rows>
__device__ __forceinline__ float weighted_mean_lane(
    const Rows& rows, const float* __restrict__ w,
    const unsigned char* __restrict__ mask, int P, long long lane,
    float total) {
  float acc = 0.0f;
#pragma unroll 4
  for (int p = 0; p < P; ++p)
    acc = __fmaf_rn(__ldg(w + p), rows.row(p, lane), acc);
  return finish_lane(acc, total, mask != nullptr && mask[lane] != 0);
}

// Four consecutive lanes through 16-byte loads; lane % 4 == 0, N % 4 == 0
// and 16-byte aligned rows are the launcher's to guarantee. Per lane the
// arithmetic is that of weighted_mean_lane, in the same order.
template <class Rows>
__device__ __forceinline__ float4 weighted_mean_lane4(
    const Rows& rows, const float* __restrict__ w,
    const unsigned char* __restrict__ mask, int P, long long lane,
    float total) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    const float wp = __ldg(w + p);
    const float4 v = rows.row4(p, lane);
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

template <class Rows, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const Rows rows_arg, const float* __restrict__ w,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int P, long long N) {
  extern __shared__ uint32_t staged[];
  const Rows rows = rows_arg.bind(staged, P);
  const float total = total_weight(w, P);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (VEC) {
    const long long lane = t * 4;
    if (lane < N) {
      *reinterpret_cast<float4*>(out + lane) =
          weighted_mean_lane4(rows, w, mask, P, lane, total);
    }
  } else {
    if (t < N) out[t] = weighted_mean_lane(rows, w, mask, P, t, total);
  }
}

// ------------------------------------------------------- mean + int8 codes

// One block per subtile. Lanes at or beyond N (the ragged last subtile)
// count as exact zeros for absmax and are never read or written.
template <class Rows, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
fused_agg_quant_kernel(const Rows rows_arg, const float* __restrict__ w,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ mean_out,
                       signed char* __restrict__ codes,
                       float* __restrict__ scales, int P, long long N) {
  extern __shared__ uint32_t staged[];
  const Rows rows = rows_arg.bind(staged, P);
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
        v = weighted_mean_lane4(rows, w, mask, P, lane, total);
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
        v = weighted_mean_lane(rows, w, mask, P, lane, total);
        mean_out[lane] = v;
      }
      m[i] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }

  amax = block_absmax<THREADS>(amax);
  const float scale = tile_scale(amax);
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

// ------------------------------------------------------------------ seal

__global__ void __launch_bounds__(kThreads)
fused_mask_kernel(const uint32_t* __restrict__ x,
                  const long long* __restrict__ seeds,
                  const long long* __restrict__ signs, int R,
                  uint32_t* __restrict__ out, long long N) {
  extern __shared__ uint32_t staged[];
  stage_mask_terms(seeds, signs, R, staged);
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane < N)
    out[lane] = __ldg(x + lane) + mask_word(staged, staged + R, R,
                                            (uint32_t)lane);
}

// Shared memory for the staged (P, R) seeds and signs: two words a term.
inline size_t staged_bytes(int terms) { return 2 * sizeof(uint32_t) * terms; }

template <class Rows>
int launch_agg(const Rows& rows, const void* rows_ptr, const float* w,
               const unsigned char* mask, float* out, int P, long long N,
               size_t smem, cudaStream_t s) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (N % 4 == 0) && aligned(rows_ptr, 16) &&
                   aligned(out, 16) && (mask == nullptr || aligned(mask, 4));
  if (vec) {
    const long long blocks = (N / 4 + kThreads - 1) / kThreads;
    fused_agg_kernel<Rows, true><<<(unsigned)blocks, kThreads, smem, s>>>(
        rows, w, mask, out, P, N);
  } else {
    const long long blocks = (N + kThreads - 1) / kThreads;
    fused_agg_kernel<Rows, false><<<(unsigned)blocks, kThreads, smem, s>>>(
        rows, w, mask, out, P, N);
  }
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_agg_quant(const Rows& rows, const void* rows_ptr, const float* w,
                     const unsigned char* mask, float* mean,
                     signed char* codes, float* scales, int P, long long N,
                     size_t smem, cudaStream_t s) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + kSubtile - 1) / kSubtile;
  const bool vec = (N % 4 == 0) && aligned(rows_ptr, 16) &&
                   aligned(mean, 16) && aligned(codes, 4) &&
                   (mask == nullptr || aligned(mask, 4));
  const bool wide = blocks < kFewSubtiles;
  const unsigned g = (unsigned)blocks;
  if (vec && wide) {
    fused_agg_quant_kernel<Rows, true, kQuantThreadsWide>
        <<<g, kQuantThreadsWide, smem, s>>>(rows, w, mask, mean, codes,
                                            scales, P, N);
  } else if (vec) {
    fused_agg_quant_kernel<Rows, true, kQuantThreads>
        <<<g, kQuantThreads, smem, s>>>(rows, w, mask, mean, codes, scales,
                                        P, N);
  } else if (wide) {
    fused_agg_quant_kernel<Rows, false, kQuantThreadsWide>
        <<<g, kQuantThreadsWide, smem, s>>>(rows, w, mask, mean, codes,
                                            scales, P, N);
  } else {
    fused_agg_quant_kernel<Rows, false, kQuantThreads>
        <<<g, kQuantThreads, smem, s>>>(rows, w, mask, mean, codes, scales,
                                        P, N);
  }
  return (int)cudaGetLastError();
}

SealedRows sealed_rows(const uint32_t* y, long long N, const long long* seeds,
                       const long long* signs, int R) {
  return SealedRows{y, N, seeds, signs, R, nullptr, nullptr};
}

}  // namespace

extern "C" {

int fused_agg_launch(const float* x, const float* w,
                     const unsigned char* mask, float* out, int P,
                     long long N, void* stream) {
  return launch_agg(PlainRows{x, N}, x, w, mask, out, P, N, 0,
                    static_cast<cudaStream_t>(stream));
}

int fused_agg_quant_launch(const float* x, const float* w,
                           const unsigned char* mask, float* mean,
                           signed char* codes, float* scales, int P,
                           long long N, void* stream) {
  return launch_agg_quant(PlainRows{x, N}, x, w, mask, mean, codes, scales,
                          P, N, 0, static_cast<cudaStream_t>(stream));
}

int fused_mask_launch(const uint32_t* x, const long long* seeds,
                      const long long* signs, int R, uint32_t* out,
                      long long N, void* stream) {
  if (N <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + kThreads - 1) / kThreads;
  fused_mask_kernel<<<(unsigned)blocks, kThreads, staged_bytes(R),
                      static_cast<cudaStream_t>(stream)>>>(x, seeds, signs,
                                                           R, out, N);
  return (int)cudaGetLastError();
}

int fused_unmask_agg_launch(const uint32_t* y, const float* w,
                            const unsigned char* mask,
                            const long long* seeds, const long long* signs,
                            int R, float* out, int P, long long N,
                            void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  return launch_agg(sealed_rows(y, N, seeds, signs, R), y, w, mask, out, P,
                    N, staged_bytes(P * R), static_cast<cudaStream_t>(stream));
}

int fused_unmask_agg_quant_launch(const uint32_t* y, const float* w,
                                  const unsigned char* mask,
                                  const long long* seeds,
                                  const long long* signs, int R, float* mean,
                                  signed char* codes, float* scales, int P,
                                  long long N, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  return launch_agg_quant(sealed_rows(y, N, seeds, signs, R), y, w, mask,
                          mean, codes, scales, P, N, staged_bytes(P * R),
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
