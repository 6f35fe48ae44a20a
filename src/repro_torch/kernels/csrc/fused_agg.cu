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
// negation by multiplication, no branch). The aggregator reads the rows
// through `SealedRows`, which regenerates row p's mask from its R staged
// terms, subtracts it and reads the restored bits as fp32. What bounds the
// masked kernels is the PRG on the integer ALU pipe, not bytes: P*R*N words
// (R*N for the seal) of 11 ALU-pipe instructions each (see the PRG below),
// against (P+1)*N words of traffic. A sealed row is arbitrary bits (NaNs
// with payloads, subnormals), so it is read as uint32 and no float
// operation touches it before the mask is gone.
//
// What the design does about it: the seal takes one lane a thread. B4
// (unmask + mean) must fill the card at the sessions' shapes, where a
// model is 136,672 lanes (CNN) or 11,173 (MF): with lanes enough for every
// scheduler to hold 4 warps of one lane a thread, it runs B1's kernel over
// SealedRows with one lane a thread and a block size chosen so the blocks
// split evenly over the SMs (`lane_threads`); with fewer lanes, its rows
// are spread over warps too (`fused_unmask_rows_kernel`). B5 runs B2's
// kernel over SealedRows.
//
// Bit-exactness: every kernel adds rows with `mean_step` in row order from
// 0 and ends with `finish_lane`, and B1, B2, B5 and B4's larger form share
// `weighted_mean_lane` (templated on how a row is read), so the means of
// all the aggregation kernels are equal bit for bit, masked or not, and do
// not depend on the grid. The fused multiply-add is explicit, the total
// weight is added in row order by every thread alike, both divisions are
// IEEE (`__fdiv_rn`), rounding is `rintf` (half to even, never `roundf`).
// Build without -use_fast_math.
//
// Plain C interface for ctypes: each launcher enqueues on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSubtile = 16384;               // quantisation granularity
constexpr int kThreads = 256;                 // B1 and the seal
// The quantised kernel runs one block per subtile in one of two widths:
// 256 threads (64 means a thread) when there are subtiles enough to fill
// the card, 1024 threads (16 a thread) when there are few, so that a small
// model still has loads in flight. Results do not depend on the width.
constexpr int kQuantThreadsWide = 1024;
constexpr int kQuantThreads = 256;
constexpr int kFewSubtiles = 264;             // fewer blocks than 2 per SM

// The one definition of the mean of a lane, shared by every kernel here:
// rows are added by `mean_step` in row order from 0, then `finish_lane`.
__device__ __forceinline__ float mean_step(float acc, float w, float v) {
  return __fmaf_rn(w, v, acc);
}

__device__ __forceinline__ float finish_lane(float acc, float total,
                                             bool is_int) {
  float mean = __fdiv_rn(acc, total);
  return is_int ? rintf(mean) : mean;
}

// ------------------------------------------------------------ mask PRG
// Mirrors repro_torch.secureagg.prg.prg_word bit for bit,
//
//   prg(seed, ctr) = mix(mix(ctr ^ seed * kPrgMix1) + seed)
//   mix(x)         = xs16(xs15(xs16(x) * kPrgMix1) * kPrgMix2)
//   xsk(x)         = x ^ (x >> k)
//
// in unsigned 32-bit arithmetic (wraps mod 2^32, logical shifts), in the
// form the kernels run. A logical shift distributes over xor, so the first
// xs16 of ctr ^ sm (sm = seed * kPrgMix1) is xs16(ctr) ^ xs16(sm): a term
// is staged once with its `key` xs16(sm) beside its seed and sign (one
// 16-byte load), a lane computes its own key xs16(ctr) once for all its
// terms, and a word starts from one xor. In the SASS a word costs 11
// instructions on the integer ALU pipe (LOP3, SHF) and 6 on the FMA pipe
// (IMAD; ptxas puts the `+ seed` there too), against 14 and 7 unstaged.
// (Logical shifts taken as the high half of a product, IMAD.HI, to balance
// the two pipes made every masked kernel slower on the H100.)

constexpr uint32_t kPrgMix1 = 0x7FEB352Du;
constexpr uint32_t kPrgMix2 = 0x846CA68Bu;

struct __align__(16) MaskTerm {     // one (seed, sign) as the kernels use it
  uint32_t key;                     // xs16(seed * kPrgMix1)
  uint32_t seed;
  uint32_t sign;                    // +1, or 0xFFFFFFFF for -1
  uint32_t unused;
};

template <int K>
__device__ __forceinline__ uint32_t xs(uint32_t x) {
  return x ^ (x >> K);
}

__device__ __forceinline__ uint32_t lane_key(uint32_t ctr) {
  return xs<16>(ctr);
}

// The PRG's words for W terms held in registers, stage by stage over the
// W words, so that with W > 1 ptxas can interleave their chains.
template <int W>
__device__ __forceinline__ void prg_words(uint32_t lkey,
                                          const MaskTerm (&t)[W],
                                          uint32_t (&x)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = (lkey ^ t[i].key) * kPrgMix1;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = xs<15>(x[i]) * kPrgMix2;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = xs<16>(x[i]) + t[i].seed;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = xs<16>(x[i]) * kPrgMix1;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = xs<15>(x[i]) * kPrgMix2;
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = xs<16>(x[i]);
}

__device__ __forceinline__ uint32_t signed_word(uint32_t lkey,
                                                const MaskTerm& t) {
  const MaskTerm ts[1] = {t};
  uint32_t x[1];
  prg_words(lkey, ts, x);
  return t.sign * x[0];
}

// sum_j sign_j * prg(seed_j, ctr) mod 2^32 over n staged terms, four
// words in flight (the ring sum takes any order). STAGED loads four terms
// into registers and runs their words stage by stage, and ptxas
// interleaves the four chains (B4, the seal); without it the four words
// run one after another into four sums, which keeps B5's register-heavy
// 256-thread forms from spilling.
template <bool STAGED>
__device__ __forceinline__ uint32_t mask_sum(const MaskTerm* terms, int n,
                                             uint32_t lkey) {
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  int j = 0;
  for (; j + 3 < n; j += 4) {
    if (STAGED) {
      MaskTerm t[4];
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = terms[j + i];
      prg_words(lkey, t, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] += t[i].sign * x[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] += signed_word(lkey, terms[j + i]);
    }
  }
  for (; j < n; ++j) m[0] += signed_word(lkey, terms[j]);
  return (m[0] + m[1]) + (m[2] + m[3]);
}

// Stages n int64 seeds and signs in shared memory as MaskTerms (mod 2^32,
// so a -1 sign becomes 0xFFFFFFFF), the block's threads in turn; the
// caller synchronises the block before they are read.
__device__ __forceinline__ void stage_mask_terms(
    const long long* __restrict__ seeds, const long long* __restrict__ signs,
    int n, MaskTerm* staged) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t seed = (uint32_t)seeds[i];
    staged[i] = MaskTerm{xs<16>(seed * kPrgMix1), seed, (uint32_t)signs[i],
                         0u};
  }
}

// ------------------------------------------------------------- row access
// How the aggregation kernels read lane `lane` of row `p`. `bind` runs once
// at the top of a kernel, with every thread of the block, and returns the
// reader the kernel uses.

struct PlainRows {                  // x: (P, N) fp32
  const float* x;
  long long N;
  __device__ __forceinline__ PlainRows bind(uint4*, int) const {
    return *this;
  }
  __device__ __forceinline__ float row(int p, long long lane) const {
    return __ldg(x + (long long)p * N + lane);
  }
  __device__ __forceinline__ float4 row4(int p, long long lane) const {
    return __ldg(reinterpret_cast<const float4*>(x + (long long)p * N + lane));
  }
};

template <bool STAGED>              // mask_sum's form
struct SealedRows {                 // y: (P, N) sealed bits; (P, R) terms
  const uint32_t* y;
  long long N;
  const long long* seeds;           // device memory, until bound
  const long long* signs;
  int R;
  const MaskTerm* terms;            // shared memory, after bind

  __device__ __forceinline__ SealedRows bind(uint4* staged, int P) const {
    MaskTerm* t = reinterpret_cast<MaskTerm*>(staged);
    stage_mask_terms(seeds, signs, P * R, t);
    __syncthreads();
    SealedRows r = *this;
    r.terms = t;
    return r;
  }
  __device__ __forceinline__ float unseal(int p, uint32_t bits,
                                          uint32_t ctr) const {
    return __uint_as_float(bits -
                           mask_sum<STAGED>(terms + p * R, R, lane_key(ctr)));
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
    acc = mean_step(acc, __ldg(w + p), rows.row(p, lane));
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
    acc.x = mean_step(acc.x, wp, v.x);
    acc.y = mean_step(acc.y, wp, v.y);
    acc.z = mean_step(acc.z, wp, v.z);
    acc.w = mean_step(acc.w, wp, v.w);
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
// B1, and B4 where the lanes fill the card (VEC false, any block size).

template <class Rows, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const Rows rows_arg, const float* __restrict__ w,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int P, long long N) {
  extern __shared__ uint4 staged[];
  const Rows rows = rows_arg.bind(staged, P);
  const float total = total_weight(w, P);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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

// ------------------------------------------------ unmask + mean, few lanes
// B4 where one lane a thread would leave the card's schedulers short of
// warps (the MF session's 11,173 lanes make 350 warps for 528 schedulers):
// a block takes 32 lanes and all P rows, and its warps take the rows of a
// chunk in turn, each unsealing its row's 32 words into shared memory; after
// a barrier the first warp adds the chunk's rows to its lanes' means with
// `mean_step`, in row order.

constexpr int kRowsThreads = 128;
constexpr int kRowsChunk = 64;                // rows a chunk

__global__ void __launch_bounds__(kRowsThreads)
fused_unmask_rows_kernel(const uint32_t* __restrict__ y,
                         const float* __restrict__ w,
                         const unsigned char* __restrict__ mask,
                         const long long* __restrict__ seeds,
                         const long long* __restrict__ signs, int R,
                         float* __restrict__ out, int P, long long N) {
  extern __shared__ MaskTerm terms[];           // (P, R)
  __shared__ uint32_t unsealed[kRowsChunk][32];
  stage_mask_terms(seeds, signs, P * R, terms);
  const float total = total_weight(w, P);       // loads beside the staging's
  __syncthreads();

  constexpr int kWarps = kRowsThreads / 32;
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const long long lane = (long long)blockIdx.x * 32 + l32;
  const bool live = lane < N;
  const uint32_t lkey = lane_key((uint32_t)lane);
  // the warps that take a row more than the others differ by block
  const int first = (warp + kWarps - (int)(blockIdx.x % kWarps)) % kWarps;
  float acc = 0.0f;
  for (int r0 = 0; r0 < P; r0 += kRowsChunk) {
    const int rows = min(kRowsChunk, P - r0);
    if (live) {
      for (int c = first; c < rows; c += kWarps) {
        const int r = r0 + c;
        unsealed[c][l32] = __ldg(y + (long long)r * N + lane) -
                           mask_sum<true>(terms + r * R, R, lkey);
      }
    }
    __syncthreads();
    if (warp == 0 && live) {
      for (int c = 0; c < rows; ++c)
        acc = mean_step(acc, __ldg(w + r0 + c),
                        __uint_as_float(unsealed[c][l32]));
    }
    __syncthreads();
  }
  if (warp == 0 && live)
    out[lane] = finish_lane(acc, total, mask != nullptr && mask[lane] != 0);
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
  extern __shared__ uint4 staged[];
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
  extern __shared__ MaskTerm terms[];
  stage_mask_terms(seeds, signs, R, terms);
  __syncthreads();
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane < N)
    out[lane] =
        __ldg(x + lane) + mask_sum<true>(terms, R, lane_key((uint32_t)lane));
}

// Shared memory for the staged (P, R) seeds and signs.
inline size_t staged_bytes(int terms) { return sizeof(MaskTerm) * terms; }

// Lets `kernel` take `smem` bytes of dynamic shared memory. A block gets
// 48 KB of static and dynamic shared memory together without an opt-in;
// the staged terms of P·R up to MAX_MASK_TERMS take up to 96 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return rc;
  if (attr.sharedSizeBytes + smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int sm_count() {
  static int count[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (count[dev & 15] == 0)
    cudaDeviceGetAttribute(&count[dev & 15], cudaDevAttrMultiProcessorCount,
                           dev);
  return count[dev & 15];
}

// B4 spreads its rows over warps where one lane a thread would give the
// card's schedulers (four an SM) fewer than 4 warps each.
bool unmask_by_rows(long long N) {
  return (N + 31) / 32 < 16LL * sm_count();
}

// The block size of B4 at one lane a thread: the one whose busiest SM
// (ceil(blocks / SMs) blocks) has the fewest lanes, ties to the larger
// block, at most 32 blocks an SM.
int lane_threads(long long N) {
  const int sms = sm_count();
  int best = kThreads;
  long long best_lanes = -1;
  for (int threads = kThreads; threads >= 64; threads -= 64) {
    const long long blocks = (N + threads - 1) / threads;
    const long long per_sm = (blocks + sms - 1) / sms;
    if (per_sm > 32 && threads != kThreads) continue;
    if (best_lanes < 0 || per_sm * threads < best_lanes) {
      best = threads;
      best_lanes = per_sm * threads;
    }
  }
  return best;
}

int launch_agg(const float* x, const float* w, const unsigned char* mask,
               float* out, int P, long long N, cudaStream_t s) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const PlainRows rows{x, N};
  const bool vec = (N % 4 == 0) && aligned(x, 16) && aligned(out, 16) &&
                   (mask == nullptr || aligned(mask, 4));
  if (vec) {
    const long long blocks = (N / 4 + kThreads - 1) / kThreads;
    fused_agg_kernel<PlainRows, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        rows, w, mask, out, P, N);
  } else {
    const long long blocks = (N + kThreads - 1) / kThreads;
    fused_agg_kernel<PlainRows, false><<<(unsigned)blocks, kThreads, 0, s>>>(
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
  auto kernel =
      vec ? (wide ? fused_agg_quant_kernel<Rows, true, kQuantThreadsWide>
                  : fused_agg_quant_kernel<Rows, true, kQuantThreads>)
          : (wide ? fused_agg_quant_kernel<Rows, false, kQuantThreadsWide>
                  : fused_agg_quant_kernel<Rows, false, kQuantThreads>);
  const cudaError_t rc = allow_smem(kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)blocks, wide ? kQuantThreadsWide : kQuantThreads, smem,
           s>>>(rows, w, mask, mean, codes, scales, P, N);
  return (int)cudaGetLastError();
}

template <bool STAGED>
SealedRows<STAGED> sealed_rows(const uint32_t* y, long long N,
                               const long long* seeds,
                               const long long* signs, int R) {
  return SealedRows<STAGED>{y, N, seeds, signs, R, nullptr};
}

}  // namespace

extern "C" {

int fused_agg_launch(const float* x, const float* w,
                     const unsigned char* mask, float* out, int P,
                     long long N, void* stream) {
  return launch_agg(x, w, mask, out, P, N, static_cast<cudaStream_t>(stream));
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
  const cudaError_t rc = allow_smem(fused_mask_kernel, staged_bytes(R));
  if (rc != cudaSuccess) return (int)rc;
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
  if (N <= 0 || P <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = staged_bytes(P * R);
  if (unmask_by_rows(N)) {
    const cudaError_t rc = allow_smem(fused_unmask_rows_kernel, smem);
    if (rc != cudaSuccess) return (int)rc;
    fused_unmask_rows_kernel<<<(unsigned)((N + 31) / 32), kRowsThreads, smem,
                               s>>>(y, w, mask, seeds, signs, R, out, P, N);
  } else {
    const cudaError_t rc =
        allow_smem(fused_agg_kernel<SealedRows<true>, false>, smem);
    if (rc != cudaSuccess) return (int)rc;
    const int threads = lane_threads(N);
    fused_agg_kernel<SealedRows<true>, false>
        <<<(unsigned)((N + threads - 1) / threads), threads, smem, s>>>(
            sealed_rows<true>(y, N, seeds, signs, R), w, mask, out, P, N);
  }
  return (int)cudaGetLastError();
}

int fused_unmask_agg_quant_launch(const uint32_t* y, const float* w,
                                  const unsigned char* mask,
                                  const long long* seeds,
                                  const long long* signs, int R, float* mean,
                                  signed char* codes, float* scales, int P,
                                  long long N, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  return launch_agg_quant(sealed_rows<false>(y, N, seeds, signs, R), y, w,
                          mask, mean, codes, scales, P, N,
                          staged_bytes(P * R),
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
