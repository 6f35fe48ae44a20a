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
//   per 16384-lane subtile (the quantised forms only):
//   scale    = max(absmax(mean), 1e-12) / 127
//   codes[n] = (int8) clip(rint(mean[n] / scale), -127, 127)
//
// What bounds it on this card: bytes. The work is a stream: (P+1)*N words
// read, N written (plus N bytes and N/16384 words for the quantised form),
// with P multiply-adds per lane; the floor is bytes / HBM bandwidth. At the
// sessions' shapes (P <= sample size, N = 136,672 for the CNN, 11,173 for
// MF) the whole stack is a few MB, sits in L2, and the launch and the
// card's fill dominate.
//
// What the design does about it: every lane is independent, so a grid over
// lanes with 16-byte loads (4 lanes a thread, neighbouring threads on
// neighbouring addresses) streams each row once, and its block size is
// chosen from N so the blocks split evenly over the SMs (`lane_threads`).
//
// The quantised form needs one absmax a subtile before its first code. It
// runs on the grid of the mean-only form, whose blocks each cover a divisor
// of 16384 lanes (no block straddles a subtile), in two phases in one
// launch: every block writes its means and its absmax and counts itself in
// its subtile (an atomic count). So a model of 9 subtiles fills the card as
// the mean-only form does, where one block a subtile left 123 of 132 SMs
// idle. Where the whole grid fits on the card at once (both sessions), it
// is a cooperative launch and every block waits for its subtile's count,
// then quantises its own means from registers. Otherwise the last block of
// a subtile to arrive writes its scale and codes from the means read back
// through L2; one block then does a subtile's 16384 IEEE divisions with
// few warps, so that form is only for grids too large to be resident. (One
// block a subtile with its means in registers, never read back, was 0.4 %
// faster for B2 at N = 2^24 on an H100, where the means overflow L2: too
// little for a third kernel.)
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
// terms, subtracts it and reads the restored bits as fp32. B4 and B5 take
// the reference's lane `base` and a global `n_valid`, so one launch can
// unmask one shard of a longer row: lane l of the launch is the row's lane
// base + l, the PRG's counter, and a lane whose counter is at or past
// n_valid is padding that was never sealed, read as it is (zeros). One
// launch over a whole row has base 0 and n_valid N. What bounds the
// masked kernels is the PRG on the integer ALU pipe, not bytes: P*R*N words
// (R*N for the seal) of 11 ALU-pipe instructions each (see the PRG below),
// against (P+1)*N words of traffic. A sealed row is arbitrary bits (NaNs
// with payloads, subnormals), so it is read as uint32 and no float
// operation touches it before the mask is gone.
//
// What the design does about it: the seal takes one lane a thread. B4
// (unmask + mean) and B5 (unmask + mean + codes) read their rows through
// SealedRows in the plain forms' lane kernel, one lane a thread; where the
// lanes are too few for every scheduler to hold 4 warps of one lane a
// thread (N <= 67,552 on 132 SMs: the MF session), a block takes 32 lanes
// and its warps share the rows (`fused_unmask_rows_kernel`). So the PRG's
// words spread over the whole card at the sessions' shapes.
//
// Bit-exactness: every kernel adds rows with `mean_step` in row order from
// 0 and ends with `finish_lane`, through `weighted_mean_lane` (templated on
// how a row is read) or the rows kernel's one loop, so the means of all the
// aggregation kernels are equal bit for bit, masked or not, quantised or
// not, and do not depend on the grid; codes and scales are those of the
// mean (absmax's `max` is exact in any order). The fused multiply-add is
// explicit, the total weight is added in row order by every thread alike,
// both divisions are IEEE (`__fdiv_rn`), rounding is `rintf` (half to
// even, never `roundf`). Build without -use_fast_math.
//
// Plain C interface for ctypes: each launcher enqueues on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSubtile = 16384;               // quantisation granularity
constexpr int kThreads = 256;                 // the largest block

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
// words in flight (the ring sum takes any order): four terms are loaded
// into registers and their words run stage by stage, so that ptxas
// interleaves the four chains.
__device__ __forceinline__ uint32_t mask_sum(const MaskTerm* terms, int n,
                                             uint32_t lkey) {
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  int j = 0;
  for (; j + 3 < n; j += 4) {
    MaskTerm t[4];
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = terms[j + i];
    prg_words(lkey, t, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] += t[i].sign * x[i];
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
  static constexpr bool kPlain = true;
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

// PAD: some lanes of the launch are padding (lane >= n_live), read as
// they are. Without it no lane is tested: on an H100 a per-lane test in
// the hot path made B4 and B5 slower at the sessions' shapes (most at the
// MF session's, the rows kernel), so launches over whole rows (every lane
// sealed) take the form without it.
template <bool PAD>
struct SealedRows {                 // y: (P, N) sealed bits; (P, R) terms
  static constexpr bool kPlain = false;
  const uint32_t* y;
  long long N;
  const long long* seeds;           // device memory, until bound
  const long long* signs;
  int R;
  uint32_t base;                    // lane l's PRG counter is base + l
  long long n_live;                 // lanes from here on: padding (PAD)
  const MaskTerm* terms;            // shared memory, after bind

  __device__ __forceinline__ SealedRows bind(uint4* staged, int P) const {
    MaskTerm* t = reinterpret_cast<MaskTerm*>(staged);
    stage_mask_terms(seeds, signs, P * R, t);
    __syncthreads();
    SealedRows r = *this;
    r.terms = t;
    return r;
  }
  __device__ __forceinline__ float row(int p, long long lane) const {
    const uint32_t bits = __ldg(y + (long long)p * N + lane);
    if (PAD && lane >= n_live) return __uint_as_float(bits);  // never sealed
    return __uint_as_float(bits - mask_sum(terms + p * R, R,
                                           lane_key(base + (uint32_t)lane)));
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

// Four consecutive plain lanes through 16-byte loads; lane % 4 == 0,
// N % 4 == 0 and 16-byte aligned rows are the launcher's to guarantee. Per
// lane the arithmetic is that of weighted_mean_lane, in the same order.
__device__ __forceinline__ float4 weighted_mean_lane4(
    const PlainRows& rows, const float* __restrict__ w,
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

// ------------------------------------------------------ quantised phase 2
// The quantised forms (B2, B5) run on the grid of their mean-only form,
// whose blocks each cover a divisor of kSubtile lanes, and end every block
// with a second phase: the block folds its absmax into its subtile's
// (`atomicMax` on the bits: an absmax is >= 0 or NaN, whose uint32 order
// is the float order with a NaN above all) and counts itself in. The block
// that arrives last takes the absmax (and leaves 0), writes the scale and
// puts the count back to 0. Then:
//
// * kTogether, where the whole grid fits on the card at once (launched as
//   a cooperative kernel, which CUDA runs only if it does): the last
//   block bumps the subtile's generation word, for which the others wait;
//   every block quantises its own means from registers;
// * kLastBlock, otherwise: the last block quantises the subtile's means,
//   read back through L2. Its one block does a subtile's divisions, so it
//   is the slower form.
//
// The words are the wrapper's workspace, three a subtile. A kernel leaves
// the count and absmax of every subtile at 0 (a generation only changes),
// so the next launch or a replayed graph finds them ready. Two launches
// that run at once must not share the words: the wrapper
// (`fused._workspace`) orders its calls on two streams, keeps every
// workspace a captured graph may hold, and documents what it cannot order
// (a graph replayed beside a call on another stream).

enum Quant { kMeanOnly = 0, kLastBlock = 1, kTogether = 2 };

struct QuantOut {                   // the quantised forms' outputs
  signed char* codes;               // (N,)
  float* scales;                    // (subtiles,)
  unsigned int* arrived;            // (subtiles,), 0 between launches
  unsigned int* absmax;             // (subtiles,) float bits, 0 between
  unsigned int* generation;         // (subtiles,)
};

struct Subtile {                    // the subtile of this block
  int s, blocks;                    // index, blocks in it
};

__device__ __forceinline__ Subtile subtile_of(int block_lanes) {
  const int per_subtile = kSubtile / block_lanes;
  const int s = blockIdx.x / per_subtile;
  return {s, min(per_subtile, (int)gridDim.x - s * per_subtile)};
}

// In thread 0, after the block's means are visible: folds in its absmax
// and counts it; the subtile's scale in the block that arrives last (which
// resets the count and the absmax), else a negative number.
__device__ __forceinline__ float arrive(const Subtile& t, float amax,
                                        const QuantOut& q) {
  atomicMax(q.absmax + t.s, __float_as_uint(amax));
  __threadfence();
  if (atomicAdd(q.arrived + t.s, 1u) != (unsigned)(t.blocks - 1))
    return -1.0f;
  __threadfence();
  const float scale =
      tile_scale(__uint_as_float(atomicExch(q.absmax + t.s, 0u)));
  q.scales[t.s] = scale;
  q.arrived[t.s] = 0u;
  return scale;
}

// Codes of lanes [lo, hi) from the means in device memory. `__ldcg`: other
// SMs wrote those means in this launch, so they are read from L2, never
// through the non-coherent read-only path.
__device__ __forceinline__ void write_codes(const float* mean,
                                            signed char* codes, long long lo,
                                            long long hi, float scale) {
  long long body = lo;
  if (aligned(mean, 16) && aligned(codes, 4)) {         // lo % 4 == 0
    body = lo + ((hi - lo) & ~3LL);
    for (long long l = lo + 4LL * threadIdx.x; l < body;
         l += 4LL * blockDim.x) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(mean + l));
      char4 c;
      c.x = quantize_lane(v.x, scale);
      c.y = quantize_lane(v.y, scale);
      c.z = quantize_lane(v.z, scale);
      c.w = quantize_lane(v.w, scale);
      *reinterpret_cast<char4*>(codes + l) = c;
    }
  }
  for (long long l = body + threadIdx.x; l < hi; l += blockDim.x)
    codes[l] = quantize_lane(__ldcg(mean + l), scale);
}

// kLastBlock's phase 2, in every thread of a block that has stored its
// means; `amax` is the block's. Writes codes only in the last block.
__device__ __forceinline__ void last_block(const float* mean, long long N,
                                           int block_lanes, float amax,
                                           const QuantOut& q) {
  __shared__ float scale;
  const Subtile t = subtile_of(block_lanes);
  __threadfence();                  // this thread's means, before the count
  __syncthreads();
  if (threadIdx.x == 0) scale = arrive(t, amax, q);
  __syncthreads();
  if (scale < 0.0f) return;         // not the last (a NaN scale is last)
  __threadfence();
  const long long lo = (long long)t.s * kSubtile;
  write_codes(mean, q.codes, lo, min(N, lo + kSubtile), scale);
}

// kTogether's phase 2: the subtile's scale, in every thread of every block
// of a grid that is resident at once; `amax` is the block's.
__device__ __forceinline__ float wait_for_subtile(int block_lanes,
                                                  float amax,
                                                  const QuantOut& q) {
  __shared__ float scale;
  const Subtile t = subtile_of(block_lanes);
  if (threadIdx.x == 0) {
    // read before arriving, so before the subtile's last block bumps it
    const volatile unsigned int* gen = q.generation + t.s;
    const unsigned int gen0 = *gen;
    const float mine = arrive(t, amax, q);
    if (!(mine < 0.0f)) {
      scale = mine;
      __threadfence();
      atomicAdd(q.generation + t.s, 1u);
    } else {
      while (*gen == gen0) __nanosleep(64);
      __threadfence();
      scale = __ldcg(q.scales + t.s);
    }
  }
  __syncthreads();
  return scale;
}

// ------------------------------------------------------ one lane a thread
// B1 and B2 (QUANT) at any N, and B4 and B5 (QUANT) where the lanes fill
// the card: a grid over lanes, one lane a thread or (VEC, plain rows) four
// through 16-byte loads, in blocks of 256 threads, B4's sized from N
// (`lane_threads`).

template <class Rows, bool VEC, int QUANT>
__global__ void __launch_bounds__(kThreads)
fused_agg_kernel(const Rows rows_arg, const float* __restrict__ w,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int P, long long N, QuantOut q) {
  extern __shared__ uint4 staged[];
  const Rows rows = rows_arg.bind(staged, P);
  const float total = total_weight(w, P);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = VEC ? t * 4 : t;
  const bool live = lane < N;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);     // lanes past N: zeros
  if (live) {
    if constexpr (VEC) {
      v = weighted_mean_lane4(rows, w, mask, P, lane, total);
      *reinterpret_cast<float4*>(out + lane) = v;
    } else {
      v.x = weighted_mean_lane(rows, w, mask, P, lane, total);
      out[lane] = v.x;
    }
  }
  if constexpr (QUANT != kMeanOnly) {
    const int block_lanes = blockDim.x * (VEC ? 4 : 1);
    const float amax = block_absmax<kThreads>(
        max_nan(max_nan(fabsf(v.x), fabsf(v.y)),
                max_nan(fabsf(v.z), fabsf(v.w))), blockDim.x);
    if constexpr (QUANT == kLastBlock) {
      last_block(out, N, block_lanes, amax, q);
    } else {
      const float scale = wait_for_subtile(block_lanes, amax, q);
      if (live) {
        if constexpr (VEC) {
          char4 c;
          c.x = quantize_lane(v.x, scale);
          c.y = quantize_lane(v.y, scale);
          c.z = quantize_lane(v.z, scale);
          c.w = quantize_lane(v.w, scale);
          *reinterpret_cast<char4*>(q.codes + lane) = c;
        } else {
          q.codes[lane] = quantize_lane(v.x, scale);
        }
      }
    }
  }
}

// ------------------------------------------------ unmask, rows over warps
// B4 and B5 where one lane a thread would leave the card's schedulers short
// of warps (the MF session's 11,173 lanes make 350 warps for 528
// schedulers): a block takes 32 lanes and all P rows, and its warps take
// the rows of a chunk in turn, each unsealing its row's 32 lanes into
// shared memory; after a barrier the first warp adds the chunk's rows to
// its lanes' means with `mean_step`, in row order. (Plain rows are a load
// each, and one lane a thread reads them faster at such N.)

constexpr int kRowsThreads = 128;
constexpr int kRowsChunk = 64;                // rows a chunk

// (Its rows come as pointers, not as a SealedRows: with the struct it ran
// 5-10 % slower at the MF session on an H100, `fused_times.py`.)
template <int QUANT, bool PAD>
__global__ void __launch_bounds__(kRowsThreads)
fused_unmask_rows_kernel(const uint32_t* __restrict__ y,
                         const float* __restrict__ w,
                         const unsigned char* __restrict__ mask,
                         const long long* __restrict__ seeds,
                         const long long* __restrict__ signs, int R,
                         uint32_t base, long long n_live,
                         float* __restrict__ out, int P, long long N,
                         QuantOut q) {
  extern __shared__ MaskTerm terms[];           // (P, R)
  __shared__ uint32_t unsealed[kRowsChunk][32];
  stage_mask_terms(seeds, signs, P * R, terms);
  const float total = total_weight(w, P);       // loads beside the staging's
  __syncthreads();

  constexpr int kWarps = kRowsThreads / 32;
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const long long lane = (long long)blockIdx.x * 32 + l32;
  const bool live = lane < N;
  const bool sealed = !PAD || lane < n_live;      // else padding, as it is
  const uint32_t lkey = lane_key(base + (uint32_t)lane);
  // the warps that take a row more than the others differ by block
  const int first = (warp + kWarps - (int)(blockIdx.x % kWarps)) % kWarps;
  float acc = 0.0f;
  for (int r0 = 0; r0 < P; r0 += kRowsChunk) {
    const int n = min(kRowsChunk, P - r0);
    if (live) {
      for (int c = first; c < n; c += kWarps) {
        const int r = r0 + c;
        uint32_t bits = __ldg(y + (long long)r * N + lane);
        if (sealed) bits -= mask_sum(terms + r * R, R, lkey);
        unsealed[c][l32] = bits;
      }
    }
    __syncthreads();
    if (warp == 0 && live) {
      for (int c = 0; c < n; ++c)
        acc = mean_step(acc, __ldg(w + r0 + c),
                        __uint_as_float(unsealed[c][l32]));
    }
    __syncthreads();
  }
  const bool mine = warp == 0 && live;            // the lanes' means
  float v = 0.0f;
  if (mine) {
    v = finish_lane(acc, total, mask != nullptr && mask[lane] != 0);
    out[lane] = v;
  }
  if constexpr (QUANT != kMeanOnly) {
    const float amax = block_absmax<kThreads>(fabsf(v), kRowsThreads);
    if constexpr (QUANT == kLastBlock) {
      last_block(out, N, 32, amax, q);
    } else {
      const float scale = wait_for_subtile(32, amax, q);
      if (mine) q.codes[lane] = quantize_lane(v, scale);
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
    out[lane] = __ldg(x + lane) + mask_sum(terms, R, lane_key((uint32_t)lane));
}

// ------------------------------------------------------------ launchers

// Shared memory for the staged (P, R) seeds and signs.
inline size_t staged_bytes(int terms) { return sizeof(MaskTerm) * terms; }

// Lets `kernel` take `smem` bytes of dynamic shared memory. A block gets
// 48 KB of static and dynamic shared memory together without an opt-in;
// the staged terms of P·R up to MAX_MASK_TERMS take up to 96 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem == 0) return cudaSuccess;
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

enum Op { kAgg = 0, kAggQuant = 1, kUnmaskAgg = 2, kUnmaskAggQuant = 3 };
enum Form { kLanes = 0, kRows = 1 };

struct Plan {                       // what a launcher runs
  int form;
  bool vec;                         // four lanes a thread (plain rows)
  int threads;
  long long blocks;
  int quant;                        // kMeanOnly, kLastBlock or kTogether
};

// The grid of an operation at N lanes: B4 and B5 rows over warps where
// one lane a thread would give the card's schedulers (four an SM) fewer
// than 4 warps each (N <= 67,552 on 132 SMs); else one lane a thread (four
// for the plain rows where `vec`).
Plan grid(int op, long long N, bool vec) {
  const int quant = op == kAggQuant || op == kUnmaskAggQuant ? kLastBlock
                                                              : kMeanOnly;
  const bool sealed = op == kUnmaskAgg || op == kUnmaskAggQuant;
  if (sealed && (N + 31) / 32 < 16LL * sm_count())
    return {kRows, false, kRowsThreads, (N + 31) / 32, quant};
  vec = vec && !sealed;
  const long long items = vec ? N / 4 : N;
  // B4 splits its blocks evenly over the SMs; B1 gained nothing from that,
  // and a quantised form's wait costs more the more blocks a subtile has
  const int threads = op == kUnmaskAgg ? lane_threads(items) : kThreads;
  return {kLanes, vec, threads, (items + threads - 1) / threads, quant};
}

// A quantised form waits for its subtile (kTogether) where `together` at
// the plan's grid fits on the card at once, else its last block quantises.
template <class Kernel>
void choose_quant(Kernel* together, size_t smem, Plan* p) {
  int per_sm = 0;
  if (p->quant == kLastBlock && allow_smem(together, smem) == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, together,
                                                    p->threads, smem) ==
          cudaSuccess &&
      (long long)per_sm * sm_count() >= p->blocks)
    p->quant = kTogether;
}

template <class Kernel, class... Args>
int launch(Kernel* k, const Plan& p, size_t smem, cudaStream_t s,
           Args... args) {
  cudaError_t rc = allow_smem(k, smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &coop;
  cfg.numAttrs = p.quant == kTogether ? 1 : 0;
  rc = cudaLaunchKernelEx(&cfg, k, args...);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <class Rows, bool VEC>
auto* lane_kernel(int quant) {
  return quant == kTogether    ? fused_agg_kernel<Rows, VEC, kTogether>
         : quant == kLastBlock ? fused_agg_kernel<Rows, VEC, kLastBlock>
                               : fused_agg_kernel<Rows, VEC, kMeanOnly>;
}

// B1 and B2. With `plan` set, only plans.
int run_plain(int op, const float* x, const float* w,
              const unsigned char* mask, float* mean, const QuantOut& q,
              int P, long long N, cudaStream_t s, Plan* plan = nullptr) {
  if (N <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (N % 4 == 0) && aligned(x, 16) && aligned(mean, 16) &&
                   (mask == nullptr || aligned(mask, 4)) &&
                   (q.codes == nullptr || aligned(q.codes, 4));
  Plan p = grid(op, N, vec);
  choose_quant(p.vec ? lane_kernel<PlainRows, true>(kTogether)
                     : lane_kernel<PlainRows, false>(kTogether), 0, &p);
  if (plan != nullptr) {
    *plan = p;
    return 0;
  }
  return launch(p.vec ? lane_kernel<PlainRows, true>(p.quant)
                      : lane_kernel<PlainRows, false>(p.quant),
                p, 0, s, PlainRows{x, N}, w, mask, mean, P, N, q);
}

template <bool PAD>
auto* rows_kernel(int quant) {
  return quant == kTogether    ? fused_unmask_rows_kernel<kTogether, PAD>
         : quant == kLastBlock ? fused_unmask_rows_kernel<kLastBlock, PAD>
                               : fused_unmask_rows_kernel<kMeanOnly, PAD>;
}

template <bool PAD>
void choose_sealed(size_t smem, Plan* p) {
  if (p->form == kRows)
    choose_quant(rows_kernel<PAD>(kTogether), smem, p);
  else
    choose_quant(lane_kernel<SealedRows<PAD>, false>(kTogether), smem, p);
}

template <bool PAD>
int launch_sealed(const Plan& p, size_t smem, cudaStream_t s,
                  const uint32_t* y, const float* w,
                  const unsigned char* mask, const long long* seeds,
                  const long long* signs, int R, uint32_t base,
                  long long n_live, float* mean, const QuantOut& q, int P,
                  long long N) {
  if (p.form == kRows)
    return launch(rows_kernel<PAD>(p.quant), p, smem, s, y, w, mask, seeds,
                  signs, R, base, n_live, mean, P, N, q);
  return launch(lane_kernel<SealedRows<PAD>, false>(p.quant), p, smem, s,
                SealedRows<PAD>{y, N, seeds, signs, R, base, n_live, nullptr},
                w, mask, mean, P, N, q);
}

// B4 and B5, lane l at PRG counter base + l, counters from n_valid on
// padding. With `plan` set, only plans (the plan does not depend on base
// or n_valid).
int run_sealed(int op, const uint32_t* y, const float* w,
               const unsigned char* mask, const long long* seeds,
               const long long* signs, int R, long long base,
               long long n_valid, float* mean, const QuantOut& q, int P,
               long long N, cudaStream_t s, Plan* plan = nullptr) {
  if (N <= 0 || P <= 0 || R <= 0 || base < 0 || n_valid < 0 ||
      base + N > (1LL << 32))
    return (int)cudaErrorInvalidValue;
  // the lanes of this launch below n_valid are sealed, the rest padding
  const long long n_live = n_valid - base < 0 ? 0 : n_valid - base;
  const bool pad = n_live < N;
  const size_t smem = staged_bytes(P * R);
  Plan p = grid(op, N, false);
  if (pad)
    choose_sealed<true>(smem, &p);
  else
    choose_sealed<false>(smem, &p);
  if (plan != nullptr) {
    *plan = p;
    return 0;
  }
  if (pad)
    return launch_sealed<true>(p, smem, s, y, w, mask, seeds, signs, R,
                               (uint32_t)base, n_live, mean, q, P, N);
  return launch_sealed<false>(p, smem, s, y, w, mask, seeds, signs, R,
                              (uint32_t)base, N, mean, q, P, N);
}

}  // namespace

extern "C" {

// The quantised entries take the workspace: `arrived`, `absmax` and
// `generation`, ceil(N / 16384) uint32 each, all 0 before the first call
// and left ready for the next (the first two at 0).

int fused_agg_launch(const float* x, const float* w,
                     const unsigned char* mask, float* out, int P,
                     long long N, void* stream) {
  return run_plain(kAgg, x, w, mask, out, QuantOut{}, P, N,
                   static_cast<cudaStream_t>(stream));
}

int fused_agg_quant_launch(const float* x, const float* w,
                           const unsigned char* mask, float* mean,
                           signed char* codes, float* scales,
                           unsigned int* arrived, unsigned int* absmax,
                           unsigned int* generation, int P, long long N,
                           void* stream) {
  return run_plain(kAggQuant, x, w, mask, mean,
                   QuantOut{codes, scales, arrived, absmax, generation}, P, N,
                   static_cast<cudaStream_t>(stream));
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

// B4 and B5 take the PRG counter of their first lane (`base`) and the
// count of the row's real lanes (`n_valid`): a lane whose counter is at or
// past it is padding and has no mask subtracted.

int fused_unmask_agg_launch(const uint32_t* y, const float* w,
                            const unsigned char* mask,
                            const long long* seeds, const long long* signs,
                            int R, long long base, long long n_valid,
                            float* out, int P, long long N, void* stream) {
  return run_sealed(kUnmaskAgg, y, w, mask, seeds, signs, R, base, n_valid,
                    out, QuantOut{}, P, N, static_cast<cudaStream_t>(stream));
}

int fused_unmask_agg_quant_launch(const uint32_t* y, const float* w,
                                  const unsigned char* mask,
                                  const long long* seeds,
                                  const long long* signs, int R,
                                  long long base, long long n_valid,
                                  float* mean, signed char* codes,
                                  float* scales, unsigned int* arrived,
                                  unsigned int* absmax,
                                  unsigned int* generation, int P, long long N,
                                  void* stream) {
  return run_sealed(kUnmaskAggQuant, y, w, mask, seeds, signs, R, base,
                    n_valid, mean,
                    QuantOut{codes, scales, arrived, absmax, generation}, P,
                    N, static_cast<cudaStream_t>(stream));
}

// What the launcher of `op` (0 agg, 1 agg_quant, 2 unmask_agg,
// 3 unmask_agg_quant) runs at N lanes on the current device, with `terms`
// staged mask terms (P * R; 0 for the plain rows) and rows, mean, codes and
// mask 16-byte aligned: its form (0 one lane a thread, 1 rows over warps),
// whether a thread takes four lanes, its grid, and whether the quantised
// form waits for its subtile (1) or leaves the codes to the last block
// (0).
int fused_plan(int op, long long N, int terms, int* form, int* vec,
               int* threads, long long* blocks, int* together) {
  if (op < kAgg || op > kUnmaskAggQuant || terms < 0)
    return (int)cudaErrorInvalidValue;
  // aligned stand-ins: the plan reads only their alignment
  alignas(16) static float row[4];
  alignas(16) static signed char codes[4];
  Plan p;
  const int rc =
      op == kAgg || op == kAggQuant
          ? run_plain(op, row, row, nullptr, row,
                      QuantOut{op == kAggQuant ? codes : nullptr}, 1, N,
                      nullptr, &p)
          : run_sealed(op, nullptr, row, nullptr, nullptr, nullptr,
                       terms > 0 ? terms : 1, 0, N, row, QuantOut{}, 1, N,
                       nullptr, &p);
  if (rc != 0) return rc;
  *form = p.form;
  *vec = p.vec ? 1 : 0;
  *threads = p.threads;
  *blocks = p.blocks;
  *together = p.quant == kTogether ? 1 : 0;
  return (int)cudaGetLastError();
}

}  // extern "C"
