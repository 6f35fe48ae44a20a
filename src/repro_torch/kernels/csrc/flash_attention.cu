// Causal / full GQA attention by online softmax (flash-style), forward.
//
// Replaces the reference package's Pallas kernel ``_flash_kernel``
// (src/repro/kernels/flash_attention.py, ``flash_attention``).
//
// What it computes. q (B,Hq,S,hd), k and v (B,Hkv,S,hd), Hq % Hkv == 0:
// query head h reads KV head h / (Hq/Hkv), by index, never repeated in
// memory. For each query row: scores s = (q . k) * hd^-1/2 over the keys,
// -1e30 where masked (causal: key > query; every key >= S), then the
// running (m, l, acc) of the online softmax in fp32, tile by tile, and
// out = acc / max(l, 1e-30) by IEEE division, stored in the input's type
// (bf16 by __float2bfloat16_rn). Any S >= 1: the tail tile is masked, so
// the kernel is right at every length, where the reference's tiling
// asserts S % min(512, S) == 0. The inputs are read through strides (the
// innermost dimension must be contiguous), so the model reads its
// (B,S,H,hd) projections and writes a (B,S,Hq,hd) output with no transpose.
//
// What bounds it on the card. At the serving shape (B=4, S=1024, Hq=32,
// Hkv=4, hd=64, bf16, causal) it moves 38 MB and does 17 GFLOP: bounded by
// operations, 0.017 ms at the bf16 tensor-core peak, 0.26 ms at the fp32
// CUDA-core peak this kernel uses.
//
// Design (simple and right first; wgmma/TMA are later work). One block of
// 64 query rows per (query block, query head, batch); HD/16 threads per row,
// each holding 16 of the row's dims of q and of the fp32 accumulator in
// registers (float4 chunks interleaved across the row's threads, so the
// shared-memory reads of a warp are free of bank conflicts). K and V tiles
// of BK keys are staged in shared memory, widened to fp32 (32 KB for
// hd 64 and 128, 16 KB for 32; no opt-in needed). Scores are fp32 FMA
// partial dots reduced across the row's threads by xor shuffles (all of
// them end with the same bits, so m and l agree across the row). In causal
// mode the KV loop stops at the block's diagonal, and the heaviest query
// blocks are scheduled first. No -use_fast_math: expf and __fdiv_rn are
// the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows a block
constexpr float NEG_INF = -1e30f;   // the reference's mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __align__(8) __nv_bfloat16 h[4] = {
      __float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y),
      __float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

struct Strides {          // in elements, per (batch, head, position)
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * (HD / 16))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int group,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 float scale) {
  constexpr int TPR = HD / 16;             // threads a query row
  constexpr int NT = BQ * TPR;
  constexpr int BK = HD == 128 ? 32 : 64;  // keys a tile
  constexpr int C4 = HD / 4;               // float4 chunks a row
  __shared__ __align__(16) float k_tile[BK * HD];
  __shared__ __align__(16) float v_tile[BK * HD];

  const int qb = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int lane = tid % TPR;
  const int qrow = qb * BQ + tid / TPR;
  const bool row_ok = qrow < S;

  // this thread's dims: chunks lane, lane + TPR, lane + 2 TPR, lane + 3 TPR
  float qv[16], acc[16];
  const T* qp = q + b * qs.b + h * qs.h + (long long)qrow * qs.s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = row_ok ? load4(qp + (i * TPR + lane) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qv[4 * i] = t.x;
    qv[4 * i + 1] = t.y;
    qv[4 * i + 2] = t.z;
    qv[4 * i + 3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int kend = causal ? min(S, (qb + 1) * BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                       // the last tile is consumed
    for (int c = tid; c < BK * C4; c += NT) {
      const int row = c / C4, col = (c % C4) * 4;
      const int key = k0 + row;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < S) {
        kk = load4(kb + (long long)key * ks.s + col);
        vv = load4(vb + (long long)key * vs.s + col);
      }
      *reinterpret_cast<float4*>(&k_tile[row * HD + col]) = kk;
      *reinterpret_cast<float4*>(&v_tile[row * HD + col]) = vv;
    }
    __syncthreads();

    float s[BK];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&k_tile[j * HD]);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kk = kr[i * TPR + lane];
        d = fmaf(qv[4 * i], kk.x, d);
        d = fmaf(qv[4 * i + 1], kk.y, d);
        d = fmaf(qv[4 * i + 2], kk.z, d);
        d = fmaf(qv[4 * i + 3], kk.w, d);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      const int key = k0 + j;
      const bool ok = key < S && (!causal || key <= qrow);
      s[j] = ok ? d * scale : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    // the first tile holds key 0, which every row sees: m is finite after it
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&v_tile[j * HD]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 vv = vr[i * TPR + lane];
        acc[4 * i] = fmaf(s[j], vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + b * os.b + h * os.h + (long long)qrow * os.s;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4(op + (i * TPR + lane) * 4,
             make_float4(__fdiv_rn(acc[4 * i], denom),
                         __fdiv_rn(acc[4 * i + 1], denom),
                         __fdiv_rn(acc[4 * i + 2], denom),
                         __fdiv_rn(acc[4 * i + 3], denom)));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int group, int S, const Strides* st,
                   int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, BQ * (HD / 16), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, group, st[0], st[1],
      st[2], st[3], causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int Hq, int group, int S,
                      const Strides* st, int causal, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, group, S, st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, group, S, st, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, group, S, st, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. strides: 12 int64, (batch, head, position) of
// q, k, v and o in that order, in elements. Returns cudaGetLastError()
// after the launch; nothing is synchronised.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int hd, int B, int Hq, int Hkv, int S,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, Hq, group, S, st, causal, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Hq, group, S, st, causal, scale, s);
  return cudaErrorInvalidValue;
}
