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
// operations, 0.017 ms at the bf16 tensor-core peak.
//
// Two kernels, one a type; in causal mode both stop the KV loop at the
// block's diagonal and schedule the heaviest query blocks first. No
// -use_fast_math: exp2f/expf and __fdiv_rn are the accurate ones.
//
// bf16: flash_tc_kernel, on the tensor cores through wgmma (entry point
// flash_attention_bf16_launch). One warpgroup (128 threads) owns 64 query
// rows of one query head; a block holds NWG warpgroups, NWG consecutive
// query heads of one KV head (GQA packing), which share one K/V ring, so
// the block reads each K/V tile once for all of them. Q is copied to
// shared memory once; K and V tiles of 64 keys stream through a ring of
// STAGES slots filled by 16-byte cp.async (zero-filled past S). Every tile
// is stored in the swizzled layout its wgmma descriptor names (128-byte
// swizzle for hd 64 and 128, 64-byte for hd 32), so no copy is reshaped.
// S = Q K^T is wgmma m64n64k16 with both operands in shared memory and the
// fp32 accumulator in registers. The online softmax runs on that fragment:
// each thread holds two rows, whose max is reduced over the four threads
// that share them by shuffles; m, l and the rescale alpha stay in fp32 and
// l sums the fp32 p. P is then split into two bf16 terms, hi = bf16(p) and
// lo = bf16(p - hi), and O += P_hi V + P_lo V runs as two chains of
// m64n{hd}k16 with A from registers (the score fragment of one 16-bit
// wgmma is the A fragment of the next, so P needs no shuffles) and V read
// from shared memory transposed (tnspB), never copied transposed. One bf16
// P (what a plain tensor-core flash kernel does) is off the fp32 reference
// by up to 9x the port's bf16 tolerance; the two terms keep P to about 16
// bits for 1.5x the tensor work of one. Only the last tile (the diagonal,
// or the tail past S) is masked. Each step waits for its wgmma chain: the
// softmax does not yet overlap the products (PERF.md §6 has the times).
// exp: exp2f(s hd^-1/2 log2(e) - m), the scale and the max entering the
// argument by one fused multiply-add a score (m is kept on the raw
// scores). Each score costs one exponential on the SFU (16 a clock an SM)
// against 384 tensor-core operations at hd 64 (about 11 pairs a clock an
// SM at the bf16 peak with the split), so the SFU is about as scarce as
// the tensor cores and the FP32 pipe that feeds both; exp2f is the same
// one SFU instruction as expf without expf's range reduction (both within
// 2 ulp).
//
// fp32: flash_fwd_kernel, CUDA cores (entry point flash_attention_launch).
// One block of 64 query rows per (query block, query head, batch); HD/16
// threads per row, each holding 16 of the row's dims of q and of the fp32
// accumulator in registers (float4 chunks interleaved across the row's
// threads, so the shared-memory reads of a warp are free of bank
// conflicts). K and V tiles of BK keys are staged in shared memory (32 KB
// for hd 64 and 128, 16 KB for 32). Scores are fp32 FMA partial dots
// reduced across the row's threads by xor shuffles (all of them end with
// the same bits, so m and l agree across the row). Its bound is the fp32
// CUDA cores' (TF32 tensor cores would break the fp32 tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows a block (fp32) or warpgroup
constexpr float NEG_INF = -1e30f;   // the reference's mask value

struct Strides {          // in elements, per (batch, head, position)
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

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

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int group, int S, const Strides* st,
                        int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<float, HD><<<grid, BQ * (HD / 16), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, group, st[0],
      st[1], st[2], st[3], causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through wgmma
// ---------------------------------------------------------------------------

constexpr int BK = 64;            // keys a tile
constexpr int STAGES = 2;         // K/V tiles in the ring
constexpr int TILE_ROWS = 64;     // rows of every shared-memory tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory layout of a 64-row bf16 tile of HD columns. A row is cut
// into W-byte panels (W = 128 for hd 64 and 128, 64 for hd 32) stored one
// after another, 64 x W bytes each; inside a panel the 16-byte chunk index
// is xored with address bits 7.. (CUTLASS's Swizzle<3,4,3> for W = 128,
// <2,4,3> for 64), which is the layout that the descriptor's swizzle mode
// names. Tiles start 1024-byte aligned, so the swizzle of an offset is that
// of the address.
template <int HD>
struct Tile {
  static constexpr int W = HD >= 64 ? 128 : 64;
  static constexpr int CPP = W / 16;                 // chunks a panel row
  static constexpr int BYTES = TILE_ROWS * HD * 2;
  static constexpr uint64_t MODE = W == 128 ? 1 : 2; // 128B / 64B swizzle

  // byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off = (c / CPP) * (TILE_ROWS * W) + r * W + (c % CPP) * 16;
    return off ^ (((off >> 7) & (CPP - 1)) << 4);
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (each in 16-byte units), swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | mode << 62;
}

// K-major operand (Q as A, K as B of Q K^T): the 16 columns 16kk .. of a
// tile, 8-row groups W * 8 bytes apart (LBO unused with a swizzle)
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using T = Tile<HD>;
  const int byte = kk * 32;
  return make_desc(tile + (byte / T::W) * (TILE_ROWS * T::W) + byte % T::W,
                   16, 8 * T::W, T::MODE);
}

// MN-major operand (V as B of P V, read transposed): keys 16kk .. 16kk + 15
// of a tile, 8-key groups W * 8 bytes apart, the panels of hd 128 TILE_ROWS
// * W bytes apart
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using T = Tile<HD>;
  return make_desc(tile + kk * 16 * T::W, TILE_ROWS * T::W, 8 * T::W,
                   T::MODE);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each writer fences before the barrier that hands the tile over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins the registers of an asynchronous wgmma operand in place: no read or
// write of them moves across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, fp32) = or += A (64 x 16) . B (16 x 64); A and B K-major in
// shared memory, named by their descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, bf16, registers) . B (16 x 32); B in
// shared memory with 32 contiguous, read transposed (tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16, registers) . B (16 x 64); B in
// shared memory with 64 contiguous, read transposed (tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16, registers) . B (16 x 128); B in
// shared memory with 128 contiguous, read transposed (tnspB = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, db);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
}

// Rows row0 .. row0 + 63 of a (S, HD) matrix with row stride `stride`
// into the tile at dst (rows >= S zero-filled), 16 bytes a copy, by NT
// threads
template <int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int S,
                                          int tid) {
  constexpr int CPR = HD / 8;      // 16-byte chunks a row
  static_assert(TILE_ROWS * CPR % NT == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < TILE_ROWS * CPR / NT; ++i) {
    const int ci = tid + i * NT;
    const int r = ci / CPR, c = ci % CPR;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + Tile<HD>::offset(r, c),
               src + (ok ? row : 0) * stride + c * 8, ok);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragment of m64nN (wgmma's layout): thread `lane` of warp w
// of a warpgroup holds element i at row 16 w + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int group, int Hq,
                int nbh, Strides qs, Strides ks, Strides vs, Strides os,
                int causal, float scale_log2) {
  constexpr int NT = 128 * NWG;
  constexpr int TB = Tile<HD>::BYTES;
  extern __shared__ uint8_t smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;  // one a head
  const uint32_t ring = q_s + NWG * TB;          // slot s: K, then V

  // longest causal rows first, over all heads and batches; a block takes
  // NWG consecutive query heads (one a warpgroup) of one KV head
  const int nqb = gridDim.x / nbh;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = blockIdx.x % nbh;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int b = bh / (Hq / NWG);
  const int h = bh % (Hq / NWG) * NWG + wg, hk = h / group;
  const int q0 = qb * BQ;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;
  const int ntiles = ((causal ? min(S, q0 + BQ) : S) + BK - 1) / BK;
  const int r0 = q0 + (tid % 128) / 32 * 16 + lane / 4;   // and r0 + 8
  const int c0 = 2 * (lane % 4);

  load_tile<HD, 128>(q_s + wg * TB, q + b * qs.b + h * qs.h, qs.s, q0, S,
                     tid % 128);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) {
      const uint32_t slot = ring + t * 2 * TB;
      load_tile<HD, NT>(slot, kp, ks.s, t * BK, S, tid);
      load_tile<HD, NT>(slot + TB, vp, vs.s, t * BK, S, tid);
    }
    cp_async_commit();              // group t (group 0 holds Q too)
  }

  float acc[HD / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();    // tile t has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                // ... everyone's; tile t - 1 is consumed
    {
      const int tn = t + STAGES - 1;
      if (tn < ntiles) {
        const uint32_t slot = ring + (tn % STAGES) * 2 * TB;
        load_tile<HD, NT>(slot, kp, ks.s, tn * BK, S, tid);
        load_tile<HD, NT>(slot + TB, vp, vs.s, tn * BK, S, tid);
      }
      cp_async_commit();
    }
    const uint32_t k_s = ring + (t % STAGES) * 2 * TB, v_s = k_s + TB;

    // S = Q K^T
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<HD>(q_s + wg * TB, kk),
                   kmajor_desc<HD>(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragment. Only the last tile (the diagonal, or
    // the tail past S) is masked, in a branch of its own, so the others
    // carry no masking instructions; m is kept on the raw scores and the
    // scale enters each exponent's argument (log2 domain).
    if (t == ntiles - 1) {
      const int last0 = (causal ? min(S - 1, r0) : S - 1) - t * BK;
      const int last1 = (causal ? min(S - 1, r0 + 8) : S - 1) - t * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)   // column 8 (i / 4) + c0 + i % 2
        if (8 * (i / 4) + c0 + i % 2 > ((i / 2) % 2 ? last1 : last0))
          sc[i] = NEG_INF;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
    }
    // the first tile holds key 0, which every row sees: m is finite after it
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f((m0 - mx0) * scale_log2);
    const float alpha1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -mx0 * scale_log2, nm1 = -mx1 * scale_log2;
    // p in fp32 (summed into l), then split: hi = bf16(p), lo = bf16(p - hi);
    // A fragment register j of k-step kk is elements 8 kk + 2 j, + 1
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const bool lower = (i / 2) % 2;
      const float nm = lower ? nm1 : nm0;
      const float p0 = exp2f(fmaf(sc[i], scale_log2, nm));
      const float p1 = exp2f(fmaf(sc[i + 1], scale_log2, nm));
      if (lower) s1 += p0 + p1; else s0 += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i / 8][(i % 8) / 2] = bits(hi);
      p_lo[i / 8][(i % 8) / 2] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
    l0 = l0 * alpha0 + s0;
    l1 = l1 * alpha1 + s1;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i / 2) % 2 ? alpha1 : alpha0;

    // O += P_hi V + P_lo V
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<HD>(acc, p_hi[kk], mnmajor_desc<HD>(v_s, kk));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<HD>(acc, p_lo[kk], mnmajor_desc<HD>(v_s, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
  }
  cp_async_wait<0>();               // no copy outlives the block

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c0;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(op + r0 * os.s + col) =
          __halves2bfloat162(__float2bfloat16_rn(__fdiv_rn(acc[4 * j], d0)),
                             __float2bfloat16_rn(__fdiv_rn(acc[4 * j + 1], d0)));
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(op + (r0 + 8) * os.s + col) =
          __halves2bfloat162(__float2bfloat16_rn(__fdiv_rn(acc[4 * j + 2], d1)),
                             __float2bfloat16_rn(__fdiv_rn(acc[4 * j + 3], d1)));
  }
}

template <int HD, int NWG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int group, int S, const Strides* st,
                      int causal, float scale, cudaStream_t stream) {
  constexpr int SMEM = (NWG + 2 * STAGES) * Tile<HD>::BYTES + 1024;
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_tc_kernel<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (rc != cudaSuccess) return rc;
  if (group % NWG) return cudaErrorInvalidValue;  // heads of one KV head
  const long long blocks = static_cast<long long>((S + BQ - 1) / BQ) * Hq * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_tc_kernel<HD, NWG><<<static_cast<int>(blocks / NWG), 128 * NWG, SMEM,
                             stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, group, Hq, Hq * B / NWG, st[0], st[1], st[2], st[3], causal,
      static_cast<float>(scale * 1.4426950408889634));   // log2(e)
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_tc_hd(int hd, const void* q, const void* k, const void* v,
                         void* o, int B, int Hq, int group, int S,
                         const Strides* st, int causal, float scale,
                         cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32, NWG>(q, k, v, o, B, Hq, group, S, st, causal, scale, stream);
    case 64: return launch_tc<64, NWG>(q, k, v, o, B, Hq, group, S, st, causal, scale, stream);
    case 128: return launch_tc<128, NWG>(q, k, v, o, B, Hq, group, S, st, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(int B, int Hq, int Hkv, int S) {
  return B >= 1 && S >= 1 && Hkv >= 1 && Hq % Hkv == 0 && Hq <= 65535 &&
         B <= 65535;
}

void unpack(const long long* strides, Strides* st) {
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// strides: 12 int64, (batch, head, position) of q, k, v and o in that
// order, in elements. Each returns cudaGetLastError() after the launch;
// nothing is synchronised.

// fp32 q, k, v and out
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int hd, int B,
                                      int Hq, int Hkv, int S,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  if (!shape_ok(B, Hq, Hkv, S)) return cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  switch (hd) {
    case 32: return launch_fp32<32>(q, k, v, o, B, Hq, group, S, st, causal, scale, s);
    case 64: return launch_fp32<64>(q, k, v, o, B, Hq, group, S, st, causal, scale, s);
    case 128: return launch_fp32<128>(q, k, v, o, B, Hq, group, S, st, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 q, k, v and out, every pointer and stride 16-byte aligned;
// warpgroups: 1 or 2, the query heads a block (of one KV head: Hq / Hkv
// must be a multiple)
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int hd,
                                           int B, int Hq, int Hkv, int S,
                                           const long long* strides,
                                           int causal, float scale,
                                           int warpgroups, void* stream) {
  if (!shape_ok(B, Hq, Hkv, S)) return cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (warpgroups == 1)
    return launch_tc_hd<1>(hd, q, k, v, o, B, Hq, group, S, st, causal, scale, s);
  if (warpgroups == 2)
    return launch_tc_hd<2>(hd, q, k, v, o, B, Hq, group, S, st, causal, scale, s);
  return cudaErrorInvalidValue;
}
