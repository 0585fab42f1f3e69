// Blocked online-softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fa_kernel
// (pl.pallas_call at :137): o = softmax(q k^T * scale, masked) v for
// q (B, Hq, T, D) against k, v (B, Hkv, S, D), GQA through h / (Hq / Hkv),
// causal and sliding-window masks, f32 math, o in q's dtype and the row
// log-sum-exp in f32 on request.  Masked scores are -1e30, not -inf, as in
// _fa_kernel: a row masked so far takes p = 1 for its masked keys until a
// visible key arrives and alpha = exp(-1e30 - m) = 0 clears them.  Keys
// past S contribute nothing.  An empty row gives o = 0 and lse = -1e30.
// Only the KV tiles that _fa_kernel's block-level `visible` test admits
// are loaded.  Two routes, chosen by dtype:
//
// bf16 (fa_fwd_tc, the serving path).  What bounds it on this card: at the
// served shape (recurrentgemma-2b: q (4, 10, 3072, 256), one KV head,
// window 2048) the mask admits ~1.7e8 (q, k) pairs, 1.7e11 flop against
// ~139 MB of inputs and output: bound by operations, ~0.17 ms at 989
// TFLOP/s on the tensor cores.  Design: one CTA per (b*Hq + h, 64 query
// rows): one consumer warpgroup and one producer warp whose single thread
// issues TMA loads (3-D tensor maps over (D, rows, b*heads), 64 x 64
// boxes, 128-byte swizzle, zero fill past the ends).  Q is loaded once; K
// and V tiles of 64 keys go through a ring of two shared-memory stages
// signalled by mbarriers (full: the TMA bytes landed; empty: the four
// consumer warps finished with the stage).  At D = 256 that is Q 32 KB +
// 2 x (K 32 KB + V 32 KB) = 160 KB.  S = Q K^T by wgmma m64n64k16 with
// both operands from shared memory (bf16 products are exact in f32); the
// scale is applied to S in f32 after the product, folded with log2(e) so
// the online softmax runs on exp2f; the element mask only on tiles that
// cross the diagonal, the window edge or S.  The TPU kernel multiplies P
// in f32; rounding P to bf16 once moves o by up to ~100 bf16 ulps where
// outputs cancel to near 0, so O += P_hi V + P_lo V with P_hi = bf16(P),
// P_lo = bf16(P - P_hi), both by wgmma with A from registers (the S
// accumulator's layout is the A fragment's) and V from shared memory
// through the transposed (MN-major) descriptor: 1.5x the products of a
// plain bf16 kernel, and o within one bf16 ulp of the f32 product.  The O
// accumulator alone is 128 registers a thread at D = 256.  Two consumer
// warpgroups (128 rows a CTA) were measured first: ptxas budgets every
// thread at 168 registers there, with 288 threads as with 384 and
// whatever setmaxnreg asks, and the D = 256 instance spills and
// serializes its wgmmas (1.09-1.17 ms at the served shape against 0.745
// ms for this layout, whose 160 threads leave 255 registers a thread; it
// uses 219 and spills nothing; both on an H100 80GB HBM3 at 700 W).  D must
// be a multiple of 16 and at most 256; D is padded to whole 64-column
// chunks by the TMA's zero fill.
//
// f32 (fa_fwd, not on the serving path; the f32 test configurations).
// One CTA per (b*Hq + h, 32 query rows), one warp per 4 rows, K and V
// tiles of 32 keys staged in shared memory as f32, every product an f32
// FMA on the CUDA cores (67 TFLOP/s).  This was the first design for bf16
// too: at the served shape it measured 13.11-13.21 ms, 76x its bound and
// 8.3x scaled_dot_product_attention, on an H100 80GB HBM3 at 700 W.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------ f32: the CUDA cores
constexpr int BK = 32;           // keys per tile: one per lane for the scores
constexpr int WARPS = 8;         // warps per CTA
constexpr int RPW = 4;           // query rows per warp
constexpr int BQ = WARPS * RPW;  // query rows per CTA
constexpr int MAX_D = 256;
constexpr int DPL = MAX_D / 32;  // accumulator dims per lane: d = lane + 32 i
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

size_t smem_bytes(int D) {
  return sizeof(float) * (2 * BK * (D + 4) + BQ * D);
}

__global__ void __launch_bounds__(WARPS * 32)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Tq, int S,
       int D, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks = D + 4;        // padded row stride of the K and V tiles
  float* k_s = smem;           // BK x ks
  float* v_s = k_s + BK * ks;  // BK x ks
  float* q_s = v_s + BK * ks;  // BQ x D, q * scale
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;  // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q_start = blockIdx.x * BQ;
  const float* kb = k + (size_t)kvh * S * D;
  const float* vb = v + (size_t)kvh * S * D;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, row = q_start + r;
    q_s[i] = row < Tq ? (q[((size_t)bh * Tq + row) * D + (i - r * D)]) * scale : 0.f;
  }

  float acc[RPW][DPL];
  float m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const int row0 = q_start + warp * RPW;
  const float* qw = q_s + warp * RPW * D;

  const int n_kv = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    // _fa_kernel's block-level test, uniform over the CTA
    if (causal && k_start > q_start + BQ - 1) break;
    if (window > 0 && k_start + BK - 1 <= q_start - window) continue;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, key = k_start + j;
      const bool in = key < S;
      k_s[j * ks + d] = in ? (kb[(size_t)key * D + d]) : 0.f;
      v_s[j * ks + d] = in ? (vb[(size_t)key * D + d]) : 0.f;
    }
    __syncthreads();

    // lane j: the score of key k_start + j against each of the warp's rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* kr = k_s + lane * ks;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int key = k_start + lane;
    float p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      bool ok = key < S;
      if (causal) ok = ok && row >= key;
      if (window > 0) ok = ok && key > row - window;
      const float sr = ok ? s[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      p[r] = key < S ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float* vr = v_s + j * ks;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vr[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
    if (row >= Tq) continue;
    const float lsafe = l[r] == 0.f ? 1.f : l[r];
    float* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = acc[r][i] / lsafe;
    }
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Tq + row] = l[r] == 0.f ? NEG_INF : m[r] + logf(lsafe);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int Hq, int Hkv, int Tq, int S, int D, int causal, int window, float scale,
           size_t smem_plan, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem != smem_plan) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
  fa_fwd<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), Hq, Hkv, Tq, S, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}


// ------------------------------------------- bf16: the tensor cores
constexpr int TC_CONSUMERS = 1;       // consumer warpgroups of 64 query rows
constexpr int TC_BM = 64 * TC_CONSUMERS;         // query rows a CTA
constexpr int TC_BN = 64;                        // keys a K/V tile
constexpr int TC_STAGES = 2;                     // K/V ring
constexpr int TC_THREADS = 128 * TC_CONSUMERS + 32;  // + the producer warp
constexpr int CHUNK_BYTES = 64 * 128; // 64 rows x 64 bf16 columns, 128-byte swizzle
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int NCH>
constexpr size_t tc_smem_bytes() {  // + 1024 to align the tiles, + barriers
  return (size_t)(TC_CONSUMERS * NCH + 2 * TC_STAGES * NCH) * CHUNK_BYTES + 1024 + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts 2^26 polls (seconds, against microseconds for a tile) is a
// broken pipeline, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register accesses across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// S (64 x 64, f32) (+)= A (64 x 16, shared, K-major) B^T (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64, f32) += A (64 x 16 bf16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, f32) += A (64 x 16 bf16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 192, f32) += A (64 x 16 bf16, registers) B (16 x 192, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 256, f32) += A (64 x 16 bf16, registers) B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// may any (row, key) pair of rows [q0, q0 + nq) and keys [k0, k0 + nk) interact?
__device__ __forceinline__ bool tile_visible(int q0, int nq, int k0, int nk, int causal,
                                             int window) {
  bool ok = true;
  if (causal) ok = ok && k0 <= q0 + nq - 1;
  if (window > 0) ok = ok && k0 + nk - 1 > q0 - window;
  return ok;
}

template <int NCH>
__global__ void __launch_bounds__(TC_THREADS, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
          float* __restrict__ lse, int Hq, int Hkv, int Tq, int S, int D, int causal,
          int window, float scale_log2) {
  constexpr int N = NCH * 64;  // padded head dim: the P V product's width
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;              // [consumer][NCH] chunks
  const uint32_t k_s = q_s + TC_CONSUMERS * NCH * CHUNK_BYTES;  // [stage][NCH]
  const uint32_t v_s = k_s + TC_STAGES * NCH * CHUNK_BYTES;
  const uint32_t bars = v_s + TC_STAGES * NCH * CHUNK_BYTES;
  const uint32_t q_full = bars;                 // then full[s], empty[s]
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + TC_STAGES + s); };

  const int bh = blockIdx.y, b = bh / Hq, h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q_start = (gridDim.x - 1 - blockIdx.x) * TC_BM;  // the longest rows first
  const int n_kv = (S + TC_BN - 1) / TC_BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * TC_CONSUMERS);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == TC_CONSUMERS) {  // --------------------------- producer warp
    if (threadIdx.x == 128 * TC_CONSUMERS) {
      mbar_expect_tx(q_full, TC_CONSUMERS * NCH * CHUNK_BYTES);
      for (int w = 0; w < TC_CONSUMERS; ++w)
        for (int c = 0; c < NCH; ++c)
          tma_load(q_s + (w * NCH + c) * CHUNK_BYTES, &map_q, c * 64, q_start + 64 * w,
                   bh, q_full);
      int i = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        if (!tile_visible(q_start, TC_BM, kt * TC_BN, TC_BN, causal, window)) continue;
        const int stage = i % TC_STAGES, round = i / TC_STAGES;
        if (round > 0) mbar_wait(empty(stage), (round - 1) & 1);
        mbar_expect_tx(full(stage), 2 * NCH * CHUNK_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(k_s + (stage * NCH + c) * CHUNK_BYTES, &map_k, c * 64, kt * TC_BN, kvh,
                   full(stage));
          tma_load(v_s + (stage * NCH + c) * CHUNK_BYTES, &map_v, c * 64, kt * TC_BN, kvh,
                   full(stage));
        }
        ++i;
      }
    }
  } else {  // --------------------------------------------- consumers
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q_start + 64 * wg;  // this warpgroup's first row
    const int r_a = row0 + 16 * warp + lane / 4, r_b = r_a + 8;  // this thread's rows
    const int colq = 2 * (lane % 4);
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    const uint32_t q_wg = q_s + wg * NCH * CHUNK_BYTES;
    mbar_wait(q_full, 0);

    int i = 0;
    for (int kt = 0; kt < n_kv; ++kt) {
      const int k_start = kt * TC_BN;
      if (!tile_visible(q_start, TC_BM, k_start, TC_BN, causal, window)) continue;
      const int stage = i % TC_STAGES, round = i / TC_STAGES;
      mbar_wait(full(stage), round & 1);
      if (tile_visible(row0, 64, k_start, TC_BN, causal, window)) {
        // S = Q K^T over D in steps of 16 (32 bytes of a 128-byte row).
        // q_tile is opaque to the compiler, so that it builds each
        // descriptor where it is used rather than keep all of them live
        // across the loop in registers the O accumulator needs.
        float s[32];
        const uint32_t q_tile = opaque(q_wg);
        const uint32_t k_tile = k_s + stage * NCH * CHUNK_BYTES;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(s, desc(q_tile + c * CHUNK_BYTES + 32 * kk, 16, 1024),
                         desc(k_tile + c * CHUNK_BYTES + 32 * kk, 16, 1024), c + kk > 0);
        wgmma_commit_wait();
        fence_regs(s);

        // scale (in the log2 domain), mask, online softmax
        const bool masked = k_start + TC_BN > S ||
                            (causal && k_start + TC_BN - 1 > row0) ||
                            (window > 0 && k_start <= row0 + 63 - window);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float x = s[j] * scale_log2;
          if (masked) {
            const int key = k_start + 8 * (j / 4) + colq + (j & 1);
            const int row = (j & 2) ? r_b : r_a;
            bool ok = key < S;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && key > row - window;
            x = ok ? x : (key < S ? NEG_INF : -INFINITY);
          }
          s[j] = x;
          if (j & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t p_hi[16], p_lo[16];
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const float mm = (j & 2) ? mn_b : mn_a;
          const float p0 = exp2f(s[j] - mm), p1 = exp2f(s[j + 1] - mm);
          if (j & 2) sum_b += p0 + p1; else sum_a += p0 + p1;
          const uint32_t hi = pack_bf16(p0, p1);
          p_hi[j / 2] = hi;
          p_lo[j / 2] = pack_bf16(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
        }
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int j = 0; j < N / 2; ++j) acc[j] *= (j & 2) ? al_b : al_a;

        // O += P_hi V + P_lo V, 16 keys (2 KB of the V tile) a step
        const uint32_t v_tile = v_s + stage * NCH * CHUNK_BYTES;
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t dv = desc(v_tile + t * 16 * 128, CHUNK_BYTES, 1024);
          wgmma_rs(acc, p_hi + 4 * t, dv);
          wgmma_rs(acc, p_lo + 4 * t, dv);
        }
        wgmma_commit_wait();
        fence_regs(acc);
        fence_regs(p_hi);
        fence_regs(p_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
      ++i;
    }

    // finalize as _fa_kernel: lsafe, and lse = -1e30 for an empty row
    const float ls_a = l_a == 0.f ? 1.f : l_a, ls_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
    for (int j = 0; j < N / 2; j += 2) {
      const int row = (j & 2) ? r_b : r_a, col = 8 * (j / 4) + colq;
      const float ls = (j & 2) ? ls_b : ls_a;
      if (row < Tq && col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * Tq + row) * D + col) =
            __floats2bfloat162_rn(acc[j] / ls, acc[j + 1] / ls);
    }
    if (lse != nullptr && lane % 4 == 0) {
      const float ma = m_a == NEG_INF ? NEG_INF : m_a * LN2;
      const float mb = m_b == NEG_INF ? NEG_INF : m_b * LN2;
      if (r_a < Tq) lse[(size_t)bh * Tq + r_a] = l_a == 0.f ? NEG_INF : ma + logf(ls_a);
      if (r_b < Tq) lse[(size_t)bh * Tq + r_b] = l_b == 0.f ? NEG_INF : mb + logf(ls_b);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the build links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (planes, rows, D) bf16 as a 3-D tensor map of 64 x 64 boxes, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int D, int rows, int planes) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH>
int launch_tc(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq,
              int Hkv, int Tq, int S, int D, int causal, int window, float scale,
              size_t smem_plan, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<NCH>();
  if (smem != smem_plan) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, Tq, B * Hq) || !make_map(&mk, k, D, S, B * Hkv) ||
      !make_map(&mv, v, D, S, B * Hkv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_tc<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + TC_BM - 1) / TC_BM, B * Hq);
  fa_fwd_tc<NCH><<<grid, TC_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Hq, Hkv, Tq, S,
      D, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32 (the CUDA-core kernel, D a multiple of 4), 1: bfloat16
// (the tensor-core kernel, D a multiple of 16; q, k, v 16-byte aligned).
// D <= 256.  lse may be null.  window <= 0: none.  smem: the bytes of
// shared memory a CTA that the caller's plan (flash_attention.smem_bytes)
// counts for the route.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue where smem is not the route's own count).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B, int Hq,
                                   int Hkv, int T, int S, int D, int causal,
                                   int window, float scale, size_t smem, void* stream) {
  if (D < 1 || D > MAX_D || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D % 4 != 0) return (int)cudaErrorInvalidValue;
    return launch_f32(q, k, v, o, lse, B, Hq, Hkv, T, S, D, causal, window, scale, smem, s);
  }
  if (dtype != 1 || D % 16 != 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch ((D + 63) / 64) {
#define FA_TC(NCH) \
  launch_tc<NCH>(q, k, v, o, lse, B, Hq, Hkv, T, S, D, causal, window, scale, smem, s)
    case 1: return FA_TC(1);
    case 2: return FA_TC(2);
    case 3: return FA_TC(3);
    default: return FA_TC(4);
#undef FA_TC
  }
}
