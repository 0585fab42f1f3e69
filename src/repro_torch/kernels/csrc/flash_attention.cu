// Blocked online-softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_fa_kernel
// (pl.pallas_call at :137): o = softmax(q k^T * scale, masked) v for
// q (B, Hq, T, D) against k, v (B, Hkv, S, D), GQA through h / (Hq / Hkv),
// causal and sliding-window masks, f32 math over bf16 or f32 inputs, o in
// q's dtype and the row log-sum-exp in f32 on request.  An empty row gives
// o = 0 and lse = -1e30.
//
// What bounds it on this card.  At the served shape (recurrentgemma-2b:
// q (4, 10, 3072, 256), one KV head, window 2048) the mask admits ~1.7e8
// (q, k) pairs, 1.7e11 flop, against ~139 MB of inputs and output: the
// function is bound by operations (~0.17 ms at 989 TFLOP/s bf16).  This
// first version uses no tensor cores: it runs every product as an f32 FMA
// on the CUDA cores (67 TFLOP/s), and its inner loops read each staged
// key and value from shared memory once per warp, so shared-memory
// bandwidth, not device memory, sets its pace.
//
// Design.  One CTA per (b*Hq + h, block of BQ = 32 query rows); one warp
// per RPW = 4 query rows, so each shared-memory read of a key or value
// serves four rows.  K and V tiles of BK = 32 rows are staged in shared
// memory as f32 (rows padded by 4 floats, so the per-lane float4 reads of
// different keys hit different banks).  Scores: lane j computes key j's
// dot product with each of its warp's rows (q pre-scaled in shared memory,
// read as broadcasts).  Online softmax per row in f32 with NEG_INF = -1e30,
// exactly as _fa_kernel: a row masked so far takes p = exp(0) = 1 for its
// masked keys until a visible key arrives and alpha = exp(-1e30 - m) = 0
// clears them (with -INFINITY, exp(m_prev - m_new) would be NaN there).
// The accumulator holds dims d = lane + 32 i of each row; p_j reaches the
// lanes by __shfl_sync.  Only the KV tiles that _fa_kernel's block-level
// `visible` test admits are loaded, so the window skips whole tiles.
// Keys past S (a ragged last tile) contribute nothing.  Tensor cores
// (mma.sync / wgmma) and asynchronous tile loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BK = 32;           // keys per tile: one per lane for the scores
constexpr int WARPS = 8;         // warps per CTA
constexpr int RPW = 4;           // query rows per warp
constexpr int BQ = WARPS * RPW;  // query rows per CTA
constexpr int MAX_D = 256;
constexpr int DPL = MAX_D / 32;  // accumulator dims per lane: d = lane + 32 i
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int Tq, int S,
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
  const T* kb = k + (size_t)kvh * S * D;
  const T* vb = v + (size_t)kvh * S * D;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, row = q_start + r;
    q_s[i] = row < Tq ? to_f(q[((size_t)bh * Tq + row) * D + (i - r * D)]) * scale : 0.f;
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
      k_s[j * ks + d] = in ? to_f(kb[(size_t)key * D + d]) : 0.f;
      v_s[j * ks + d] = in ? to_f(vb[(size_t)key * D + d]) : 0.f;
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
    T* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store(orow + d, acc[r][i] / lsafe);
    }
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Tq + row] = l[r] == 0.f ? NEG_INF : m[r] + logf(lsafe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int Hq, int Hkv, int Tq, int S, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
  fa_fwd<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), Hq, Hkv, Tq, S, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  lse may be null.  window <= 0: none.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B, int Hq,
                                   int Hkv, int T, int S, int D, int causal,
                                   int window, float scale, void* stream) {
  if (D > MAX_D || D % 4 != 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, B, Hq, Hkv, T, S, D, causal, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, T, S, D, causal, window,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
