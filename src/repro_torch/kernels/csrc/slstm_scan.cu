// The sLSTM recurrence (xLSTM) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/slstm_scan.py::_slstm_kernel
// (pl.pallas_call at :121).  Per step t, for every batch row and channel:
//   g_x = pre[b, t, x] + sum_k h[head, k] * R_x[head, k, e]   (x = i, f, z, o)
//   li = g_i, lf = log_sigmoid(g_f), z = tanh(g_z), o = sigmoid(g_o)
//   m' = max(lf + m, li)
//   c = c exp(lf + m - m') + exp(li - m') z,  n = n exp(lf + m - m') + exp(li - m')
//   h = o c / max(n, 1),  m = m'
// with R block-diagonal by head, R_x (H, hd, hd) in bf16 or f32, pre
// (B, T, 4, d) and the carry (c, n, h, m) (B, d) in f32.  It writes the h, c,
// n and m sequences (B, T, d) and the final carry.
//
// What bounds it on this card.  Reading pre and writing the four sequences
// is ~302 MB at the served shape (xlstm-125m, B 4, T 3072, d 768, H 4, hd
// 192): ~0.09 ms at 3.35 TB/s.  The recurrent products are 4 * 2 * hd * d
// flop a (b, t), 1.45e10 in all, in f32 (the reference widens R to f32):
// ~0.22 ms at 67 TFLOP/s, so the function is bound by operations.  Beyond
// both, the 3,072 steps form a chain: a step cannot start before the last
// one's h is known, so every step pays a block-wide barrier twice and the
// latency of its loads.
//
// Design.  One CTA per (b, head) runs the whole sequence in one launch,
// with 4 * hd threads (768 at hd 192): thread (g, e) forms gate g's
// pre-activation of channel head*hd + e, reading h_{t-1} of the head from
// shared memory (a broadcast) and column e of R_g from global memory,
// coalesced over e.  R is 4 x 4 x 192 x 192 bf16 = 1.18 MB in all, resident
// in the 50 MB L2 after the first step.  After a barrier, hd threads apply
// the gating exactly as slstm_scan.py:41-49 does, with log_sigmoid(x) =
// -(max(-x, 0) + log1p(exp(-|x|))) as jax.nn.log_sigmoid computes it, and
// store h back for the next step.  m starts at -inf: expf(-inf) == 0 and
// IEEE expf/log1pf/tanhf are relied on, so this file must not be built with
// --use_fast_math.  The TPU kernel keeps R resident in VMEM; here one head's
// R (295 KB in bf16) is over an SM's 227 KB of shared memory, so it streams
// from L2 every step.  Splitting R across a thread-block cluster and
// exchanging h through distributed shared memory is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

struct SlstmArgs {
  const void* r[4];  // R_i, R_f, R_z, R_o: (H, hd, hd)
  const float* pre;  // (B, T, 4, d)
  const float* c0;
  const float* n0;
  const float* h0;
  const float* m0;   // (B, d) each
  float* hs;
  float* cs;
  float* ns;
  float* ms;         // (B, T, d) each
  float* cf;
  float* nf;
  float* hf;
  float* mf;         // (B, d) each
  int T, H, hd;
};

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename R>
__global__ void slstm_fwd(SlstmArgs args) {
  extern __shared__ float smem[];
  const int hd = args.hd, H = args.H, Tn = args.T, d = H * hd;
  float* h_s = smem;       // hd: h_{t-1} of this head
  float* g_s = smem + hd;  // 4 x hd: the gates' pre-activations
  const int b = blockIdx.x / H, head = blockIdx.x - b * H;
  const int tid = threadIdx.x, g = tid / hd, e = tid - g * hd;
  const R* rg = static_cast<const R*>(args.r[g]) + (size_t)head * hd * hd + e;
  const size_t vec = (size_t)b * d + head * hd + tid;  // (B, d) offset, tid < hd
  float c = 0.f, n = 0.f, h = 0.f, m = 0.f;
  if (tid < hd) {
    c = args.c0[vec];
    n = args.n0[vec];
    h = args.h0[vec];
    m = args.m0[vec];
    h_s[tid] = h;
  }
  __syncthreads();
  for (int t = 0; t < Tn; ++t) {
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < hd; ++k) acc = fmaf(h_s[k], to_f(rg[(size_t)k * hd]), acc);
    g_s[tid] = args.pre[(((size_t)b * Tn + t) * 4 + g) * d + head * hd + e] + acc;
    __syncthreads();
    if (tid < hd) {
      const float li = g_s[tid];
      const float lf = log_sigmoid(g_s[hd + tid]);
      const float z = tanhf(g_s[2 * hd + tid]);
      const float o = sigmoid(g_s[3 * hd + tid]);
      const float m_new = fmaxf(lf + m, li);
      const float fdec = expf(lf + m - m_new), idec = expf(li - m_new);
      c = c * fdec + idec * z;
      n = n * fdec + idec;
      h = o * c / fmaxf(n, 1.f);
      m = m_new;
      const size_t seq = ((size_t)b * Tn + t) * d + head * hd + tid;
      args.hs[seq] = h;
      args.cs[seq] = c;
      args.ns[seq] = n;
      args.ms[seq] = m;
      h_s[tid] = h;
    }
    __syncthreads();
  }
  if (tid < hd) {
    args.cf[vec] = c;
    args.nf[vec] = n;
    args.hf[vec] = h;
    args.mf[vec] = m;
  }
}

}  // namespace

// r_dtype 0: float32, 1: bfloat16.  4 * hd threads a block, so hd <= 256.
// Returns the cudaError_t of the launch.
extern "C" int slstm_scan_fwd(const SlstmArgs* args, int r_dtype, int B, void* stream) {
  const int threads = 4 * args->hd;
  if (threads > 1024 || args->hd < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 5 * args->hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = B * args->H;
  if (r_dtype == 0)
    slstm_fwd<float><<<blocks, threads, smem, s>>>(*args);
  else if (r_dtype == 1)
    slstm_fwd<__nv_bfloat16><<<blocks, threads, smem, s>>>(*args);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
