// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_rglru_kernel
// (pl.pallas_call at :78): over x, a (B, T, D) and h0 (B, D), returns every
// h_t (B, T, D) and h_last (B, D), both in x's dtype, with f32 math.
//
// What bounds it on this card.  The function reads x and a and writes h:
// 12 bytes an element in f32, ~377 MB at the served shape (4, 3072, 2560),
// ~0.11 ms at 3.35 TB/s; its two flops an element are nothing beside that.
// So it is bound by bytes.
//
// Design.  One thread per (b, d) channel walks T in order with
// h = fmaf(a, h, x) in f32; neighbouring threads take neighbouring d, so
// every load and store of a warp is one coalesced 128-byte line.  Each
// thread loads UNROLL steps of x and a before it starts their chain, to
// keep more loads in flight than its one dependent FMA per step would.
// The Hillis-Steele network of the TPU kernel is a device for the TPU's
// vector unit and is not carried over: the sequential chain gives the same
// h up to rounding.  B*D threads (10,240 at the served shape) do not fill
// the card's memory pipes; a chunked two-pass design (scan within time
// chunks in parallel, then carry across chunks) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_fwd(const T* __restrict__ x, const T* __restrict__ a,
          const float* __restrict__ h0, T* __restrict__ h, T* __restrict__ h_last,
          int B, int Tn, int D) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;  // b * D + d
  if (idx >= B * D) return;
  const int b = idx / D, d = idx - b * D;
  const size_t base = (size_t)b * Tn * D + d;
  float hv = h0[idx];
  int t = 0;
  for (; t + UNROLL <= Tn; t += UNROLL) {
    float xv[UNROLL], av[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      xv[u] = to_f(x[base + (size_t)(t + u) * D]);
      av[u] = to_f(a[base + (size_t)(t + u) * D]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hv = fmaf(av[u], hv, xv[u]);
      store(h + base + (size_t)(t + u) * D, hv);
    }
  }
  for (; t < Tn; ++t) {
    hv = fmaf(to_f(a[base + (size_t)t * D]), hv, to_f(x[base + (size_t)t * D]));
    store(h + base + (size_t)t * D, hv);
  }
  store(h_last + idx, hv);
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* h, void* h_last, int B,
           int Tn, int D, cudaStream_t stream) {
  const int blocks = (B * D + THREADS - 1) / THREADS;
  rglru_fwd<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(h), static_cast<T*>(h_last), B,
      Tn, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, a, h, h_last); h0 is float32.
// Returns the cudaError_t of the launch.
extern "C" int rglru_scan_fwd(const void* x, const void* a, const void* h0, void* h,
                              void* h_last, int dtype, int B, int T, int D,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, h0, h, h_last, B, T, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, a, h0, h, h_last, B, T, D, s);
  return (int)cudaErrorInvalidValue;
}
