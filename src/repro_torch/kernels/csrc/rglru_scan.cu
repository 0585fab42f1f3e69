// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_rglru_kernel
// (pl.pallas_call at :78): over x, a (B, T, D) and h0 (B, D), returns every
// h_t (B, T, D) and h_last (B, D), both in x's dtype, with f32 math.
//
// What bounds it on this card.  The function reads x and a and writes h:
// 12 bytes an element in f32, 377.5 MB at the served shape (4, 3072, 2560),
// 0.1127 ms at 3.35 TB/s; its two flops an element are nothing beside that.
// So it is bound by bytes, and the kernel must keep enough of them in
// flight.  One thread a channel walking all T steps (the first design) has
// only B*D = 10,240 threads there, ~1.2 warps an SM, and reached a third of
// the rate.
//
// Design: a chunked single-pass scan with decoupled look-back.  A CTA takes
// one (b, tile of 32 channels, chunk of CHUNK = S * STEPS steps); its S
// warps are the chunk's S sub-chunks of STEPS steps, a lane one channel, so
// each f32 load and store of a warp is one 128-byte row.
//   1. Each thread loads its sub-chunk's a and x into registers (2 * STEPS
//      loads in flight before the first FMA) and reduces them to the
//      sub-chunk's affine map (A = prod a, X = the chain from 0).
//   2. Warp 0 scans the S maps in shared memory: each sub-chunk's exclusive
//      prefix and the chunk's map.
//   3. Warp 0 finds the chunk's carry-in by look-back, each lane for its own
//      channel.  Chunk 0 publishes its inclusive h as the map (0, h); every
//      later chunk publishes its own map at once, then composes the maps of
//      chunks c - 1, ..., 0 in that order.  The carry is thus the same
//      association of the same maps on every call, whatever the timing: h
//      is deterministic.  The nearest WINDOW maps are loaded in step 1,
//      beside a and x, by all S warps (a map still unpublished then is
//      loaded again until it is), so at the served shape the look-back adds
//      no round trip of its own; farther ones are loaded LOOKBACK at a
//      time.  A published
//      map is one 8-byte (A, X) pair, written and read whole at gpu scope;
//      the wrapper's clear fills every pair with EMPTY bits, which no
//      published float has (a NaN is published as the canonical one), so
//      each half is its own flag and no fence is needed.  Chunks are
//      numbered by an atomic counter in the order CTAs start, chunk-major,
//      so a CTA waits only on CTAs that are already running, none of which
//      waits on anything: no deadlock.
//   4. Every thread reruns h = fmaf(a, h, x) from its sub-chunk's carry-in
//      over the a and x still in its registers and stores h.
// a and x are read once and h written once (12 B an element in f32); the
// status pairs (8 B a channel and chunk, 0.98 MB at the served shape) and
// the counter are cleared by rglru_clear, launched before rglru_fwd on the
// same stream.  Within a sub-chunk h is a sequential FMA chain as before;
// the compositions across sub-chunks and chunks are the only new
// roundings.
//
// Why the TPU's Hillis-Steele network is not carried over: it suits a
// vector unit that steps a whole (bt, bd) block in lockstep, at
// O(bt log bt) work.  Here a thread's sequential chain over registers costs
// one FMA a step, and the parallelism comes from many chunks in flight.
//
// Chunk size: RGLRU_CHUNK, 256 steps, from the sweep of rg-full in
// chip_smoke.py at the served shape in f32, which builds the other sizes
// with -DRGLRU_CHUNK=n (H100 80GB HBM3 at 700 W, two runs; bound
// 0.1127 ms): 64 steps 0.1555-0.1569 ms, 128 0.1409-0.1412, 256
// 0.1396-0.1398, 512 0.1487-0.1512.  At 64 a chunk composes up to 47
// maps, 43 beyond its prefetch window of 4; 512 has 1,920 CTAs of 512
// threads, one an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef RGLRU_CHUNK
#define RGLRU_CHUNK 256
#endif

namespace {

constexpr int STEPS = 32;  // steps a thread keeps in registers
constexpr int CHUNK = RGLRU_CHUNK;
constexpr int S = CHUNK / STEPS;  // warps a CTA
static_assert(CHUNK % STEPS == 0 && S >= 1 && S <= 32, "CHUNK: 32 to 1024 steps by 32");
constexpr int PREFETCH = 2;  // predecessors' maps a warp loads with its a and x
constexpr int WINDOW = S * PREFETCH;  // the nearest predecessors, prefetched
constexpr int LOOKBACK = 8;  // maps composed a batch (farther ones loaded then)
// Residency asked of ptxas through the launch bounds: 512 threads an SM
// leave a thread up to 128 registers; at 768 (80 registers) the 64 of a
// and x spilled.
constexpr int THREADS_PER_SM = 512;
constexpr int MIN_CTAS = THREADS_PER_SM / (32 * S) > 0 ? THREADS_PER_SM / (32 * S) : 1;
constexpr long long MAX_POLLS = 1LL << 24;  // then trap instead of hanging
constexpr unsigned EMPTY = 0xFFFFFFFFu;     // a NaN no published value has
constexpr unsigned CANONICAL_NAN = 0x7FFFFFFFu;

// One channel of type T: raw loads, identity steps, f32 math.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  using raw = float;
  static __device__ __forceinline__ raw load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ raw one() { return 1.0f; }
  static __device__ __forceinline__ raw zero() { return 0.0f; }
  static __device__ __forceinline__ float unpack(raw r) { return r; }
  static __device__ __forceinline__ void store(float* p, float f) { *p = f; }
};

template <>
struct Pack<__nv_bfloat16> {
  using raw = unsigned short;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ raw one() { return 0x3F80; }
  static __device__ __forceinline__ raw zero() { return 0; }
  static __device__ __forceinline__ float unpack(raw r) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float f) {
    *p = __float2bfloat16_rn(f);
  }
};

__device__ __forceinline__ unsigned bits_of(float v) {
  const unsigned u = __float_as_uint(v);
  return u == EMPTY ? CANONICAL_NAN : u;
}

// A chunk's map (A, X) into its status pair.
__device__ __forceinline__ void publish(uint2* p, float A, float X) {
  asm volatile("st.relaxed.gpu.global.v2.b32 [%0], {%1, %2};" ::"l"(p), "r"(bits_of(A)),
               "r"(bits_of(X))
               : "memory");
}

__device__ __forceinline__ uint2 peek(const uint2* p) {
  uint2 w;
  asm volatile("ld.relaxed.gpu.global.v2.b32 {%0, %1}, [%2];"
               : "=r"(w.x), "=r"(w.y)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ bool ready(uint2 w) { return w.x != EMPTY && w.y != EMPTY; }

// status: n * 32 pairs (n = B * n_tiles * n_chunks), chunk-major like the
// CTA numbers, then the chunk counter (one more pair); all cleared at launch.
template <typename T>
__global__ void __launch_bounds__(32 * S, MIN_CTAS)
rglru_fwd(const T* __restrict__ x, const T* __restrict__ a,
          const float* __restrict__ h0, T* __restrict__ h, T* __restrict__ h_last,
          uint2* __restrict__ status, int B, int Tn, int D, int n_tiles, int n_chunks) {
  using P = Pack<T>;
  __shared__ float sA[S][32], sX[S][32];
  __shared__ uint2 sPrev[WINDOW][32];  // chunk c - 1 - k's map in row k
  __shared__ int s_id;

  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int per_chunk = B * n_tiles;
  unsigned int* counter =
      reinterpret_cast<unsigned int*>(status + (size_t)per_chunk * n_chunks * 32);
  if (threadIdx.x == 0) s_id = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int id = s_id;  // chunk-major: id = (c * B + b) * n_tiles + tile
  const int c = id / per_chunk, r = id - c * per_chunk;
  const int b = r / n_tiles, tile = r - b * n_tiles;
  const int d = tile * 32 + lane;
  const bool live = d < D;
  const int t0 = c * CHUNK + s * STEPS;
  const int len = max(0, min(STEPS, Tn - t0));  // steps of the sub-chunk inside T
  const size_t base = ((size_t)b * Tn + t0) * D + d;
  uint2* me = status + (size_t)id * 32 + lane;
  const size_t hop = (size_t)per_chunk * 32;  // pairs from one chunk to the next

  // 1. the sub-chunk's a and x into registers (identity steps past T), and
  //    its affine map
  typename P::raw ra[STEPS], rx[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const bool in = live && u < len;
    ra[u] = in ? P::load(a + base + (size_t)u * D) : P::one();
    rx[u] = in ? P::load(x + base + (size_t)u * D) : P::zero();
  }
  // the nearest predecessors' maps, loaded beside a and x (most are
  // published by now: a chunk's CTAs start B * n_tiles after the last's)
  uint2 pre[PREFETCH];
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p) {
    const int k = s + p * S;
    if (k < c) pre[p] = peek(me - (size_t)(k + 1) * hop);
  }
  float A = 1.0f, X = 0.0f;
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const float au = P::unpack(ra[u]);
    X = fmaf(au, X, P::unpack(rx[u]));
    A *= au;
  }
  sA[s][lane] = A;
  sX[s][lane] = X;
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p) {
    if (s + p * S < c) sPrev[s + p * S][lane] = pre[p];
  }
  __syncthreads();

  if (s == 0) {
    // 2. exclusive prefix of each sub-chunk (in place) and the chunk's map
    float CA = 1.0f, CX = 0.0f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float Ak = sA[k][lane], Xk = sX[k][lane];
      sA[k][lane] = CA;
      sX[k][lane] = CX;
      CX = fmaf(Ak, CX, Xk);
      CA *= Ak;
    }
    // 3. the carry-in: h0 for chunk 0, else the maps of chunks c - 1 .. 0
    //    (prefetched, or loaded now; reloaded until published)
    float carry;
    if (c == 0) {
      carry = live ? h0[(size_t)b * D + d] : 0.0f;
      publish(me, 0.0f, fmaf(CA, carry, CX));
    } else {
      publish(me, CA, CX);
      float accA = 1.0f, accX = 0.0f;  // the map of the chunks after j
      long long polls = 0;
      for (int j = c - 1; j >= 0; j -= LOOKBACK) {
        uint2 w[LOOKBACK];
#pragma unroll
        for (int k = 0; k < LOOKBACK; ++k) {
          const int back = c - j + k;  // chunk j - k is this far back
          if (j - k >= 0) {
            w[k] = back <= WINDOW ? sPrev[back - 1][lane] : peek(me - (size_t)back * hop);
          }
        }
#pragma unroll
        for (int k = 0; k < LOOKBACK; ++k) {
          if (j - k >= 0) {
            while (!ready(w[k])) {
              if (++polls > MAX_POLLS) __trap();
              w[k] = peek(me - (size_t)(c - j + k) * hop);
            }
            accX = fmaf(accA, __uint_as_float(w[k].y), accX);
            accA *= __uint_as_float(w[k].x);
          }
        }
      }
      carry = accX;  // chunk 0's map is (0, its inclusive h)
    }
    // each sub-chunk's carry-in, in place of its prefix
#pragma unroll
    for (int k = 0; k < S; ++k) sA[k][lane] = fmaf(sA[k][lane], carry, sX[k][lane]);
  }
  __syncthreads();

  // 4. rerun the chain from the carry-in; store h (and h_last at step T - 1).
  //    D and len pass through an empty asm, so that the compiler recomputes
  //    the 32 store offsets and predicates here instead of keeping the load
  //    loop's alive across the look-back, which spilled.
  int Dh = D, len_h = len;
  asm volatile("" : "+r"(Dh), "+r"(len_h));
  float hv = sA[s][lane];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    hv = fmaf(P::unpack(ra[u]), hv, P::unpack(rx[u]));
    if (live && u < len_h) P::store(h + base + (size_t)u * Dh, hv);
  }
  if (live && len > 0 && t0 + len == Tn) P::store(h_last + (size_t)b * D + d, hv);
}

// Every status pair to EMPTY and the counter (the last pair) to 0.
__global__ void rglru_clear(uint2* status, size_t pairs) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    status[i] = i + 1 < pairs ? make_uint2(EMPTY, EMPTY) : make_uint2(0u, 0u);
  }
}

struct Plan {
  long long tiles, chunks, ctas, pairs;
};

// The cut of (B, T, D); false for shapes the kernel does not take.
bool plan_of(int B, int T, int D, Plan* p) {
  if (B < 1 || T < 1 || D < 1) return false;
  p->tiles = (D + 31) / 32;
  p->chunks = (T + CHUNK - 1) / CHUNK;
  p->ctas = (long long)B * p->tiles * p->chunks;
  p->pairs = p->ctas * 32 + 1;
  return p->ctas < (1LL << 31);
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* h, void* h_last,
           void* status, int B, int Tn, int D, const Plan& p, cudaStream_t stream) {
  uint2* st = static_cast<uint2*>(status);
  const long long blocks = (p.pairs + 255) / 256;
  rglru_clear<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      st, (size_t)p.pairs);
  rglru_fwd<T><<<(unsigned)p.ctas, 32 * S, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const float*>(h0),
      static_cast<T*>(h), static_cast<T*>(h_last), st, B, Tn, D, (int)p.tiles,
      (int)p.chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's cut of (B, T, D) into out[0..5]: tiles of 32 channels,
// chunks of CHUNK steps, CTAs, threads a CTA, CHUNK, and the 8-byte status
// pairs the caller allocates for rglru_scan_fwd.  Returns 0, or the
// cudaError_t invalid value for shapes the kernel does not take.
extern "C" int rglru_scan_plan(int B, int T, int D, long long* out) {
  Plan p;
  if (!plan_of(B, T, D, &p)) return (int)cudaErrorInvalidValue;
  const long long v[6] = {p.tiles, p.chunks, p.ctas, 32LL * S, CHUNK, p.pairs};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// dtype 0: float32, 1: bfloat16 (x, a, h, h_last); h0 is float32.  status:
// the pairs rglru_scan_plan gives, cleared here (rglru_clear) before
// rglru_fwd runs.  Returns the cudaError_t of the launches (invalid value
// for arguments the kernel does not take).
extern "C" int rglru_scan_fwd(const void* x, const void* a, const void* h0, void* h,
                              void* h_last, void* status, int dtype, int B, int T,
                              int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  if (!plan_of(B, T, D, &p)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, a, h0, h, h_last, status, B, T, D, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, a, h0, h, h_last, status, B, T, D, p, s);
  return (int)cudaErrorInvalidValue;
}
