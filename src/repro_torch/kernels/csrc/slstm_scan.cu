// The sLSTM recurrence (xLSTM) for Hopper (sm_90a), with R resident in the
// shared memory of a thread-block cluster.
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
// one's h is known, so the least time of one step (a matvec of hd x 4hd/C
// on one SM, one exchange of h and one barrier) times T is a floor of its
// own.
//
// Design.  The TPU kernel's point is that R stays resident in fast memory
// for the whole sequence.  One head's R (295 KB in bf16) is over an SM's
// 227 KB, so one thread-block cluster of C CTAs serves one head and a group
// of at most ROWS = 4 batch rows, the rows a thread's accumulators hold
// (the served B = 4 is one group; B = 32 is eight clusters a head, which
// run side by side: one cluster of 16 rows, four accumulator tiles a
// thread, took 8.45 us a step against 2.27 at 4 rows on an H100 80GB HBM3
// at 700 W):
// CTA c owns channels [c E, (c + 1) E), E = hd / C, of all
// four gates, and copies its slice of R_i, R_f, R_z, R_o (4 x hd x E, in
// R's own dtype, the four gates of a channel side by side; widening bf16
// at the read is exact) into shared memory once.  The time loop reads no
// R from global memory.  Each CTA's share of a step's products (4 hd E B
// FMAs, ~1.4 instructions each with the loads and the bf16 widening) sets
// the chain's pace, so the wrapper takes the largest cluster that divides
// hd (cluster_plan: 8 at xlstm-125m, E = 24).  Each step:
//   1. the pre-activations of the CTA's 4E columns for its B rows from
//      h_{t-1} (B x hd f32 in the CTA's own shared memory, laid out
//      [k][b]) and the resident slice: thread (s, q) takes channel q's
//      four gates for every row over k-slice s, and the KS partial sums
//      meet in shared memory after one block barrier.  The CTA's own
//      channels of h_{t-1} come first; only then does it wait for the
//      peers' slices;
//   2. `pre` of the step, loaded a step ahead with cp.async (it does not
//      depend on h);
//   3. the gating of the CTA's B x E channels; c, n and m stay in shared
//      memory, hs/cs/ns/ms go to global memory;
//   4. the new h slice goes into the CTA's own next-step h buffer and, by
//      st.async, into every peer's (double-buffered by step parity); each
//      st.async counts its bytes on the receiving CTA's mbarrier for that
//      buffer, armed with the bytes it expects, so a CTA waits (point 1)
//      for exactly its peers' data: one-way, where a cluster barrier is a
//      round trip that also waits for every earlier store.  No barrier
//      guards the buffers' reuse: a peer writes a buffer again only two
//      steps later, after it has this CTA's next slice, which this CTA
//      makes after it has read the buffer;
//   5. one block barrier.
// log_sigmoid(x) = -(max(-x, 0) + log1p(exp(-|x|))) as jax.nn.log_sigmoid
// computes it.  m starts at -inf: expf(-inf) == 0 and IEEE
// expf/log1pf/tanhf are relied on, so this file must not be built with
// --use_fast_math.
//
// The first design (one CTA per (b, head), 4 hd threads, column e of R_g
// streamed from L2 every step, two block barriers a step) measured
// 38.96-40.07 ms at the served prefill shape, 12.7-13.0 us a step, on an
// H100 80GB HBM3 at 700 W.  This one takes 3.62, 2.85 and 2.29 us a step
// there at C = 2, 4, 8 (chip_smoke.py's xl-full phase sweeps C), and a
// build with a barrier.cluster a step in place of the st.async exchange
// took 4.25, 3.40 and 2.76.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a CTA may use
constexpr int MAX_THREADS = 512;  // a CTA's threads: 128 registers each
constexpr int ROWS = 4;           // most batch rows a cluster serves
static_assert(ROWS == 4, "a thread reads the rows of h as one float4");

// Shared-memory plan of one CTA serving B <= ROWS batch rows: the R slice,
// two mbarriers, then f32 buffers (counted in floats).  The wrapper's
// slstm_scan.cluster_plan counts the same bytes and passes its count, which
// the launch refuses unless it is this one.
struct Plan {
  int E, KS;
  size_t r_bytes, part, hbuf, prebuf, carry;
  __host__ __device__ Plan(int B, int hd, int C, int KS_, int r_size)
      : E(hd / C), KS(KS_) {
    r_bytes = ((size_t)4 * hd * E * r_size + 15) & ~(size_t)15;
    part = (size_t)KS * B * 4 * E;  // partial sums [KS][B][E][4 gates]
    hbuf = (size_t)2 * hd * ROWS;   // h_{t-1} and h_t, [k][ROWS] each
    prebuf = (size_t)2 * B * 4 * E; // pre of two steps, [B][4][E] each
    carry = (size_t)3 * B * E;      // c, n, m [B][E]
  }
  __host__ __device__ size_t bytes() const {
    return r_bytes + 16 + sizeof(float) * (part + hbuf + prebuf + carry);
  }
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// four adjacent R elements, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t map_to(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// store v at the shared-memory address `local` of CTA `rank` of the cluster,
// counting its 4 bytes on that CTA's mbarrier `bar` (also a local address)
__device__ __forceinline__ void st_async(uint32_t local, uint32_t bar, uint32_t rank,
                                         float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(map_to(local, rank)), "f"(v), "r"(map_to(bar, rank)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed (acquire, cluster
// scope: the peers' st.async data is then visible); a wait that outlasts
// 2^26 polls (seconds, against microseconds for a step) is a broken
// exchange, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Cluster (head, g) of ceil(B_all / Bg) groups a head serves batch rows
// [g Bg, min((g + 1) Bg, B_all)).
template <typename R>
__global__ void __launch_bounds__(MAX_THREADS, 1)
slstm_fwd(SlstmArgs args, int B_all, int Bg, int C, int KS) {
  extern __shared__ float4 smem4[];
  const int hd = args.hd, Tn = args.T, d = args.H * hd;
  const Plan plan(Bg, hd, C, KS, (int)sizeof(R));
  const int groups = (B_all + Bg - 1) / Bg, cluster = blockIdx.x / C;
  const int head = cluster / groups, b_first = (cluster % groups) * Bg;
  const int B = min(Bg, B_all - b_first);  // this cluster's batch rows
  // the global tensors from this cluster's first row on
  const size_t vec0 = (size_t)b_first * d, seq0 = vec0 * Tn;
  const float *c0 = args.c0 + vec0, *n0 = args.n0 + vec0, *h0 = args.h0 + vec0,
              *m0 = args.m0 + vec0;
  float *hs = args.hs + seq0, *cs = args.cs + seq0, *ns = args.ns + seq0,
        *ms = args.ms + seq0;
  float *cf = args.cf + vec0, *nf = args.nf + vec0, *hf = args.hf + vec0,
        *mf = args.mf + vec0;
  const int E = plan.E, W = 4 * E;  // W: the CTA's columns
  char* base = reinterpret_cast<char*>(smem4);
  R* r_s = reinterpret_cast<R*>(base);            // [hd][E][4 gates]
  const uint32_t bars = smem_addr(base + plan.r_bytes);  // h buffer 0's, 1's
  float* part = reinterpret_cast<float*>(base + plan.r_bytes + 16);
  float* hbuf = part + plan.part;      // 2 x [hd][ROWS]
  float* prebuf = hbuf + plan.hbuf;    // 2 x [B][4][E]
  float* c_s = prebuf + plan.prebuf;   // [B][E]
  float* n_s = c_s + B * E;
  float* m_s = n_s + B * E;

  const uint32_t rank = cluster_rank();
  const int col0 = head * hd + (int)rank * E;  // first channel of this CTA
  const int tid = threadIdx.x, nthr = blockDim.x;
  // bytes of h a CTA receives from its peers each step
  const uint32_t peer_bytes = (uint32_t)((C - 1) * E * B * sizeof(float));

  // the resident R slice, gates interleaved: r_s[k][e][x] = R_x[head, k, rank*E + e]
  for (int i = tid; i < hd * W; i += nthr) {
    const int k = i / W, j = i - k * W, e = j >> 2, x = j & 3;
    r_s[i] = static_cast<const R*>(args.r[x])[((size_t)head * hd + k) * hd + rank * E + e];
  }
  // h_{-1} of the whole head into buffer 0, padding rows zero in both
  for (int i = tid; i < 2 * hd * ROWS; i += nthr) {
    const int buf = i / (hd * ROWS), kb = i - buf * hd * ROWS, k = kb / ROWS, b = kb % ROWS;
    hbuf[i] = (buf == 0 && b < B) ? h0[(size_t)b * d + head * hd + k] : 0.f;
  }
  for (int i = tid; i < B * E; i += nthr) {
    const int b = i / E, e = i - b * E;
    const size_t v = (size_t)b * d + col0 + e;
    c_s[i] = c0[v];
    n_s[i] = n0[v];
    m_s[i] = m0[v];
  }
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Thread (s, q) = (tid / E, tid % E): in the matvec, channel q's four gate
  // columns over k-slice s of the CTA's own channels and of its peers' ones,
  // for every batch row; in the gating, the items (b, q) for b = s, s + KS,
  // ...; in the prefetch, rows r = b * 4 + x = s, s + KS, ... of pre's
  // [B][4][E] block.  Fixed for the whole sequence.
  const int q = tid % E, s = tid / E;
  const int own = (int)rank * E;  // the CTA's own channels: [own, own + E)
  const int kl_own = (E + KS - 1) / KS, n_peer = hd - E;
  const int kl_peer = (n_peer + KS - 1) / KS;
  const int ko_lo = own + min(E, s * kl_own), ko_hi = own + min(E, (s + 1) * kl_own);
  // the peers' channels j in [0, hd - E) are k = j below own, j + E above
  const int j_lo = min(n_peer, s * kl_peer), j_hi = min(n_peer, (s + 1) * kl_peer);
  const int kb_lo = j_lo, kb_hi = min(j_hi, own);                         // below
  const int ka_lo = max(j_lo, own) + E, ka_hi = max(j_hi, own) + E;       // above
  const float* pre_q = args.pre + seq0 * 4 + col0 + q;
  const R* rp = r_s + 4 * q;
  float4* part4 = reinterpret_cast<float4*>(part);  // [KS][B][E] x 4 gates
  auto prefetch = [&](float* buf, int t) {
    for (int r = s; r < 4 * B; r += KS)
      cp_async4(buf + r * E + q, pre_q + (((size_t)(r >> 2) * Tn + t) * 4 + (r & 3)) * d);
  };
  // acc[b][x] += sum over k in [k0, k1) of h[k][b] R_x[k][q]
  auto matvec = [&](float (&acc)[ROWS][4], const float* h, int k0, int k1) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 rv = load4(rp + (size_t)k * W);
      const float4 hv = *reinterpret_cast<const float4*>(h + k * ROWS);
      const float hb[ROWS] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int b = 0; b < ROWS; ++b) {
        acc[b][0] = fmaf(hb[b], rv.x, acc[b][0]);
        acc[b][1] = fmaf(hb[b], rv.y, acc[b][1]);
        acc[b][2] = fmaf(hb[b], rv.z, acc[b][2]);
        acc[b][3] = fmaf(hb[b], rv.w, acc[b][3]);
      }
    }
  };
  prefetch(prebuf, 0);
  cp_async_commit();
  cluster_sync();  // every CTA of the cluster runs, its barriers initialized

  for (int t = 0; t < Tn; ++t) {
    const float* h_cur = hbuf + (t & 1) * hd * ROWS;
    float* h_next = hbuf + ((t + 1) & 1) * hd * ROWS;
    // h_next's barrier: its peers' slices of h_t land there (waited on in
    // step t + 1).  Its previous phase was waited on in step t - 1.
    const uint32_t bar_next = bars + 8 * ((t + 1) & 1);
    if (tid == 0) mbar_expect_tx(bar_next, peer_bytes);
    if (t + 1 < Tn) prefetch(prebuf + ((t + 1) & 1) * B * W, t + 1);
    cp_async_commit();

    // the CTA's own channels of h_{t-1} first, then, once the peers'
    // slices have landed, theirs
    const uint32_t bar_cur = bars + 8 * (t & 1);
    const uint32_t parity = ((t - 1) >> 1) & 1;
    float acc[ROWS][4] = {};
    matvec(acc, h_cur, ko_lo, ko_hi);
    if (t > 0) mbar_wait(bar_cur, parity);
    matvec(acc, h_cur, kb_lo, kb_hi);
    matvec(acc, h_cur, ka_lo, ka_hi);
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (b < B)
        part4[((size_t)s * B + b) * E + q] =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    cp_async_wait1();  // this thread's copies of step t's pre have landed
    __syncthreads();   // ... and every thread's, and every partial sum

    const float* pre_t = prebuf + (t & 1) * B * W;
    for (int b = s; b < B; b += KS) {
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        const float4 p = part4[((size_t)ks * B + b) * E + q];
        g.x += p.x;
        g.y += p.y;
        g.z += p.z;
        g.w += p.w;
      }
      const float* pb = pre_t + b * W + q;
      const float li = pb[0] + g.x;
      const float lf = log_sigmoid(pb[E] + g.y);
      const float z = tanhf(pb[2 * E] + g.z);
      const float o = sigmoid(pb[3 * E] + g.w);
      const int i = b * E + q;
      const float m = m_s[i];
      const float m_new = fmaxf(lf + m, li);
      const float fdec = expf(lf + m - m_new), idec = expf(li - m_new);
      const float c = c_s[i] * fdec + idec * z;
      const float n = n_s[i] * fdec + idec;
      const float h = o * c / fmaxf(n, 1.f);
      float* dst = h_next + (own + q) * ROWS + b;
      *dst = h;  // this CTA's copy; the peers' by st.async on their barriers
      for (int p = 1; p < C; ++p) st_async(smem_addr(dst), bar_next, (rank + p) % C, h);
      c_s[i] = c;
      n_s[i] = n;
      m_s[i] = m_new;
      const size_t seq = ((size_t)b * Tn + t) * d + col0 + q;
      hs[seq] = h;
      cs[seq] = c;
      ns[seq] = n;
      ms[seq] = m_new;
    }
    __syncthreads();  // own h_t, the partials and pre_t: the CTA is done with them
  }
  // the last step's slices from the peers have landed: no peer writes here
  // any more
  mbar_wait(bars + 8 * (Tn & 1), ((Tn - 1) >> 1) & 1);

  const float* h_fin = hbuf + (Tn & 1) * hd * ROWS;
  for (int b = s; b < B; b += KS) {
    const int i = b * E + q;
    const size_t v = (size_t)b * d + col0 + q;
    cf[v] = c_s[i];
    nf[v] = n_s[i];
    mf[v] = m_s[i];
    hf[v] = h_fin[(own + q) * ROWS + b];
  }
  cluster_sync();  // no CTA leaves while a peer may still address it
}

template <typename R>
int launch(const SlstmArgs& args, int B, int Bg, int C, int KS, size_t smem_plan,
           cudaStream_t stream) {
  const Plan plan(Bg, args.hd, C, KS, (int)sizeof(R));
  const size_t smem = plan.bytes();
  const int threads = plan.E * KS;
  if (Bg > ROWS || smem != smem_plan || smem > MAX_SMEM || threads > MAX_THREADS ||
      threads < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      slstm_fwd<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(args.H * ((B + Bg - 1) / Bg) * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, slstm_fwd<R>, args, B, Bg, C, KS);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// r_dtype 0: float32, 1: bfloat16.  One cluster of C CTAs per head and
// group of at most Bg <= 4 batch rows, E * KS threads a CTA (E = hd / C), smem
// bytes of shared memory a CTA; slstm_scan.cluster_plan chooses them all.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue where smem
// is not this file's Plan of them).
extern "C" int slstm_scan_fwd(const SlstmArgs* args, int r_dtype, int B, int Bg, int C,
                              int KS, size_t smem, void* stream) {
  if (args->hd < 1 || B < 1 || Bg < 1 || Bg > B || C < 1 || C > 8 ||
      args->hd % C != 0 || KS < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0) return launch<float>(*args, B, Bg, C, KS, smem, s);
  if (r_dtype == 1) return launch<__nv_bfloat16>(*args, B, Bg, C, KS, smem, s);
  return (int)cudaErrorInvalidValue;
}
