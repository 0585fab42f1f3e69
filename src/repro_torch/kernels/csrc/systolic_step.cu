// systolic_step.cu — K cycles of a tile of systolic MAC cells for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/systolic_step.py::_systolic_kernel (the one
// pl.pallas_call at systolic_step.py:176, kernel body at :39), which runs
// K cycles of an R x C tile with the whole tile resident in TPU VMEM.
//
// What it computes: one call of systolic_step() runs k_cycles cycles of
// all T tiles (independent, stacked on a leading dimension) on the
// caller's stream, one launch per cycle, one thread per cell:
//   * the cell's pre-cycle inputs: the west register (or, in column 0, the
//     west slab at widx), the north register (or the north slab at nidx),
//     the a_buf stream on is_west cells, psum 0 on is_north cells;
//   * fire = a_ok & p_ok & e_free & s_free, where column C-1 / row R-1 are
//     free while east_cnt < east_limit / south_cnt < south_limit;
//   * y = fma(a_in, b, p_in), rounded once (__fmaf_rn): the reference's
//     p_in + a_in * b is contracted into one FMA by XLA, and the plain
//     version's torch.addcmul is one FMA as well;
//   * the depth-1 register commit, the drain of the registers the east
//     and south neighbours consumed, egress into the east/south slabs,
//     collection into y_buf on is_south cells.
// The reference's one-hot sums are direct indices here: a gather of
// a_buf[.., a_idx], an add into y_buf[.., y_idx] and into the egress slab
// slot.  An index outside [0, M) or [0, W) reads 0 and writes nothing, as
// an all-zero one-hot row does; adds (not stores) keep the reference's
// bits, signed zeros of the streamed operands aside.
//
// The pre-cycle snapshot: every cell reads its neighbours' pre-cycle
// registers, and whether its own registers drain depends on its east and
// south neighbours' fire.  A thread therefore recomputes those two
// neighbours' fire from the pre-cycle state, and every leaf a neighbour
// reads (a_reg, a_v, p_reg, p_v, a_idx, widx, nidx, east_cnt, south_cnt)
// is double-buffered: cycle i reads buffer i % 2 and writes the other.
// Leaves only their own thread touches (y_idx, y_buf, the egress slabs)
// are updated in place.  The results of the paired leaves sit in buffer
// k_cycles % 2, which the wrapper returns.
//
// What bounds it: device memory.  At 1M cells a cycle reads b, a_reg,
// a_v, p_reg, p_v and the four flags (18 B a cell) and writes both
// registers and valid flags (10 B), ~29 MB, against one FMA and ~20
// integer and select operations a cell; a_idx and the a_buf reads, y_idx
// and the y_buf writes touch only the west and south edges.  The TPU kernel kept the tile in VMEM; one
// Hopper SM has 227 KB of shared memory and a 1024 x 1024 tile's state is
// ~14 MB plus the 4 GiB a_buf/y_buf, so this design streams the state
// through device memory every cycle with coalesced accesses (neighbouring
// threads on neighbouring cells); the neighbours' re-reads hit L1/L2.
// Keeping the state on chip across cycles (a persistent kernel over tiles
// with halo cells) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

// Field order must match repro_torch.kernels.systolic_step._StepArgs.
struct StepArgs {
  // double-buffered: [0] holds the inputs, [k_cycles % 2] the results
  float* a_reg[2];       // (T, R, C)
  uint8_t* a_v[2];
  float* p_reg[2];
  uint8_t* p_v[2];
  int32_t* a_idx[2];
  int32_t* widx[2];      // (T, R)
  int32_t* nidx[2];      // (T, C)
  int32_t* east_cnt[2];  // (T, R)
  int32_t* south_cnt[2]; // (T, C)
  // read only
  const float* b;        // (T, R, C)
  const uint8_t* is_w;
  const uint8_t* is_n;
  const uint8_t* is_s;
  const uint8_t* is_e;
  const float* a_buf;    // (T, R, C, M)
  // updated in place by the owning thread
  float* y_buf;          // (T, R, C, M)
  int32_t* y_idx;        // (T, R, C)
  // read only
  const float* west_slab;   // (T, R, W)
  const int32_t* west_cnt;  // (T, R)
  const float* north_slab;  // (T, C, W)
  const int32_t* north_cnt; // (T, C)
  const int32_t* e_limit;   // (T, R)
  const int32_t* s_limit;   // (T, C)
  // egress, zeroed by the wrapper, written by column C-1 / row R-1
  float* east_slab;      // (T, R, W)
  float* south_slab;     // (T, C, W)
  int32_t T, R, C, M, W;
};

constexpr int kThreads = 256;

__device__ __forceinline__ float mac(float p, float a, float b) {
  return __fmaf_rn(a, b, p);  // p + a*b, one rounding
}

// fire of cell (t, r, c) from the pre-cycle buffers `s`; its effective
// inputs go to a_in / p_in.
__device__ __forceinline__ bool cell_fire(const StepArgs& g, int s, int64_t t,
                                          int r, int c, float& a_in,
                                          float& p_in) {
  const int64_t row = t * g.R + r, col = t * g.C + c;
  const int64_t i = row * g.C + c;
  bool a_ok, p_ok;
  if (g.is_w[i]) {
    const int ai = g.a_idx[s][i];
    a_ok = ai < g.M;
    a_in = (ai >= 0 && ai < g.M) ? g.a_buf[i * g.M + ai] : 0.0f;
  } else if (c == 0) {
    const int wi = g.widx[s][row];
    a_ok = wi < g.west_cnt[row];
    a_in = (wi >= 0 && wi < g.W) ? g.west_slab[row * g.W + wi] : 0.0f;
  } else {
    a_ok = g.a_v[s][i - 1] != 0;
    a_in = g.a_reg[s][i - 1];
  }
  if (g.is_n[i]) {
    p_ok = true;
    p_in = 0.0f;
  } else if (r == 0) {
    const int ni = g.nidx[s][col];
    p_ok = ni < g.north_cnt[col];
    p_in = (ni >= 0 && ni < g.W) ? g.north_slab[col * g.W + ni] : 0.0f;
  } else {
    p_ok = g.p_v[s][i - g.C] != 0;
    p_in = g.p_reg[s][i - g.C];
  }
  const bool e_free = g.is_e[i] || (c == g.C - 1 ? g.east_cnt[s][row] < g.e_limit[row]
                                                  : g.a_v[s][i] == 0);
  const bool s_free = g.is_s[i] || (r == g.R - 1 ? g.south_cnt[s][col] < g.s_limit[col]
                                                  : g.p_v[s][i] == 0);
  return a_ok && p_ok && e_free && s_free;
}

__global__ void __launch_bounds__(kThreads)
systolic_cycle(const StepArgs g, const int s) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = (int64_t)g.T * g.R * g.C;
  if (i >= n) return;
  const int d = s ^ 1;
  const int c = (int)(i % g.C);
  const int r = (int)((i / g.C) % g.R);
  const int64_t t = i / ((int64_t)g.R * g.C);
  const int64_t row = t * g.R + r, col = t * g.C + c;

  float a_in, p_in, na, np;
  const bool fire = cell_fire(g, s, t, r, c, a_in, p_in);
  const float y = mac(p_in, a_in, g.b[i]);
  const bool is_w = g.is_w[i], is_n = g.is_n[i];
  const bool is_s = g.is_s[i], is_e = g.is_e[i];

  // the east / south neighbour consumed this cell's register this cycle
  const bool drain_a = c + 1 < g.C && !g.is_w[i + 1] &&
                       cell_fire(g, s, t, r, c + 1, na, np);
  const bool drain_p = r + 1 < g.R && !g.is_n[i + g.C] &&
                       cell_fire(g, s, t, r + 1, c, na, np);
  const bool a_v2 = g.a_v[s][i] && !drain_a;
  const bool p_v2 = g.p_v[s][i] && !drain_p;
  const bool emit_e = fire && !is_e;
  const bool emit_s = fire && !is_s;

  g.a_reg[d][i] = fire ? a_in : g.a_reg[s][i];
  g.p_reg[d][i] = fire ? y : g.p_reg[s][i];
  g.a_v[d][i] = (c == g.C - 1) ? a_v2 : (emit_e || a_v2);
  g.p_v[d][i] = (r == g.R - 1) ? p_v2 : (emit_s || p_v2);
  g.a_idx[d][i] = g.a_idx[s][i] + (fire && is_w ? 1 : 0);

  if (fire && is_s) {
    const int yi = g.y_idx[i];
    if (yi >= 0 && yi < g.M) g.y_buf[i * g.M + yi] += y;
    g.y_idx[i] = yi + 1;
  }
  if (c == 0) g.widx[d][row] = g.widx[s][row] + (fire && !is_w ? 1 : 0);
  if (r == 0) g.nidx[d][col] = g.nidx[s][col] + (fire && !is_n ? 1 : 0);
  if (c == g.C - 1) {
    const int ec = g.east_cnt[s][row];
    if (emit_e && ec >= 0 && ec < g.W) g.east_slab[row * g.W + ec] += a_in;
    g.east_cnt[d][row] = ec + (emit_e ? 1 : 0);
  }
  if (r == g.R - 1) {
    const int sc = g.south_cnt[s][col];
    if (emit_s && sc >= 0 && sc < g.W) g.south_slab[col * g.W + sc] += y;
    g.south_cnt[d][col] = sc + (emit_s ? 1 : 0);
  }
}

__global__ void mac_kernel(const float* p, const float* a, const float* b,
                           float* out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mac(p[i], a[i], b[i]);
}

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

extern "C" int systolic_step(const StepArgs* args, int k_cycles,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const StepArgs g = *args;
  const int64_t n = (int64_t)g.T * g.R * g.C;
  if (n <= 0 || g.M <= 0 || g.W <= 0 || k_cycles < 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < k_cycles; ++k) {
    systolic_cycle<<<blocks_for(n), kThreads, 0, stream>>>(g, k & 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" int systolic_mac(const float* p, const float* a, const float* b,
                            float* out, int64_t n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  mac_kernel<<<blocks_for(n), kThreads, 0, stream>>>(p, a, b, out, n);
  return (int)cudaGetLastError();
}
