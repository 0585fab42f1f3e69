// systolic_step.cu — K cycles of a tile of systolic MAC cells for Hopper
// (sm_90a), with the cells kept in shared memory across cycles.
//
// Replaces: src/repro/kernels/systolic_step.py::_systolic_kernel (the one
// pl.pallas_call at systolic_step.py:176, kernel body at :39), which runs
// K cycles of an R x C tile with the whole tile resident in TPU VMEM.
//
// What it computes: one call of systolic_step() runs k_cycles cycles of
// all T tiles (independent, stacked on a leading dimension) on the
// caller's stream:
//   * a cell's pre-cycle inputs: the west register (or, in column 0, the
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
// The design: one CTA per block of br x bc cells of one tile (grid x:
// column blocks, y: row blocks, z: the tile).  The CTA loads a WINDOW —
// its block plus a halo of kk cells on every side, clipped at the tile's
// edges — into shared memory: a_reg, p_reg, b, a_idx and one packed byte
// of a_v, p_v and the four edge flags a cell, and private copies of the
// window's row and column counters (widx, east_cnt, nidx, south_cnt).  It
// then runs kk cycles there, each in two passes split by __syncthreads:
//   1. every window cell evaluates its fire ONCE from its neighbours'
//      pre-cycle registers and stores it (with "consumed my west / north
//      input") beside its a_in and y; the owner of a cell does the cell's
//      edge work: the a_buf read, y_buf / y_idx, slab reads, egress;
//   2. every cell commits: latches a_in / y where it fired, and drains its
//      registers where its east / south neighbour consumed them.
// The window's interior runs in aligned groups of 4 cells on packed words
// (4 flag bytes or fire bytes, float4s: a few bit operations a group); its
// border, where a cut or a tile edge or an edge flag needs the general
// step, runs cell by cell in a loop of its own, so a warp's lanes do not
// split between the two.
// A cycle's dependencies reach one cell in every direction (the
// neighbours' fire brings in (r-1, c+1) and (r+1, c-1)), so after kk
// cycles the cells at least kk from the window's cut — the owned block —
// are exact; the halo's results are dropped.  Only owned cells and the
// counters of owned rows / columns are written back.  A call of K cycles
// is ceil(K / k) launches; every leaf another CTA reads at a launch's
// start (a_reg, a_v, p_reg, p_v, a_idx and the four counters) is double
// buffered by launch parity: launch j reads buffer j % 2 and writes the
// other, so the results sit in buffer ceil(K / k) % 2, which the wrapper
// returns.  y_idx, y_buf and the egress slabs have one writer, the owner,
// and are updated in place.  k and the block shape are launch arguments
// (repro_torch.kernels.systolic_step.tile_plan); the launch refuses a
// shared-memory byte count that is not window_smem()'s own.
// The until-loop's stop flag (StepArgs::stop; null outside the loop): a
// launch that finds it set only carries its owned cells and counters from
// buffer s to buffer s ^ 1 (carry_block), so the call returns the state it
// was given, its slabs empty, whatever its launch count.
//
// What bounds it now: not device memory (the window is read and the block
// written once a launch, ~50 MB a launch and ~0.4 GB a call of 62 cycles
// at 1M cells, where the first design streamed ~1.8 GB), but the latency
// of that load and write-back at each launch, the 1.56x of cells in the
// halo at k = 8, and the two block barriers a cycle: chip_smoke.py's k
// sweep (sys-full) times k = 1, a load and write-back every cycle, at
// about 2.5x k = 8's time a cycle.  The first design (one launch a cycle,
// one thread a cell, fire computed three times a cell from ten global
// loads, 64-bit index math) streamed ~29 B a cell through device memory
// every cycle and ran at 0.03936-0.04139 ms a cycle at 1M cells on an H100
// 80GB HBM3 at 700 W.
#include <cuda_runtime.h>
#include <stdint.h>

// Field order must match repro_torch.kernels.systolic_step._StepArgs.
struct StepArgs {
  // by launch parity: [0] holds the inputs, [launches % 2] the results
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
  // updated in place by the CTA that owns the cell
  float* y_buf;          // (T, R, C, M)
  int32_t* y_idx;        // (T, R, C)
  // read only
  const float* west_slab;   // (T, R, W)
  const int32_t* west_cnt;  // (T, R)
  const float* north_slab;  // (T, C, W)
  const int32_t* north_cnt; // (T, C)
  const int32_t* e_limit;   // (T, R)
  const int32_t* s_limit;   // (T, C)
  // egress, zeroed by the wrapper, written by the owners of column C-1 /
  // row R-1
  float* east_slab;      // (T, R, W)
  float* south_slab;     // (T, C, W)
  // () the until-loop's stop flag, or null: where it is set, a launch
  // carries its owned cells and counters from buffer s to buffer s ^ 1
  // unchanged and writes nothing else
  const uint8_t* stop;
  int32_t T, R, C, M, W;
};

constexpr int kThreads = 512;
constexpr int kSmemLimit = 232448;  // a CTA's shared memory on Hopper
constexpr int kMaxDevices = 64;

// the packed per-cell byte: the two valid flags and the four edge flags
constexpr uint8_t A_V = 1, P_V = 2, IS_W = 4, IS_N = 8, IS_S = 16, IS_E = 32;
constexpr uint8_t FLAGS = IS_W | IS_N | IS_S | IS_E;
// the fire byte of pass 1
constexpr uint8_t FIRE = 1, CONS_A = 2, CONS_P = 4;
constexpr uint32_t kLanes = 0x01010101u;  // bit 0 of each of 4 packed bytes

__device__ __forceinline__ float mac(float p, float a, float b) {
  return __fmaf_rn(a, b, p);  // p + a*b, one rounding
}

// A window row in shared memory: cell wc at column wc + 3 of a row of
// pitch_of(wcols) slots, so that interior cells 1..4 fill the aligned
// group of slots 4..7, and so on.
constexpr int kOff = 3;
__host__ __device__ __forceinline__ int pitch_of(int wcols) {
  return (wcols + kOff + 3) & ~3;
}

// Shared memory of a launch: the largest window of the plan,
// min(R, br + 2k) rows of pitch_of(min(C, bc + 2k)) slots, at 26 B a slot
// (a_reg, p_reg, b, a_in, y, a_idx; the packed flags and the fire byte),
// plus four counters a row / column.
static int64_t window_smem(int R, int C, int br, int bc, int k) {
  const int64_t wr = R < br + 2 * k ? R : br + 2 * k;
  const int64_t wc = C < bc + 2 * k ? C : bc + 2 * k;
  return wr * pitch_of((int)wc) * 26 + (2 * wr + 2 * wc) * 4;
}

template <typename T>
__device__ __forceinline__ T& at(void* base, int byte_offset) {
  return *reinterpret_cast<T*>(static_cast<char*>(base) + byte_offset);
}

// One CTA's window: its geometry and its shared-memory arrays.
struct Window {
  float *a, *p, *b, *ain, *y;
  int *ai, *widx, *ecnt, *nidx, *scnt;
  uint8_t *f, *fire;
  int r0, r1, c0, c1;   // the owned block (tile coordinates)
  int rl, cl;           // the window's first row and column
  int wrows, wcols, P;  // its size and row pitch
  int64_t row0, col0, cell0;  // the tile's first row, column, cell
};

// Pass 1 of a cell that needs more than its four neighbours: a window
// border (cut or tile edge) or an edge flag.  Its fire, a_in and y go to
// shared memory; the owner does the cell's edge work.
__device__ void edge_fire(const StepArgs& g, const Window& w, int wr, int wc) {
  const int x = wr * w.P + wc + kOff;
  const int r = w.rl + wr, c = w.cl + wc;
  const int R = g.R, C = g.C;
  const bool own = r >= w.r0 && r < w.r1 && c >= w.c0 && c < w.c1;
  const uint8_t f = w.f[x];
  float a_in, p_in;
  bool a_ok, p_ok;
  if (f & IS_W) {
    const int ai = w.ai[x];
    a_ok = ai < g.M;
    a_in = (ai >= 0 && ai < g.M) ? g.a_buf[(w.cell0 + (int64_t)r * C + c) * g.M + ai]
                                 : 0.0f;
  } else if (c == 0) {
    const int wi = w.widx[wr];
    a_ok = wi < g.west_cnt[w.row0 + r];
    a_in = (wi >= 0 && wi < g.W) ? g.west_slab[(w.row0 + r) * g.W + wi] : 0.0f;
  } else if (wc == 0) {  // the window's cut: its west neighbour is outside
    a_ok = false;
    a_in = 0.0f;
  } else {
    a_ok = (w.f[x - 1] & A_V) != 0;
    a_in = w.a[x - 1];
  }
  if (f & IS_N) {
    p_ok = true;
    p_in = 0.0f;
  } else if (r == 0) {
    const int ni = w.nidx[wc];
    p_ok = ni < g.north_cnt[w.col0 + c];
    p_in = (ni >= 0 && ni < g.W) ? g.north_slab[(w.col0 + c) * g.W + ni] : 0.0f;
  } else if (wr == 0) {
    p_ok = false;
    p_in = 0.0f;
  } else {
    p_ok = (w.f[x - w.P] & P_V) != 0;
    p_in = w.p[x - w.P];
  }
  const bool e_free = (f & IS_E) || (c == C - 1 ? w.ecnt[wr] < g.e_limit[w.row0 + r]
                                               : !(f & A_V));
  const bool s_free = (f & IS_S) || (r == R - 1 ? w.scnt[wc] < g.s_limit[w.col0 + c]
                                               : !(f & P_V));
  const bool fire = a_ok && p_ok && e_free && s_free;
  const float y = mac(p_in, a_in, w.b[x]);
  w.fire[x] = fire ? (FIRE | ((f & IS_W) ? 0 : CONS_A) | ((f & IS_N) ? 0 : CONS_P)) : 0;
  w.ain[x] = a_in;
  w.y[x] = y;
  const bool emit_e = fire && !(f & IS_E), emit_s = fire && !(f & IS_S);
  if (fire && (f & IS_W)) w.ai[x] += 1;
  if (c == 0) w.widx[wr] += (fire && !(f & IS_W)) ? 1 : 0;
  if (r == 0) w.nidx[wc] += (fire && !(f & IS_N)) ? 1 : 0;
  if (c == C - 1) {
    const int ec = w.ecnt[wr];
    if (own && emit_e && ec >= 0 && ec < g.W) g.east_slab[(w.row0 + r) * g.W + ec] += a_in;
    w.ecnt[wr] = ec + (emit_e ? 1 : 0);
  }
  if (r == R - 1) {
    const int sc = w.scnt[wc];
    if (own && emit_s && sc >= 0 && sc < g.W) g.south_slab[(w.col0 + c) * g.W + sc] += y;
    w.scnt[wc] = sc + (emit_s ? 1 : 0);
  }
  if (own && fire && (f & IS_S)) {
    const int64_t gi = w.cell0 + (int64_t)r * C + c;
    const int yi = g.y_idx[gi];
    if (yi >= 0 && yi < g.M) g.y_buf[gi * g.M + yi] += y;
    g.y_idx[gi] = yi + 1;
  }
}

// Pass 2 of such a cell: latch where it fired, drain what its east and
// south neighbours consumed (nothing across the window's cut).
__device__ void edge_commit(const StepArgs& g, const Window& w, int wr, int wc) {
  const int x = wr * w.P + wc + kOff;
  const uint8_t f = w.f[x];
  const bool fire = w.fire[x] & FIRE;
  const bool drain_a = wc + 1 < w.wcols && (w.fire[x + 1] & CONS_A);
  const bool drain_p = wr + 1 < w.wrows && (w.fire[x + w.P] & CONS_P);
  const bool a_v2 = (f & A_V) && !drain_a;
  const bool p_v2 = (f & P_V) && !drain_p;
  const bool a_vn = (w.cl + wc == g.C - 1) ? a_v2 : ((fire && !(f & IS_E)) || a_v2);
  const bool p_vn = (w.rl + wr == g.R - 1) ? p_v2 : ((fire && !(f & IS_S)) || p_v2);
  if (fire) {
    w.a[x] = w.ain[x];
    w.p[x] = w.y[x];
  }
  w.f[x] = (f & ~(A_V | P_V)) | (a_vn ? A_V : 0) | (p_vn ? P_V : 0);
}

// A stopped launch: the owned block's double-buffered leaves, and the
// counters of its owned rows / columns, carried from buffer s to buffer d
// as they are, so the results of the call (buffer launches % 2) hold the
// state it was given whatever the launch count.  y_idx, y_buf and the
// egress slabs are not touched.
__device__ void carry_block(const StepArgs& g, const Window& w, int s, int d,
                            int64_t tile) {
  const int R = g.R, C = g.C;
  const int64_t row0 = tile * R, col0 = tile * C, cell0 = row0 * C;
  const int orows = w.r1 - w.r0, ocols = w.c1 - w.c0;
  for (int x = threadIdx.x; x < orows * ocols; x += kThreads) {
    const int orr = x / ocols, occ = x - orr * ocols;
    const int64_t gi = cell0 + (int64_t)(w.r0 + orr) * C + (w.c0 + occ);
    g.a_reg[d][gi] = g.a_reg[s][gi];
    g.p_reg[d][gi] = g.p_reg[s][gi];
    g.a_v[d][gi] = g.a_v[s][gi];
    g.p_v[d][gi] = g.p_v[s][gi];
    g.a_idx[d][gi] = g.a_idx[s][gi];
  }
  for (int x = threadIdx.x; x < orows; x += kThreads) {
    const int64_t row = row0 + w.r0 + x;
    if (w.c0 == 0) g.widx[d][row] = g.widx[s][row];
    if (w.c1 == C) g.east_cnt[d][row] = g.east_cnt[s][row];
  }
  for (int x = threadIdx.x; x < ocols; x += kThreads) {
    const int64_t col = col0 + w.c0 + x;
    if (w.r0 == 0) g.nidx[d][col] = g.nidx[s][col];
    if (w.r1 == R) g.south_cnt[d][col] = g.south_cnt[s][col];
  }
}

__global__ void __launch_bounds__(kThreads)
systolic_window(const StepArgs g, const int s, const int kk, const int br,
                const int bc, const int ncell_max, const int wr_max,
                const int wc_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  Window w;
  w.a = reinterpret_cast<float*>(smem);
  w.p = w.a + ncell_max;
  w.b = w.p + ncell_max;
  w.ain = w.b + ncell_max;
  w.y = w.ain + ncell_max;
  w.ai = reinterpret_cast<int*>(w.y + ncell_max);
  w.widx = w.ai + ncell_max;
  w.ecnt = w.widx + wr_max;
  w.nidx = w.ecnt + wr_max;
  w.scnt = w.nidx + wc_max;
  w.f = reinterpret_cast<uint8_t*>(w.scnt + wc_max);
  w.fire = w.f + ncell_max;

  const int d = s ^ 1;
  const int R = g.R, C = g.C;
  w.r0 = blockIdx.y * br;
  w.c0 = blockIdx.x * bc;
  w.r1 = min(R, w.r0 + br);
  w.c1 = min(C, w.c0 + bc);
  if (g.stop != nullptr && *g.stop != 0) {
    carry_block(g, w, s, d, (int64_t)blockIdx.z);
    return;
  }
  w.rl = max(0, w.r0 - kk);
  w.cl = max(0, w.c0 - kk);
  const int rh = min(R, w.r1 + kk), ch = min(C, w.c1 + kk);
  w.wrows = rh - w.rl;
  w.wcols = ch - w.cl;
  w.P = pitch_of(w.wcols);
  w.row0 = (int64_t)blockIdx.z * R;
  w.col0 = (int64_t)blockIdx.z * C;
  w.cell0 = w.row0 * C;
  const int wrows = w.wrows, wcols = w.wcols, P = w.P;
  const int tid = threadIdx.x;

  // ---- load the window from buffer s
  for (int x = tid; x < wrows * wcols; x += kThreads) {
    const int wr = x / wcols, wc = x - wr * wcols;
    const int64_t gi = w.cell0 + (int64_t)(w.rl + wr) * C + (w.cl + wc);
    const int xs = wr * P + wc + kOff;
    w.a[xs] = g.a_reg[s][gi];
    w.p[xs] = g.p_reg[s][gi];
    w.b[xs] = g.b[gi];
    w.ai[xs] = g.a_idx[s][gi];
    w.f[xs] = (g.a_v[s][gi] ? A_V : 0) | (g.p_v[s][gi] ? P_V : 0) |
              (g.is_w[gi] ? IS_W : 0) | (g.is_n[gi] ? IS_N : 0) |
              (g.is_s[gi] ? IS_S : 0) | (g.is_e[gi] ? IS_E : 0);
  }
  for (int x = tid; x < wrows; x += kThreads) {
    w.widx[x] = g.widx[s][w.row0 + w.rl + x];
    w.ecnt[x] = g.east_cnt[s][w.row0 + w.rl + x];
  }
  for (int x = tid; x < wcols; x += kThreads) {
    w.nidx[x] = g.nidx[s][w.col0 + w.cl + x];
    w.scnt[x] = g.south_cnt[s][w.col0 + w.cl + x];
  }
  __syncthreads();

  // The interior (rows 1..wrows-2, columns 1..4*ng) runs in aligned groups
  // of 4 cells on packed words: 4 flag bytes, float4s.  The rest — the
  // window's border and the columns past the last whole group — runs cell
  // by cell (edge_fire / edge_commit), as does a group holding an edge
  // flag.  So a warp's lanes take one path or the other.
  const int ng = wcols >= 2 ? (wcols - 2) / 4 : 0;  // whole groups a row
  const int n_in = wrows >= 2 ? wrows - 2 : 0;      // interior rows
  const int lo = 4 * ng + 1;                        // first leftover column
  const int n_rest = 1 + wcols - lo;                // cells a row past groups
  const int n_brd = wrows > 1 ? 2 : 1;              // border rows
  const int n_fast = n_in * ng, n_edge = n_brd * wcols + n_in * n_rest;
  // the edge cell of index j: border rows first, then per interior row
  // its column 0 and its leftover columns
  auto edge_cell = [&](int j, int& wr, int& wc) {
    if (j < n_brd * wcols) {
      wr = j < wcols ? 0 : wrows - 1;
      wc = j < wcols ? j : j - wcols;
    } else {
      const int t = j - n_brd * wcols, u = t % n_rest;
      wr = 1 + t / n_rest;
      wc = u == 0 ? 0 : lo + u - 1;
    }
  };

  for (int cyc = 0; cyc < kk; ++cyc) {
    // ---- pass 1: fire, a_in and y of every window cell; edge work
    for (int i = tid; i < n_fast; i += kThreads) {
      const int wr = 1 + i / ng, x0 = wr * P + 4 * (1 + i % ng);
      const uint32_t f4 = at<uint32_t>(w.f, x0);
      if (f4 & (kLanes * FLAGS)) {
        for (int j = 0; j < 4; ++j) edge_fire(g, w, wr, x0 - wr * P - kOff + j);
        continue;
      }
      // byte j: cell j's west neighbour's flags, north neighbour's flags
      const uint32_t fw = (f4 << 8) | w.f[x0 - 1];
      const uint32_t fn = at<uint32_t>(w.f, x0 - P);
      const uint32_t fire = fw & (fn >> 1) & ~(f4 | (f4 >> 1)) & kLanes;
      at<uint32_t>(w.fire, x0) = fire * (FIRE | CONS_A | CONS_P);
      if (fire) {
        const float4 a4 = at<float4>(w.a, 4 * x0);
        const float4 pn = at<float4>(w.p, 4 * (x0 - P));
        const float4 b4 = at<float4>(w.b, 4 * x0);
        const float4 ain = make_float4(w.a[x0 - 1], a4.x, a4.y, a4.z);
        at<float4>(w.ain, 4 * x0) = ain;
        at<float4>(w.y, 4 * x0) = make_float4(
            mac(pn.x, ain.x, b4.x), mac(pn.y, ain.y, b4.y),
            mac(pn.z, ain.z, b4.z), mac(pn.w, ain.w, b4.w));
      }
    }
    for (int j = tid; j < n_edge; j += kThreads) {
      int wr, wc;
      edge_cell(j, wr, wc);
      edge_fire(g, w, wr, wc);
    }
    __syncthreads();
    // ---- pass 2: latch where fired, drain what the neighbours consumed
    for (int i = tid; i < n_fast; i += kThreads) {
      const int wr = 1 + i / ng, x0 = wr * P + 4 * (1 + i % ng);
      const uint32_t f4 = at<uint32_t>(w.f, x0);
      if (f4 & (kLanes * FLAGS)) {
        for (int j = 0; j < 4; ++j) edge_commit(g, w, wr, x0 - wr * P - kOff + j);
        continue;
      }
      const uint32_t fire4 = at<uint32_t>(w.fire, x0);
      const uint32_t fired = fire4 & kLanes;
      // byte j: cell j's east neighbour's fire byte, south neighbour's
      const uint32_t fe = (fire4 >> 8) | ((uint32_t)w.fire[x0 + 4] << 24);
      const uint32_t fs = at<uint32_t>(w.fire, x0 + P);
      const uint32_t av = fired | (f4 & ~(fe >> 1) & kLanes);
      const uint32_t pv = fired | ((f4 >> 1) & ~(fs >> 2) & kLanes);
      at<uint32_t>(w.f, x0) = (f4 & ~(kLanes * (A_V | P_V))) | av | (pv << 1);
      if (fired) {
        const float4 ain = at<float4>(w.ain, 4 * x0), y = at<float4>(w.y, 4 * x0);
        float4 a4 = at<float4>(w.a, 4 * x0), p4 = at<float4>(w.p, 4 * x0);
        if (fired & 0x1u) { a4.x = ain.x; p4.x = y.x; }
        if (fired & 0x100u) { a4.y = ain.y; p4.y = y.y; }
        if (fired & 0x10000u) { a4.z = ain.z; p4.z = y.z; }
        if (fired & 0x1000000u) { a4.w = ain.w; p4.w = y.w; }
        at<float4>(w.a, 4 * x0) = a4;
        at<float4>(w.p, 4 * x0) = p4;
      }
    }
    for (int j = tid; j < n_edge; j += kThreads) {
      int wr, wc;
      edge_cell(j, wr, wc);
      edge_commit(g, w, wr, wc);
    }
    __syncthreads();
  }

  // ---- write the owned block, and the counters of owned rows / columns,
  // to buffer d
  const int orows = w.r1 - w.r0, ocols = w.c1 - w.c0;
  for (int x = tid; x < orows * ocols; x += kThreads) {
    const int orr = x / ocols, occ = x - orr * ocols;
    const int xs = (w.r0 + orr - w.rl) * P + (w.c0 + occ - w.cl) + kOff;
    const int64_t gi = w.cell0 + (int64_t)(w.r0 + orr) * C + (w.c0 + occ);
    const uint8_t f = w.f[xs];
    g.a_reg[d][gi] = w.a[xs];
    g.p_reg[d][gi] = w.p[xs];
    g.a_v[d][gi] = (f & A_V) ? 1 : 0;
    g.p_v[d][gi] = (f & P_V) ? 1 : 0;
    g.a_idx[d][gi] = w.ai[xs];
  }
  for (int x = tid; x < orows; x += kThreads) {
    if (w.c0 == 0) g.widx[d][w.row0 + w.r0 + x] = w.widx[w.r0 - w.rl + x];
    if (w.c1 == C) g.east_cnt[d][w.row0 + w.r0 + x] = w.ecnt[w.r0 - w.rl + x];
  }
  for (int x = tid; x < ocols; x += kThreads) {
    if (w.r0 == 0) g.nidx[d][w.col0 + w.c0 + x] = w.nidx[w.c0 - w.cl + x];
    if (w.r1 == R) g.south_cnt[d][w.col0 + w.c0 + x] = w.scnt[w.c0 - w.cl + x];
  }
}

__global__ void mac_kernel(const float* p, const float* a, const float* b,
                           float* out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mac(p[i], a[i], b[i]);
}

extern "C" int systolic_step(const StepArgs* args, int k_cycles, int block_r,
                             int block_c, int k, int64_t smem_bytes,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const StepArgs g = *args;
  if (g.T <= 0 || g.R <= 0 || g.C <= 0 || g.M <= 0 || g.W <= 0 || k_cycles < 0 ||
      block_r < 1 || block_c < 1 || k < 1 || g.T > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = window_smem(g.R, g.C, block_r, block_c, k);
  if (smem != smem_bytes || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int wr_max = g.R < block_r + 2 * k ? g.R : block_r + 2 * k;
  const int wc_max = g.C < block_c + 2 * k ? g.C : block_c + 2 * k;
  const int ncell_max = wr_max * pitch_of(wc_max);
  // Raised once a device to the largest size asked, before any launch
  // that needs it: a call made while a CUDA graph captures the stream (the
  // until-loop warms its span up first) then makes no call but launches.
  static int64_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(systolic_window,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const dim3 grid((g.C + block_c - 1) / block_c, (g.R + block_r - 1) / block_r, g.T);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int launch = 0;
  for (int done = 0; done < k_cycles; done += k, ++launch) {
    const int kk = k_cycles - done < k ? k_cycles - done : k;
    systolic_window<<<grid, kThreads, (size_t)smem, stream>>>(
        g, launch & 1, kk, block_r, block_c, ncell_max, wr_max, wc_max);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" int systolic_mac(const float* p, const float* a, const float* b,
                            float* out, int64_t n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  mac_kernel<<<blocks, 256, 0, stream>>>(p, a, b, out, n);
  return (int)cudaGetLastError();
}
