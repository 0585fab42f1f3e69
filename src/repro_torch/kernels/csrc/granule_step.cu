// granule_step.cu — the fused engine's resident epoch program for Hopper
// (sm_90a), with each block type's step as a device function.
//
// Replaces: src/repro/kernels/granule_step.py::pallas_program (the one
// pl.pallas_call at granule_step.py:306, kernel body `kernel` at :241),
// which runs FusedEngine._cycle_body and the tier exchange with the
// granule state resident in TPU VMEM, for any block types and groups.
//
// What it computes: one call of granule_program() walks an op program on
// the flat batched layout of repro_torch.core.fused (all B batch rows in
// each launch) on the caller's stream:
//   ("C", n)  n cycles, ONE launch each (granule_cycle): one thread per
//             flat block slot of every group.  Each group owns a range of
//             threads that starts on a warp boundary (no warp spans two
//             groups, so no warp runs two steps); a thread finds its group
//             and runs the group's block step (a switch on its type code)
//             and commits everything the slot owns:
//               * each register it produces: the push is its own valid &&
//                 the register was empty before the cycle (the payload
//                 goes straight into reg_val); the pop is the consumer's
//                 readiness, recomputed here from the consumer's pre-cycle
//                 state through the consumer table `cons`.  A consumer may
//                 sit in another group, of another type: its flat id
//                 (the inverse map's, groups in order, slot * 2 + port)
//                 names the group, and the readiness is that group's
//                 type's, gated by that group's clock;
//               * each boundary or external queue row it touches: an
//                 egress row is pushed by its producer (head), an ingress
//                 row popped by its consumer (tail); the other end of a
//                 row moves only in the exchange launches (the wrapper
//                 checks that every row has at most one local side).
//             No payload, valid or ready goes through device memory
//             between threads.
//   ("X", t)  tier t's exchange: drain, move-and-fill, credit return —
//             three launches over (batch row, slot).
//   ("XI", t) / ("XC", t)  the issue (drain) and commit (move-and-fill,
//             credit return) halves of the same exchange.
// Ops run in program order, so the result is bit-identical to the plain
// PyTorch version (repro_torch.kernels.granule_step.epoch_program_ref).
//
// Block types with a device step (type codes of Group::type):
//   0 ManycoreCell  (repro_torch/hw/manycore.py): the ring allreduce core.
//     Its readiness on an in port: en && may_accept && the port matches its
//     phase, which needs its phase, sent, rcvd, fwd_v and the readiness of
//     its own active output channel.
//   1 SystolicCell  (repro_torch/hw/systolic.py): the MAC cell, edge
//     synthesis from is_west/is_north/is_east/is_south,
//     fire = a_valid & psum_valid & e_rdy & s_rdy, y = fma(a, b, psum) by
//     __fmaf_rn (one rounding, as XLA contracts the reference's
//     `psum + a * b`; written as an intrinsic so that nvcc cannot contract
//     or split anything else), a_buf read on west cells and y_buf written
//     on south collects only.  Its readiness on w_in (n_in): its fire from
//     its pre-cycle state and not is_west (is_north): the valid of its
//     other input, the readiness of both its outputs (an empty register, as
//     a push sees it) and its flags; on a west cell a_valid is a_idx < M.
//   2 PipeStage     (repro_torch/hw/pipestage.py): the host-I/O unit cell,
//     one in port and one out port: fire = valid_in && ready_out, the
//     front forwarded with the group's `delta` added to word 0 by
//     __fadd_rn (PyTorch's f32 add of the block's delta cast to f32), and
//     count += fire.  Its readiness on its in port is the readiness of its
//     output channel.  Its port tables hold one column and its flat
//     consumer ids one a slot (in_base + slot), where the other types have
//     two.
// granule_cycle is instantiated for each set of types a program holds, so
// the wafer's kernel carries ManycoreCell's code alone; a set that holds
// PipeStage adds instantiations and leaves the others' code as it was.
//
// The pre-cycle snapshot, by parity: every leaf that another thread reads
// within a cycle is read from buffer s = cycle parity and written to
// buffer s ^ 1 (every cycle, also where it does not change):
//   * reg_v and the queue heads and tails (a consumer's readiness reads the
//     valid of its other input, which may be an ingress row whose tail its
//     consumer moves; an output's readiness reads head and tail);
//   * ManycoreCell: phase, sent, rcvd, fwd_v;
//   * SystolicCell: a_idx, read by the producer of a west cell's n_in (its
//     a_valid).  Only west cells step a_idx, so only they write buffer
//     s ^ 1; both buffers start equal and stay so elsewhere.  The flags and
//     b are read-only; y_idx, y_buf and fires only their owner touches.
// reg_val needs no second buffer: a producer writes a register only when
// it was empty before the cycle, and a consumer reads it only when it was
// full.  Leaves only their owner touches stay in place.  The cycle counter
// is read as base + offset (the offset is a launch argument) and advanced
// once at the end of the program; after an odd number of cycles the
// buffer-1 leaves are copied back (copy_back), so the results are always
// in the carry's own tensors.
//
// The until-loop's stop flag (ProgramArgs::stop, a device bool; null
// outside the loop): every launch of the program reads it and, where it
// is set, returns before its first write, the copy-back and the cycle
// advance included.  Nothing is written to buffer 0 then, so the carry's
// own tensors keep the state as it was; the program's host side is the
// same either way, which lets a CUDA graph replay it whatever the flag
// holds (repro_torch.core.device_loop).  granule_cycle checks the flag
// after a slot's first loads, so their latency hides the flag's: checked
// first, the flag cost the wafer's cycle 0.5-0.6% and the fused systolic
// grid's 0.6-2.2% (chip_smoke.py's flag_cost, H100 80GB HBM3, 700 W);
// checked there, nothing measurable.
//
// What bounds it now: device memory.  ManycoreCell reads ~29 B of block
// state a slot and writes ~25 B, reads the port tables (16 B) and the
// consumer table (8 B), the register flags on the slot's ports and, through
// the consumer table, its neighbours' pre-cycle state (mostly from L1/L2:
// the east neighbour is the next slot), and writes the payload of each
// push: ~80-90 B a core against ~100 integer operations.  SystolicCell
// reads its flags, b and the tables (~28 B), its input registers' valids
// and, on a fire, their payloads and the consumers' flags and registers,
// and writes its output flags and pushed payloads.  The first design (two
// launches a cycle: a step that wrote pay/val/rr for both output ports to
// scratch, and a commit over the channels through the inverse maps) moved
// ~160 B a core and ran at 0.0744-0.0758 ms a cycle at 1M ManycoreCells on
// an H100 80GB HBM3 at 700 W (42.8 us step, 27.9 us commit); this design
// drops the scratch round trip, the inverse maps and the second launch.
//
// Exactness: ManycoreCell's values are exact integers in f32 and its only
// float arithmetic is one add per accepted packet; SystolicCell's is one
// __fmaf_rn per fire.  Booleans are 1-byte uint8 (torch.bool).
#include <cuda_runtime.h>
#include <stdint.h>

enum BlockType { kManycore = 0, kSystolic = 1, kPipe = 2, kNumTypes = 3 };
static const int kMaxGroups = 4;
static const int kThreads = 256;
// 8 CTAs of 256 threads an SM: the full 2048 threads, 32 registers each.
// Left to itself ptxas gave the generic cycle 40 registers (6 CTAs an SM),
// and the wafer's cycle, bound by the latency of its scattered loads, took
// 0.0411 ms; capped at 32 (no spills for one block type), 0.0384 against
// the one-type kernel's 0.0377 in the same call (1M cores, H100 80GB HBM3,
// 700 W).
static const int kMinBlocks = 8;

// Field order of the structs below must match the ctypes mirrors in
// repro_torch.kernels.granule_step (_CoreLeaves, _CellLeaves, _PipeLeaves,
// _Group, _ProgramArgs); granule_args_size() lets the wrapper check the
// layout.
struct CoreLeaves {  // ManycoreCell's CoreState, (n_slot,) each; `value` unused
  float* own;
  float* acc;
  float* total;
  int32_t* phase[2];  // by cycle parity
  int32_t* sent[2];
  int32_t* rcvd[2];
  float* fwd;
  uint8_t* fwd_v[2];
  int32_t* fires;
  int32_t R;
  int32_t C;
};

struct CellLeaves {  // SystolicCell's CellState
  const float* b;          // (n_slot,)
  const uint8_t* is_west;  // (n_slot,) each
  const uint8_t* is_north;
  const uint8_t* is_south;
  const uint8_t* is_east;
  const float* a_buf;      // (n_slot, M)
  int32_t* a_idx[2];       // (n_slot,), by cycle parity (west cells write)
  float* y_buf;            // (n_slot, M)
  int32_t* y_idx;
  int32_t* fires;
  int32_t M;
};

struct PipeLeaves {  // PipeStage's PipeStageState
  int32_t* count;  // (n_slot,) handshakes forwarded
  float delta;     // added to word 0 (the group's block constant)
};

struct Group {
  int32_t type;     // BlockType
  int32_t base;     // first thread, a multiple of 32
  int32_t n_slot;   // flat slots (all batch rows)
  int32_t in_base;  // flat consumer id of slot 0, port 0
  int32_t divider;  // clock divider
  // port tables in combined ids: [0, n_reg) registers, then queue rows
  const int32_t* rx_idx;  // (n_slot, 2); PipeStage (n_slot, 1)
  const int32_t* tx_idx;  // (n_slot, 2); PipeStage (n_slot, 1)
  // consumer of each output port: a flat consumer id, -1 for none (a queue
  // row), -2 where the port drives no channel (a sentinel)
  const int32_t* cons;    // (n_slot, 2); PipeStage (n_slot, 1)
  union {
    CoreLeaves core;
    CellLeaves cell;
    PipeLeaves pipe;
  } u;
};

struct ProgramArgs {
  // register file (flat: row b's registers at b*n_reg_row + c)
  float* reg_val;        // (n_reg, W)
  uint8_t* reg_v[2];     // (n_reg,), by cycle parity
  // boundary queues (flat rows b*n_q_row + k)
  float* q_buf;          // (n_qrows, cap, W)
  int32_t* q_head[2];    // (n_qrows,), by cycle parity
  int32_t* q_tail[2];
  int32_t* cycle;        // () cycle counter at the program's start
  // () the until-loop's stop flag, or null: where it is set, every launch
  // of the program returns at once and the carry stays as it was
  const uint8_t* stop;
  int32_t n_reg;
  int32_t n_qrows;       // queue rows in the carry (1 when have_q == 0)
  int32_t n_q_row;       // queue rows per batch row
  int32_t cap;
  int32_t have_q;
  int32_t W;
  int32_t n_groups;
  int32_t n_threads;     // the last group's base + n_slot
  Group g[kMaxGroups];
};

struct TierArgs {
  const int32_t* send_idx;   // (B, S) queue row within the batch row
  const uint8_t* send_mask;  // (B, S)
  const int32_t* recv_idx;   // (B, S)
  const uint8_t* recv_mask;  // (B, S)
  const int32_t* bat_fwd;    // (B, S) source batch row of the slab
  const int32_t* bat_rev;    // (B, S) batch row whose credit returns here
  int32_t* credits;          // (B, S) send credits (state)
  float* slab;               // (B, S, E, W) scratch
  int32_t* cnt;              // (B, S) scratch
  int32_t* cred;             // (B, S) scratch
  int32_t B;
  int32_t S;
  int32_t E;
};

// The until-loop's stop flag is set (a null flag never is).
__device__ __forceinline__ bool stopped(const uint8_t* stop) {
  return stop != nullptr && *stop != 0;
}

// (x mod cap) in [0, cap): C's % keeps the dividend's sign.
__device__ __forceinline__ int ring(int x, int cap) {
  int r = x % cap;
  return r < 0 ? r + cap : r;
}

__device__ __forceinline__ int2 pair_at(const int32_t* t, int i) {
  return reinterpret_cast<const int2*>(t)[i];
}

// The group's clock enable on this cycle.
__device__ __forceinline__ bool enabled(const ProgramArgs& a, const Group& g,
                                        int off) {
  return g.divider == 1 || ((a.cycle[0] + off) % g.divider) == 0;
}

// Pre-cycle readiness of output channel c (a register or an egress row).
__device__ __forceinline__ bool chan_ready(const ProgramArgs& a, int s, int c) {
  if (c < a.n_reg) return a.reg_v[s][c] == 0;
  const int k = c - a.n_reg;
  return ring(a.q_head[s][k] - a.q_tail[s][k], a.cap) < a.cap - 1;
}

// Pre-cycle valid of input channel c (a register or an ingress row).
__device__ __forceinline__ bool chan_valid(const ProgramArgs& a, int s, int c) {
  if (c < a.n_reg) return a.reg_v[s][c] != 0;
  const int k = c - a.n_reg;
  return a.q_head[s][k] != a.q_tail[s][k];
}

// Pre-cycle front of input channel c, words 0 and 1 (only when valid).
__device__ __forceinline__ float2 chan_front(const ProgramArgs& a, int s, int c) {
  int64_t at;
  if (c < a.n_reg) {
    at = (int64_t)c * a.W;
    return make_float2(a.reg_val[at], a.reg_val[at + 1]);
  }
  const int k = c - a.n_reg;
  at = ((int64_t)k * a.cap + a.q_tail[s][k]) * a.W;
  return make_float2(a.q_buf[at], a.q_buf[at + 1]);
}

// ---------------------------------------------------------------- readiness
// ManycoreCell's readiness on in port pj of slot j, from j's pre-cycle
// state (clock enable aside): may_accept && the port is the one of j's
// phase.
__device__ __forceinline__ bool core_ready(const ProgramArgs& a, const Group& g,
                                           int s, int j, int pj) {
  const CoreLeaves& L = g.u.core;
  const int phase = L.phase[s][j];
  const bool in_row = phase == 0;
  if (phase >= 2 || (pj == 0) != in_row) return false;
  const int rcvd = L.rcvd[s][j];
  const int need = in_row ? L.C - 1 : L.R - 1;
  if (rcvd >= need) return false;
  if (rcvd >= need - 1 || L.fwd_v[s][j] == 0) return true;  // !will_fwd || !fwd_v
  // the forward register is busy: j accepts only if it frees it by
  // sending a forward this cycle (can_send with fwd_v set, sent > 0)
  const int sent = L.sent[s][j];
  if (sent <= 0 || sent >= need) return false;
  return chan_ready(a, s, g.tx_idx[2 * j + (in_row ? 0 : 1)]);
}

// SystolicCell's readiness on in port pj of slot j (its fire, and the port
// not synthesized), from j's pre-cycle state (clock enable aside).  The
// caller's register on that port is full, so that input is valid.
__device__ __forceinline__ bool cell_ready(const ProgramArgs& a, const Group& g,
                                           int s, int j, int pj) {
  const CellLeaves& L = g.u.cell;
  const bool west = L.is_west[j] != 0;
  const bool north = L.is_north[j] != 0;
  if (pj == 0 ? west : north) return false;
  const int2 rx = pair_at(g.rx_idx, j);
  const int2 tx = pair_at(g.tx_idx, j);
  const bool a_valid = pj == 0 || (west ? L.a_idx[s][j] < L.M : chan_valid(a, s, rx.x));
  if (!a_valid) return false;
  if (pj == 0 && !north && !chan_valid(a, s, rx.y)) return false;  // psum_valid
  if (L.is_east[j] == 0 && !chan_ready(a, s, tx.x)) return false;
  return L.is_south[j] != 0 || chan_ready(a, s, tx.y);
}

// PipeStage's readiness on its in port of slot j (clock enable aside): the
// readiness of its output channel (the caller's register is full, so its
// input is valid and it fires exactly when it may send).
__device__ __forceinline__ bool pipe_ready(const ProgramArgs& a, const Group& g,
                                           int s, int j) {
  return chan_ready(a, s, g.tx_idx[j]);
}

// Readiness of the consumer with flat id `cons` (>= 0), its clock included:
// the group whose in-port range holds it, by that group's type.
template <int kMask>
__device__ __forceinline__ bool consumer_ready(const ProgramArgs& a, int s,
                                               int off, int cons) {
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi >= a.n_groups) return false;
    const Group& g = a.g[gi];
    const bool pipe = (kMask & (1 << kPipe)) && g.type == kPipe;
    const int k = cons - g.in_base;
    if (k < 0 || k >= (pipe ? 1 : 2) * g.n_slot) continue;
    if (!enabled(a, g, off)) return false;
    if ((kMask & (1 << kManycore)) && g.type == kManycore)
      return core_ready(a, g, s, k >> 1, k & 1);
    if ((kMask & (1 << kSystolic)) && g.type == kSystolic)
      return cell_ready(a, g, s, k >> 1, k & 1);
    if (pipe) return pipe_ready(a, g, s, k);
    return false;
  }
  return false;
}

// Commit of output port p of a slot: a register (push into empty, pop by
// the consumer's readiness) or an egress row (push at the head; the tail,
// which only the exchanges move, carried to buffer d).
template <int kMask>
__device__ __forceinline__ void commit_out(const ProgramArgs& a, int s, int off,
                                           int c, int cons, bool val,
                                           float w0, float w1) {
  const int d = s ^ 1;
  if (cons == -2) return;
  if (c < a.n_reg) {
    const bool v = a.reg_v[s][c] != 0;
    const bool push = val && !v;
    const bool pop = v && cons >= 0 && consumer_ready<kMask>(a, s, off, cons);
    if (push) {
      a.reg_val[(int64_t)c * a.W] = w0;
      a.reg_val[(int64_t)c * a.W + 1] = w1;
    }
    a.reg_v[d][c] = ((v && !pop) || push) ? 1 : 0;
    return;
  }
  const int k = c - a.n_reg;
  const int h = a.q_head[s][k];
  const int t = a.q_tail[s][k];
  const int h1 = ring(h + 1, a.cap);
  a.q_tail[d][k] = t;
  if (val && h1 != t) {
    const int64_t slot = ((int64_t)k * a.cap + h) * a.W;
    a.q_buf[slot] = w0;
    a.q_buf[slot + 1] = w1;
    a.q_head[d][k] = h1;
  } else {
    a.q_head[d][k] = h;
  }
}

// In port channel c of a slot, where it is a queue row (ingress or
// external-in): pop its tail when `pop`, carry its head to buffer d.
__device__ __forceinline__ void commit_in(const ProgramArgs& a, int s, int c,
                                          bool pop) {
  if (c < a.n_reg) return;
  const int d = s ^ 1;
  const int k = c - a.n_reg;
  const int t = a.q_tail[s][k];
  a.q_head[d][k] = a.q_head[s][k];
  a.q_tail[d][k] = pop ? ring(t + 1, a.cap) : t;
}

// ------------------------------------------------------------------ steps
// ManycoreCell.step (repro_torch/hw/manycore.py) on slot i of group g.
template <int kMask>
__device__ __forceinline__ void core_step(const ProgramArgs& a, const Group& g,
                                          int i, int s, int off, bool halt) {
  const CoreLeaves& L = g.u.core;
  const int d = s ^ 1;
  const bool en = enabled(a, g, off);
  const int2 rx = pair_at(g.rx_idx, i);
  const int2 tx = pair_at(g.tx_idx, i);
  const int2 cn = pair_at(g.cons, i);
  const int phase = L.phase[s][i], sent = L.sent[s][i], rcvd = L.rcvd[s][i];
  const bool fwd_v = L.fwd_v[s][i] != 0;
  if (halt) return;  // after the slot's first loads, which overlap the flag's

  const bool in_row = phase == 0;
  const bool live = phase < 2;
  const int need = in_row ? L.C - 1 : L.R - 1;

  // the active in port's pre-cycle front and valid
  const int c_in = in_row ? rx.x : rx.y;
  const bool in_valid_raw = chan_valid(a, s, c_in);
  float in_val = 0.0f;
  if (in_valid_raw) {
    in_val = c_in < a.n_reg
        ? a.reg_val[(int64_t)c_in * a.W]
        : a.q_buf[((int64_t)(c_in - a.n_reg) * a.cap + a.q_tail[s][c_in - a.n_reg]) * a.W];
  }
  const bool out_ready = chan_ready(a, s, in_row ? tx.x : tx.y);
  const bool in_valid = live && in_valid_raw;

  const bool can_send = live && sent < need && (sent == 0 || fwd_v);
  const bool did_send = can_send && out_ready;
  const bool fwd_freed = did_send && sent > 0;

  const bool will_fwd = rcvd < need - 1;
  const bool may_accept = live && rcvd < need && (!will_fwd || !fwd_v || fwd_freed);
  const bool accept = may_accept && in_valid;

  // in ports: pop the active ingress row; carry every row's head and tail
  commit_in(a, s, rx.x, en && may_accept && in_valid_raw && c_in == rx.x);
  commit_in(a, s, rx.y, en && may_accept && in_valid_raw && c_in == rx.y);

  // out ports: payload [out_val, sent] on the port of the phase
  const float out_val = did_send ? (sent == 0 ? L.own[i] : L.fwd[i]) : 0.0f;
  const float tag = (float)sent;
  commit_out<kMask>(a, s, off, tx.x, cn.x, en && did_send && in_row, out_val, tag);
  commit_out<kMask>(a, s, off, tx.y, cn.y, en && did_send && !in_row, out_val, tag);

  // the slot's own state (a divided clock holds it on this cycle)
  if (!en) {
    L.phase[d][i] = phase;
    L.sent[d][i] = sent;
    L.rcvd[d][i] = rcvd;
    L.fwd_v[d][i] = fwd_v ? 1 : 0;
    return;
  }
  const int sent2 = sent + (did_send ? 1 : 0);
  const int rcvd2 = rcvd + (accept ? 1 : 0);
  const float acc2 = __fadd_rn(L.acc[i], accept ? in_val : 0.0f);
  const bool fwd_v2 = (fwd_v && !fwd_freed) || (accept && will_fwd);
  const bool done_phase = live && sent2 == need && rcvd2 == need;

  if (done_phase) L.own[i] = acc2;
  L.acc[i] = acc2;
  if (done_phase && phase == 1) L.total[i] = acc2;
  if (accept && will_fwd) L.fwd[i] = in_val;
  if (did_send || accept) L.fires[i] += (did_send ? 1 : 0) + (accept ? 1 : 0);
  L.phase[d][i] = phase + (done_phase ? 1 : 0);
  L.sent[d][i] = done_phase ? 0 : sent2;
  L.rcvd[d][i] = done_phase ? 0 : rcvd2;
  L.fwd_v[d][i] = fwd_v2 ? 1 : 0;
}

// SystolicCell.step (repro_torch/hw/systolic.py) on slot i of group g.
template <int kMask>
__device__ __forceinline__ void cell_step(const ProgramArgs& a, const Group& g,
                                          int i, int s, int off, bool halt) {
  const CellLeaves& L = g.u.cell;
  const int d = s ^ 1;
  const bool en = enabled(a, g, off);
  const int2 rx = pair_at(g.rx_idx, i);
  const int2 tx = pair_at(g.tx_idx, i);
  const int2 cn = pair_at(g.cons, i);
  const bool west = L.is_west[i] != 0, north = L.is_north[i] != 0;
  const bool south = L.is_south[i] != 0, east = L.is_east[i] != 0;
  if (halt) return;  // after the slot's first loads, which overlap the flag's

  // edge synthesis: a west cell streams a_buf, a north cell adds to 0
  const int a_idx = west ? L.a_idx[s][i] : 0;
  const bool w_valid = chan_valid(a, s, rx.x);
  const bool n_valid = chan_valid(a, s, rx.y);
  const bool a_valid = west ? a_idx < L.M : w_valid;
  const bool psum_valid = north || n_valid;
  const bool e_rdy = east || chan_ready(a, s, tx.x);
  const bool s_rdy = south || chan_ready(a, s, tx.y);
  const bool fire = a_valid && psum_valid && e_rdy && s_rdy;

  // the operands, read only where the cell fires (the outputs of a cycle
  // without a fire carry no valid)
  float a_val = 0.0f, a_tag = 0.0f, y = 0.0f;
  if (fire) {
    if (west) {
      a_val = L.a_buf[(int64_t)i * L.M + a_idx % L.M];
      a_tag = (float)a_idx;
    } else {
      const float2 w = chan_front(a, s, rx.x);
      a_val = w.x;
      a_tag = w.y;
    }
    const float psum = north ? 0.0f : chan_front(a, s, rx.y).x;
    y = __fmaf_rn(a_val, L.b[i], psum);
  }

  // in ports: pop a queue row that fed the fire; carry heads and tails
  commit_in(a, s, rx.x, en && fire && !west && w_valid);
  commit_in(a, s, rx.y, en && fire && !north && n_valid);
  // out ports: [a_val, a_tag] east, [y, a_tag] south
  commit_out<kMask>(a, s, off, tx.x, cn.x, en && fire && !east, a_val, a_tag);
  commit_out<kMask>(a, s, off, tx.y, cn.y, en && fire && !south, y, a_tag);

  // the slot's own state (a divided clock holds it on this cycle)
  const bool step = en && fire;
  if (west) L.a_idx[d][i] = a_idx + (step ? 1 : 0);
  if (!step) return;
  L.fires[i] += 1;
  if (south) {
    const int yi = L.y_idx[i];
    L.y_buf[(int64_t)i * L.M + yi % L.M] = y;
    L.y_idx[i] = yi + 1;
  }
}

// PipeStage.step (repro_torch/hw/pipestage.py) on slot i of group g.
template <int kMask>
__device__ __forceinline__ void pipe_step(const ProgramArgs& a, const Group& g,
                                          int i, int s, int off, bool halt) {
  const PipeLeaves& L = g.u.pipe;
  const bool en = enabled(a, g, off);
  const int rx = g.rx_idx[i], tx = g.tx_idx[i], cn = g.cons[i];
  const bool valid = chan_valid(a, s, rx);
  const bool ready = chan_ready(a, s, tx);
  if (halt) return;  // after the slot's first loads, which overlap the flag's

  const bool fire = valid && ready;
  float2 pay = make_float2(0.0f, 0.0f);
  if (fire) pay = chan_front(a, s, rx);
  // in port: pop a queue row that fed the fire; out port: the front with
  // delta added to word 0 (the outputs of a cycle without a fire carry no
  // valid)
  commit_in(a, s, rx, en && fire);
  commit_out<kMask>(a, s, off, tx, cn, en && fire, __fadd_rn(pay.x, L.delta), pay.y);
  if (en && fire) L.count[i] += 1;
}

// One cycle of every slot of every group: the group's block step and the
// commit of every channel end the slot owns.  kMask: the block types the
// program holds (bit t for type t).
template <int kMask>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
granule_cycle(const ProgramArgs a, const int s, const int off) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool halt = stopped(a.stop);
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi >= a.n_groups) return;
    const Group& g = a.g[gi];
    if (i < g.base || i >= g.base + g.n_slot) continue;
    if ((kMask & (1 << kManycore)) && g.type == kManycore)
      core_step<kMask>(a, g, i - g.base, s, off, halt);
    else if ((kMask & (1 << kSystolic)) && g.type == kSystolic)
      cell_step<kMask>(a, g, i - g.base, s, off, halt);
    else if ((kMask & (1 << kPipe)) && g.type == kPipe)
      pipe_step<kMask>(a, g, i - g.base, s, off, halt);
    return;
  }
}

// Issue half: credit-bounded drain of every egress row into the slab.
// Rows whose count is 0 (padding, or no credit) are not written at all.
__global__ void exchange_drain(ProgramArgs a, TierArgs t, const int s) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S || stopped(a.stop)) return;
  const int b = j / t.S;
  const int limit = t.send_mask[j] ? t.credits[j] : 0;
  const int row = b * a.n_q_row + t.send_idx[j];
  const int tl = a.q_tail[s][row];
  int n = ring(a.q_head[s][row] - tl, a.cap);
  n = n < t.E ? n : t.E;
  n = n < limit ? n : limit;
  for (int e = 0; e < n; ++e) {
    const int64_t src = (int64_t)row * a.cap + ring(tl + e, a.cap);
    const int64_t dst = (int64_t)j * t.E + e;
    for (int w = 0; w < a.W; ++w) t.slab[dst * a.W + w] = a.q_buf[src * a.W + w];
  }
  t.cnt[j] = n;
  if (n > 0) a.q_tail[s][row] = ring(tl + n, a.cap);
}

// Commit half, part 1: gather the slab from its source batch row
// (bat_fwd), fill the ingress row up to its free space, and record the
// receiver's new free space as the credit to return.
__global__ void exchange_fill(ProgramArgs a, TierArgs t, const int s) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S || stopped(a.stop)) return;
  const int b = j / t.S, sl = j % t.S;
  const bool live = t.recv_mask[j] != 0;
  const int sj = t.bat_fwd[j] * t.S + sl;
  const int row = b * a.n_q_row + t.recv_idx[j];
  const int h = a.q_head[s][row];
  const int fr = (a.cap - 1) - ring(h - a.q_tail[s][row], a.cap);
  int n = live ? t.cnt[sj] : 0;
  n = n < fr ? n : fr;
  for (int e = 0; e < n; ++e) {
    const int64_t dst = (int64_t)row * a.cap + ring(h + e, a.cap);
    const int64_t src = (int64_t)sj * t.E + e;
    for (int w = 0; w < a.W; ++w) a.q_buf[dst * a.W + w] = t.slab[src * a.W + w];
  }
  if (n > 0) a.q_head[s][row] = ring(h + n, a.cap);
  t.cred[j] = live ? fr - n : 0;
}

// Commit half, part 2: credits return to the senders on bat_rev.
__global__ void exchange_credit(TierArgs t, const uint8_t* stop) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S || stopped(stop)) return;
  t.credits[j] = t.cred[t.bat_rev[j] * t.S + j % t.S];
}

// The program's cycles, added once at its end.
__global__ void advance_cycle(int32_t* cycle, int n, const uint8_t* stop) {
  if (!stopped(stop)) cycle[0] += n;
}

// After an odd cycle count: buffer 1 of a paired leaf copied back to
// buffer 0, n bytes (whole tensors, so both start 4-byte aligned), in
// 4-byte words and a byte tail.  A stopped program copies nothing, so
// buffer 0 keeps the carry as it was.
__global__ void copy_back(uint8_t* dst, const uint8_t* src, int64_t n,
                          const uint8_t* stop) {
  if (stopped(stop)) return;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * i + 4 <= n) {
    reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
  } else {
    for (int64_t b = 4 * i; b < n; ++b) dst[b] = src[b];
  }
}

static inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

static cudaError_t launch_cycle(int mask, const ProgramArgs& a, int s, int off,
                                cudaStream_t stream) {
  const int grid = blocks_for(a.n_threads);
  switch (mask) {
    case 1 << kManycore:
      granule_cycle<1 << kManycore><<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    case 1 << kSystolic:
      granule_cycle<1 << kSystolic><<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    case (1 << kManycore) | (1 << kSystolic):
      granule_cycle<(1 << kManycore) | (1 << kSystolic)>
          <<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    case 1 << kPipe:
      granule_cycle<1 << kPipe><<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    case (1 << kManycore) | (1 << kPipe):
      granule_cycle<(1 << kManycore) | (1 << kPipe)>
          <<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    case (1 << kSystolic) | (1 << kPipe):
      granule_cycle<(1 << kSystolic) | (1 << kPipe)>
          <<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    case (1 << kManycore) | (1 << kSystolic) | (1 << kPipe):
      granule_cycle<(1 << kManycore) | (1 << kSystolic) | (1 << kPipe)>
          <<<grid, kThreads, 0, stream>>>(a, s, off);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

enum Op { kCycles = 0, kExchange = 1, kIssue = 2, kCommit = 3 };

extern "C" int granule_args_size() { return (int)sizeof(ProgramArgs); }

extern "C" int granule_program(const ProgramArgs* args, const TierArgs* tiers,
                               int n_tiers, const int32_t* ops, int n_ops,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ProgramArgs a = *args;
  if (a.W != 2 || a.cap < 1 || a.n_groups < 1 || a.n_groups > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  int mask = 0, end = 0, in_end = 0;
  for (int gi = 0; gi < a.n_groups; ++gi) {
    const Group& g = a.g[gi];
    if (g.type < 0 || g.type >= kNumTypes || g.divider < 1 || g.n_slot <= 0 ||
        g.base % 32 != 0 || g.base < end || g.in_base != in_end)
      return (int)cudaErrorInvalidValue;
    mask |= 1 << g.type;
    end = g.base + g.n_slot;
    in_end += (g.type == kPipe ? 1 : 2) * g.n_slot;
  }
  if (a.n_threads != end) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  int s = 0, done = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int op = ops[2 * i], arg = ops[2 * i + 1];
    if (op == kCycles) {
      for (int c = 0; c < arg; ++c, ++done, s ^= 1) {
        if ((err = launch_cycle(mask, a, s, done, stream)) != cudaSuccess) return (int)err;
      }
      continue;
    }
    if (arg < 0 || arg >= n_tiers) return (int)cudaErrorInvalidValue;
    const TierArgs t = tiers[arg];
    const int n = t.B * t.S;
    if (n == 0) continue;
    if (op == kExchange || op == kIssue) {
      exchange_drain<<<blocks_for(n), kThreads, 0, stream>>>(a, t, s);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (op == kExchange || op == kCommit) {
      exchange_fill<<<blocks_for(n), kThreads, 0, stream>>>(a, t, s);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      exchange_credit<<<blocks_for(n), kThreads, 0, stream>>>(t, a.stop);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (s == 1) {  // an odd cycle count: the results sit in buffer 1
    struct Copy { void* dst; const void* src; size_t n; };
    Copy copies[4 + 4 * kMaxGroups];
    int n_copies = 0;
    copies[n_copies++] = {a.reg_v[0], a.reg_v[1], (size_t)a.n_reg};
    copies[n_copies++] = {a.q_head[0], a.q_head[1], (size_t)a.n_qrows * 4};
    copies[n_copies++] = {a.q_tail[0], a.q_tail[1], (size_t)a.n_qrows * 4};
    for (int gi = 0; gi < a.n_groups; ++gi) {
      const Group& g = a.g[gi];
      const size_t slots = (size_t)g.n_slot;
      if (g.type == kManycore) {
        const CoreLeaves& L = g.u.core;
        copies[n_copies++] = {L.phase[0], L.phase[1], slots * 4};
        copies[n_copies++] = {L.sent[0], L.sent[1], slots * 4};
        copies[n_copies++] = {L.rcvd[0], L.rcvd[1], slots * 4};
        copies[n_copies++] = {L.fwd_v[0], L.fwd_v[1], slots};
      } else if (g.type == kSystolic) {
        const CellLeaves& L = g.u.cell;
        copies[n_copies++] = {L.a_idx[0], L.a_idx[1], slots * 4};
      }  // PipeStage: no paired leaf (only its owner touches count)
    }
    for (int k = 0; k < n_copies; ++k) {
      const int64_t n = (int64_t)copies[k].n;
      copy_back<<<blocks_for((int)((n + 3) / 4)), kThreads, 0, stream>>>(
          static_cast<uint8_t*>(copies[k].dst),
          static_cast<const uint8_t*>(copies[k].src), n, a.stop);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (done > 0) {
    advance_cycle<<<1, 1, 0, stream>>>(a.cycle, done, a.stop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
