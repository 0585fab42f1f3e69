// granule_step.cu — the fused engine's resident epoch program for Hopper
// (sm_90a), with ManycoreCell's step as a device function.
//
// Replaces: src/repro/kernels/granule_step.py::pallas_program (the one
// pl.pallas_call at granule_step.py:306, kernel body `kernel` at :241),
// which runs FusedEngine._cycle_body and the tier exchange with the
// granule state resident in TPU VMEM.
//
// What it computes: one call of granule_program() walks an op program on
// the flat batched layout of repro_torch.core.fused (all B batch rows in
// each launch) on the caller's stream:
//   ("C", n)  n cycles, ONE launch each (granule_cycle): one thread per
//             flat block slot reads the slot's pre-cycle inputs, runs the
//             ManycoreCell step and commits everything the slot owns:
//               * each register it produces: the push is its own valid &&
//                 the register was empty before the cycle (the payload
//                 goes straight into reg_val); the pop is the consumer's
//                 readiness, recomputed here from the consumer's pre-cycle
//                 state through the consumer table `cons` (ManycoreCell:
//                 en && may_accept && the port matches its phase, which
//                 needs the consumer's phase, sent, rcvd, fwd_v and the
//                 readiness of the consumer's own active output channel);
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
// The pre-cycle snapshot, by parity: every leaf that another thread reads
// within a cycle — phase, sent, rcvd, fwd_v, reg_v and the queue heads —
// is read from buffer s = cycle parity and written to buffer s ^ 1 (every
// cycle, also where it does not change).  reg_val needs no second buffer:
// a producer writes a register only when it was empty before the cycle,
// and a consumer reads it only when it was full.  Leaves only their owner
// touches (acc, fwd, own, total, fires, the queue tails) stay in place.
// The cycle counter is read as base + offset (the offset is a launch
// argument) and advanced once at the end of the program; after an odd
// number of cycles the buffer-1 leaves are copied back, so the results
// are always in the carry's own tensors.
//
// What bounds it now: device memory.  A cycle reads ~29 B of block state a
// slot and writes ~25 B, reads the port tables (16 B) and the consumer
// table (8 B), the register flags on the slot's ports and, through the
// consumer table, its neighbours' pre-cycle state (mostly from L1/L2: the
// east neighbour is the next slot), and writes the payload of each push:
// ~80-90 B a core against ~100 integer operations.  The first design
// (two launches a cycle: a step that wrote pay/val/rr for both output
// ports to scratch, and a commit over the channels through the inverse
// maps) moved ~160 B a core and ran at 0.0744-0.0758 ms a cycle at 1M
// cores on an H100 80GB HBM3 at 700 W (42.8 us step, 27.9 us commit); this
// design drops the scratch round trip, the inverse maps and the second
// launch.
//
// Exactness: every value is an exact integer in f32 and the only float
// arithmetic is one add per accepted packet (no multiply, so no FMA
// contraction can occur).  Booleans are 1-byte uint8 (torch.bool).
#include <cuda_runtime.h>
#include <stdint.h>

// Field order must match repro_torch.kernels.granule_step._ProgramArgs.
struct ProgramArgs {
  // register file (flat: row b's registers at b*n_reg_row + c)
  float* reg_val;        // (n_reg, W)
  uint8_t* reg_v[2];     // (n_reg,), by cycle parity
  // boundary queues (flat rows b*n_q_row + k)
  float* q_buf;          // (n_qrows, cap, W)
  int32_t* q_head[2];    // (n_qrows,), by cycle parity
  int32_t* q_tail;       // (n_qrows,)
  // ManycoreCell state leaves, (n_slot,) each; `value` is never touched
  float* own;
  float* acc;
  float* total;
  int32_t* phase[2];     // by cycle parity
  int32_t* sent[2];
  int32_t* rcvd[2];
  float* fwd;
  uint8_t* fwd_v[2];
  int32_t* fires;
  // port tables in combined ids: [0, n_reg) registers, then queue rows
  const int32_t* rx_idx;  // (n_slot, 2)
  const int32_t* tx_idx;  // (n_slot, 2)
  // consumer of each output port: slot * 2 + port, -1 for none (a queue
  // row), -2 where the port drives no channel (a sentinel)
  const int32_t* cons;    // (n_slot, 2)
  int32_t* cycle;         // () cycle counter at the program's start
  int32_t n_reg;
  int32_t n_qrows;        // queue rows in the carry (1 when have_q == 0)
  int32_t n_q_row;        // queue rows per batch row
  int32_t cap;
  int32_t have_q;
  int32_t n_slot;
  int32_t R;
  int32_t C;
  int32_t divider;
  int32_t W;
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

static const int kThreads = 256;

// (x mod cap) in [0, cap): C's % keeps the dividend's sign.
__device__ __forceinline__ int ring(int x, int cap) {
  int r = x % cap;
  return r < 0 ? r + cap : r;
}

// Pre-cycle readiness of output channel c (a register or an egress row,
// whose tail moves only in the exchanges).
__device__ __forceinline__ bool chan_ready(const ProgramArgs& a, int s, int c) {
  if (c < a.n_reg) return a.reg_v[s][c] == 0;
  const int k = c - a.n_reg;
  return ring(a.q_head[s][k] - a.q_tail[k], a.cap) < a.cap - 1;
}

// ManycoreCell's readiness on in port pj of slot j this cycle, from j's
// pre-cycle state (the caller ANDs the clock enable): may_accept && the
// port is the one of j's phase.
__device__ __forceinline__ bool consumer_ready(const ProgramArgs& a, int s,
                                               int j, int pj) {
  const int phase = a.phase[s][j];
  const bool in_row = phase == 0;
  if (phase >= 2 || (pj == 0) != in_row) return false;
  const int rcvd = a.rcvd[s][j];
  const int need = in_row ? a.C - 1 : a.R - 1;
  if (rcvd >= need) return false;
  if (rcvd >= need - 1 || a.fwd_v[s][j] == 0) return true;  // !will_fwd || !fwd_v
  // the forward register is busy: j accepts only if it frees it by
  // sending a forward this cycle (can_send with fwd_v set, sent > 0)
  const int sent = a.sent[s][j];
  if (sent <= 0 || sent >= need) return false;
  return chan_ready(a, s, a.tx_idx[2 * j + (in_row ? 0 : 1)]);
}

// One cycle of every slot: ManycoreCell.step (repro_torch/hw/manycore.py)
// and the commit of every channel end the slot owns.
__global__ void __launch_bounds__(kThreads)
granule_cycle(const ProgramArgs a, const int s, const int off) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_slot) return;
  const int d = s ^ 1;
  const bool en = a.divider == 1 || ((a.cycle[0] + off) % a.divider) == 0;

  const int2 rx = reinterpret_cast<const int2*>(a.rx_idx)[i];
  const int2 tx = reinterpret_cast<const int2*>(a.tx_idx)[i];
  const int2 cn = reinterpret_cast<const int2*>(a.cons)[i];
  const int phase = a.phase[s][i], sent = a.sent[s][i], rcvd = a.rcvd[s][i];
  const bool fwd_v = a.fwd_v[s][i] != 0;

  const bool in_row = phase == 0;
  const bool live = phase < 2;
  const int need = in_row ? a.C - 1 : a.R - 1;

  // the active in port's pre-cycle front and valid (queue rows: ingress
  // or external-in, whose head this thread also carries to buffer d)
  const int c_in = in_row ? rx.x : rx.y;
  bool in_valid_raw;
  float in_val = 0.0f;
  if (c_in < a.n_reg) {
    in_valid_raw = a.reg_v[s][c_in] != 0;
    if (in_valid_raw) in_val = a.reg_val[(int64_t)c_in * a.W];
  } else {
    const int k = c_in - a.n_reg;
    const int t = a.q_tail[k];
    in_valid_raw = a.q_head[s][k] != t;
    if (in_valid_raw) in_val = a.q_buf[((int64_t)k * a.cap + t) * a.W];
  }
  const bool out_ready = chan_ready(a, s, in_row ? tx.x : tx.y);
  const bool in_valid = live && in_valid_raw;

  const bool can_send = live && sent < need && (sent == 0 || fwd_v);
  const bool did_send = can_send && out_ready;
  const bool fwd_freed = did_send && sent > 0;

  const bool will_fwd = rcvd < need - 1;
  const bool may_accept = live && rcvd < need && (!will_fwd || !fwd_v || fwd_freed);
  const bool accept = may_accept && in_valid;

  // ---- in ports: pop the active ingress row; carry every row's head
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = p == 0 ? rx.x : rx.y;
    if (c < a.n_reg) continue;
    const int k = c - a.n_reg;
    a.q_head[d][k] = a.q_head[s][k];
    if (c == c_in && en && may_accept && in_valid_raw)
      a.q_tail[k] = ring(a.q_tail[k] + 1, a.cap);
  }

  // ---- out ports: payload [out_val, sent] on the port of the phase
  const float out_val = did_send ? (sent == 0 ? a.own[i] : a.fwd[i]) : 0.0f;
  const float tag = (float)sent;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = p == 0 ? tx.x : tx.y;
    const int cons = p == 0 ? cn.x : cn.y;
    if (cons == -2) continue;
    const bool val = en && did_send && (p == 0 ? in_row : !in_row);
    if (c < a.n_reg) {
      const bool v = a.reg_v[s][c] != 0;
      const bool push = val && !v;
      const bool pop = v && en && cons >= 0 && consumer_ready(a, s, cons >> 1, cons & 1);
      if (push) {
        a.reg_val[(int64_t)c * a.W] = out_val;
        a.reg_val[(int64_t)c * a.W + 1] = tag;
      }
      a.reg_v[d][c] = ((v && !pop) || push) ? 1 : 0;
    } else {
      const int k = c - a.n_reg;
      const int h = a.q_head[s][k];
      const int h1 = ring(h + 1, a.cap);
      if (val && h1 != a.q_tail[k]) {
        const int64_t slot = ((int64_t)k * a.cap + h) * a.W;
        a.q_buf[slot] = out_val;
        a.q_buf[slot + 1] = tag;
        a.q_head[d][k] = h1;
      } else {
        a.q_head[d][k] = h;
      }
    }
  }

  // ---- the slot's own state (a divided clock holds it on this cycle)
  if (!en) {
    a.phase[d][i] = phase;
    a.sent[d][i] = sent;
    a.rcvd[d][i] = rcvd;
    a.fwd_v[d][i] = fwd_v ? 1 : 0;
    return;
  }
  const int sent2 = sent + (did_send ? 1 : 0);
  const int rcvd2 = rcvd + (accept ? 1 : 0);
  const float acc2 = __fadd_rn(a.acc[i], accept ? in_val : 0.0f);
  const bool fwd_v2 = (fwd_v && !fwd_freed) || (accept && will_fwd);
  const bool done_phase = live && sent2 == need && rcvd2 == need;

  if (done_phase) a.own[i] = acc2;
  a.acc[i] = acc2;
  if (done_phase && phase == 1) a.total[i] = acc2;
  if (accept && will_fwd) a.fwd[i] = in_val;
  if (did_send || accept) a.fires[i] += (did_send ? 1 : 0) + (accept ? 1 : 0);
  a.phase[d][i] = phase + (done_phase ? 1 : 0);
  a.sent[d][i] = done_phase ? 0 : sent2;
  a.rcvd[d][i] = done_phase ? 0 : rcvd2;
  a.fwd_v[d][i] = fwd_v2 ? 1 : 0;
}

// Issue half: credit-bounded drain of every egress row into the slab.
// Rows whose count is 0 (padding, or no credit) are not written at all.
__global__ void exchange_drain(ProgramArgs a, TierArgs t, const int s) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S) return;
  const int b = j / t.S;
  const int limit = t.send_mask[j] ? t.credits[j] : 0;
  const int row = b * a.n_q_row + t.send_idx[j];
  const int tl = a.q_tail[row];
  int n = ring(a.q_head[s][row] - tl, a.cap);
  n = n < t.E ? n : t.E;
  n = n < limit ? n : limit;
  for (int e = 0; e < n; ++e) {
    const int64_t src = (int64_t)row * a.cap + ring(tl + e, a.cap);
    const int64_t dst = (int64_t)j * t.E + e;
    for (int w = 0; w < a.W; ++w) t.slab[dst * a.W + w] = a.q_buf[src * a.W + w];
  }
  t.cnt[j] = n;
  if (n > 0) a.q_tail[row] = ring(tl + n, a.cap);
}

// Commit half, part 1: gather the slab from its source batch row
// (bat_fwd), fill the ingress row up to its free space, and record the
// receiver's new free space as the credit to return.
__global__ void exchange_fill(ProgramArgs a, TierArgs t, const int s) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S) return;
  const int b = j / t.S, sl = j % t.S;
  const bool live = t.recv_mask[j] != 0;
  const int sj = t.bat_fwd[j] * t.S + sl;
  const int row = b * a.n_q_row + t.recv_idx[j];
  const int h = a.q_head[s][row];
  const int fr = (a.cap - 1) - ring(h - a.q_tail[row], a.cap);
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
__global__ void exchange_credit(TierArgs t) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S) return;
  t.credits[j] = t.cred[t.bat_rev[j] * t.S + j % t.S];
}

// The program's cycles, added once at its end.
__global__ void advance_cycle(int32_t* cycle, int n) { cycle[0] += n; }

static inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

enum Op { kCycles = 0, kExchange = 1, kIssue = 2, kCommit = 3 };

extern "C" int granule_program(const ProgramArgs* args, const TierArgs* tiers,
                               int n_tiers, const int32_t* ops, int n_ops,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ProgramArgs a = *args;
  if (a.W != 2 || a.n_slot <= 0 || a.divider < 1 || a.cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  int s = 0, done = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int op = ops[2 * i], arg = ops[2 * i + 1];
    if (op == kCycles) {
      for (int c = 0; c < arg; ++c, ++done, s ^= 1) {
        granule_cycle<<<blocks_for(a.n_slot), kThreads, 0, stream>>>(a, s, done);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
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
      exchange_credit<<<blocks_for(n), kThreads, 0, stream>>>(t);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (s == 1) {  // an odd cycle count: the results sit in buffer 1
    const size_t slots = (size_t)a.n_slot;
    struct { void* dst; const void* src; size_t n; } copies[] = {
        {a.phase[0], a.phase[1], slots * 4}, {a.sent[0], a.sent[1], slots * 4},
        {a.rcvd[0], a.rcvd[1], slots * 4},   {a.fwd_v[0], a.fwd_v[1], slots},
        {a.reg_v[0], a.reg_v[1], (size_t)a.n_reg},
        {a.q_head[0], a.q_head[1], (size_t)a.n_qrows * 4},
    };
    for (const auto& cp : copies) {
      err = cudaMemcpyAsync(cp.dst, cp.src, cp.n, cudaMemcpyDeviceToDevice, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (done > 0) {
    advance_cycle<<<1, 1, 0, stream>>>(a.cycle, done);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
