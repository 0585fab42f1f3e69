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
//   ("C", n)  n cycles; each cycle is two launches —
//             step:   one thread per flat block slot: pre-cycle fronts,
//                     valids and readies through rx_idx/tx_idx, the
//                     ManycoreCell step, the new block state in place, and
//                     pay/val/rr to scratch;
//             commit: one thread per combined channel id: the depth-1
//                     register commit and the ring handshake of the
//                     boundary queues through inv_tx/inv_rx; thread 0
//                     advances the shared cycle counter.
//             The launch boundary is the barrier between the pre-cycle
//             snapshot and the commit.
//   ("X", t)  tier t's exchange: drain, move-and-fill, credit return —
//             three launches over (batch row, slot).
//   ("XI", t) / ("XC", t)  the issue (drain) and commit (move-and-fill,
//             credit return) halves of the same exchange.
// Ops run in program order, so the result is bit-identical to the plain
// PyTorch version (repro_torch.kernels.granule_step.epoch_program_ref).
//
// What bounds it: device memory.  At 1M cores a cycle must read 29 B and
// write 25 B of block state a core (value is never touched; own and total
// change only at the two phase ends), read each register's valid flag and
// payload word 0 and write its flag (~12 B a core), write the payload of
// each packet pushed (~4 B a core), and read the port and inverse tables
// (~36 B a core): ~110 MB per cycle, far over the 50 MB L2, against ~100
// integer and select operations a core.  The
// TPU kernel kept the whole granule in VMEM; one Hopper SM has 227 KB of
// shared memory and a 256x512 granule's state is several MB, so this
// design streams the state through device memory every cycle with
// coalesced per-slot and per-channel accesses and no atomics.  Keeping
// state on chip across cycles (a persistent kernel over tiles with halo
// exchange) is later work.
//
// Exactness: every value is an exact integer in f32 and the only float
// arithmetic is one add per accepted packet (no multiply, so no FMA
// contraction can occur).  Booleans are 1-byte uint8 (torch.bool).
#include <cuda_runtime.h>
#include <stdint.h>

struct ProgramArgs {
  // register file (flat: row b's registers at b*n_reg_row + c)
  float* reg_val;        // (n_reg, W)
  uint8_t* reg_v;        // (n_reg,)
  // boundary queues (flat rows b*n_q_row + k)
  float* q_buf;          // (n_qrows, cap, W)
  int32_t* q_head;       // (n_qrows,)
  int32_t* q_tail;       // (n_qrows,)
  // ManycoreCell state leaves, (n_slot,) each, CoreState field order
  float* value;
  float* own;
  float* acc;
  float* total;
  int32_t* phase;
  int32_t* sent;
  int32_t* rcvd;
  float* fwd;
  uint8_t* fwd_v;
  int32_t* fires;
  // port tables in combined ids: [0, n_reg) registers, then queue rows
  const int32_t* rx_idx;       // (n_slot, 2)
  const int32_t* tx_idx;       // (n_slot, 2)
  const int32_t* inv_tx;       // (n_reg + n_qrows_all,)
  const uint8_t* inv_tx_mask;
  const int32_t* inv_rx;
  const uint8_t* inv_rx_mask;
  // per-cycle scratch
  float* pay;            // (n_slot * 2, W) producer payloads
  uint8_t* val;          // (n_slot * 2,) producer valids
  uint8_t* rr;           // (n_slot * 2,) consumer readies
  int32_t* cycle;        // () shared cycle counter (rows run in lockstep)
  int32_t n_reg;
  int32_t n_qrows;       // queue rows in the carry (1 when have_q == 0)
  int32_t n_q_row;       // queue rows per batch row
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

__device__ __forceinline__ int qsize(const ProgramArgs& a, int k) {
  return ring(a.q_head[k] - a.q_tail[k], a.cap);
}

// Pre-cycle view of combined channel c: front word 0 and valid.
__device__ __forceinline__ void chan_front(const ProgramArgs& a, int c,
                                           float* word0, bool* valid) {
  if (c < a.n_reg) {
    *word0 = a.reg_val[(int64_t)c * a.W];
    *valid = a.reg_v[c] != 0;
  } else {
    int k = c - a.n_reg;
    int64_t slot = (int64_t)k * a.cap + a.q_tail[k];
    *word0 = a.q_buf[slot * a.W];
    *valid = a.q_head[k] != a.q_tail[k];
  }
}

__device__ __forceinline__ bool chan_ready(const ProgramArgs& a, int c) {
  if (c < a.n_reg) return a.reg_v[c] == 0;
  return qsize(a, c - a.n_reg) < a.cap - 1;
}

// ManycoreCell.step (repro_torch/hw/manycore.py) for slot i.
__global__ void manycore_step(ProgramArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_slot) return;
  const bool en = (a.cycle[0] % a.divider) == 0;

  float w0, n0;
  bool wv, nv;
  chan_front(a, a.rx_idx[2 * i], &w0, &wv);
  chan_front(a, a.rx_idx[2 * i + 1], &n0, &nv);
  const bool e_rdy = chan_ready(a, a.tx_idx[2 * i]);
  const bool s_rdy = chan_ready(a, a.tx_idx[2 * i + 1]);

  const int phase = a.phase[i], sent = a.sent[i], rcvd = a.rcvd[i];
  const float own = a.own[i], acc = a.acc[i], fwd = a.fwd[i];
  const bool fwd_v = a.fwd_v[i] != 0;

  const bool in_row = phase == 0;
  const bool live = phase < 2;
  const int need = in_row ? a.C - 1 : a.R - 1;
  const float in_val = in_row ? w0 : n0;
  const bool in_valid = live && (in_row ? wv : nv);
  const bool out_ready = in_row ? e_rdy : s_rdy;

  const float out_val = sent == 0 ? own : fwd;
  const bool can_send = live && sent < need && (sent == 0 || fwd_v);
  const bool did_send = can_send && out_ready;
  const bool fwd_freed = did_send && sent > 0;

  const bool will_fwd = rcvd < need - 1;
  const bool may_accept = live && rcvd < need && (!will_fwd || !fwd_v || fwd_freed);
  const bool accept = may_accept && in_valid;

  const int sent2 = sent + (did_send ? 1 : 0);
  const int rcvd2 = rcvd + (accept ? 1 : 0);
  const float acc2 = __fadd_rn(acc, accept ? in_val : 0.0f);
  const bool fwd_v2 = (fwd_v && !fwd_freed) || (accept && will_fwd);
  const float fwd2 = (accept && will_fwd) ? in_val : fwd;

  const bool done_phase = live && sent2 == need && rcvd2 == need;
  const bool finishing = done_phase && phase == 1;

  // outputs: ports e_out (0) and s_out (1), payload [out_val, sent]
  const int64_t p0 = 2 * (int64_t)i;
  const float tag = (float)sent;
  a.pay[p0 * a.W] = out_val;
  a.pay[p0 * a.W + 1] = tag;
  a.pay[(p0 + 1) * a.W] = out_val;
  a.pay[(p0 + 1) * a.W + 1] = tag;
  a.val[p0] = (en && did_send && in_row) ? 1 : 0;
  a.val[p0 + 1] = (en && did_send && !in_row) ? 1 : 0;
  a.rr[p0] = (en && may_accept && in_row) ? 1 : 0;
  a.rr[p0 + 1] = (en && may_accept && !in_row) ? 1 : 0;

  if (!en) return;  // a divided clock holds its state on this cycle
  if (done_phase) a.own[i] = acc2;
  a.acc[i] = acc2;
  if (finishing) a.total[i] = acc2;
  a.phase[i] = phase + (done_phase ? 1 : 0);
  a.sent[i] = done_phase ? 0 : sent2;
  a.rcvd[i] = done_phase ? 0 : rcvd2;
  a.fwd[i] = fwd2;
  a.fwd_v[i] = fwd_v2 ? 1 : 0;
  a.fires[i] += (did_send ? 1 : 0) + (accept ? 1 : 0);
}

// Register commit and queue ring handshake for combined channel c.
__global__ void fused_commit(ProgramArgs a, int n_tot) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c == 0) a.cycle[0] += 1;
  if (c >= n_tot) return;
  const int tx = a.inv_tx[c], rx = a.inv_rx[c];
  const bool push_v = a.inv_tx_mask[c] && a.val[tx];
  const bool pop_r = a.inv_rx_mask[c] && a.rr[rx];
  if (c < a.n_reg) {
    // depth-1 register: accepts only when empty before the cycle, so a
    // packet never enters and leaves one register in the same cycle
    const bool v = a.reg_v[c] != 0;
    const bool push = push_v && !v;
    const bool pop = pop_r && v;
    if (push) {
      for (int w = 0; w < a.W; ++w)
        a.reg_val[(int64_t)c * a.W + w] = a.pay[(int64_t)tx * a.W + w];
    }
    a.reg_v[c] = ((v && !pop) || push) ? 1 : 0;
  } else {
    const int k = c - a.n_reg;
    const int h = a.q_head[k], t = a.q_tail[k];
    const bool full = ring(h + 1, a.cap) == t;
    const bool empty = h == t;
    if (push_v && !full) {
      const int64_t slot = (int64_t)k * a.cap + h;
      for (int w = 0; w < a.W; ++w)
        a.q_buf[slot * a.W + w] = a.pay[(int64_t)tx * a.W + w];
      a.q_head[k] = ring(h + 1, a.cap);
    }
    if (pop_r && !empty) a.q_tail[k] = ring(t + 1, a.cap);
  }
}

// Issue half: credit-bounded drain of every egress row into the slab.
// Rows whose count is 0 (padding, or no credit) are not written at all.
__global__ void exchange_drain(ProgramArgs a, TierArgs t) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S) return;
  const int b = j / t.S;
  const int limit = t.send_mask[j] ? t.credits[j] : 0;
  const int row = b * a.n_q_row + t.send_idx[j];
  const int tl = a.q_tail[row];
  int n = qsize(a, row);
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
__global__ void exchange_fill(ProgramArgs a, TierArgs t) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S) return;
  const int b = j / t.S, s = j % t.S;
  const bool live = t.recv_mask[j] != 0;
  const int sj = t.bat_fwd[j] * t.S + s;
  const int row = b * a.n_q_row + t.recv_idx[j];
  const int h = a.q_head[row];
  const int fr = (a.cap - 1) - qsize(a, row);
  int n = live ? t.cnt[sj] : 0;
  n = n < fr ? n : fr;
  for (int e = 0; e < n; ++e) {
    const int64_t dst = (int64_t)row * a.cap + ring(h + e, a.cap);
    const int64_t src = (int64_t)sj * t.E + e;
    for (int w = 0; w < a.W; ++w) a.q_buf[dst * a.W + w] = t.slab[src * a.W + w];
  }
  if (n > 0) a.q_head[row] = ring(h + n, a.cap);
  t.cred[j] = live ? fr - n : 0;
}

// Commit half, part 2: credits return to the senders on bat_rev.
__global__ void exchange_credit(TierArgs t) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.B * t.S) return;
  t.credits[j] = t.cred[t.bat_rev[j] * t.S + j % t.S];
}

static inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

enum Op { kCycles = 0, kExchange = 1, kIssue = 2, kCommit = 3 };

extern "C" int granule_program(const ProgramArgs* args, const TierArgs* tiers,
                               int n_tiers, const int32_t* ops, int n_ops,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ProgramArgs a = *args;
  const int n_tot = a.n_reg + (a.have_q ? a.n_qrows : 0);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < n_ops; ++i) {
    const int op = ops[2 * i], arg = ops[2 * i + 1];
    if (op == kCycles) {
      for (int c = 0; c < arg; ++c) {
        manycore_step<<<blocks_for(a.n_slot), kThreads, 0, stream>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        fused_commit<<<blocks_for(n_tot), kThreads, 0, stream>>>(a, n_tot);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      continue;
    }
    if (arg < 0 || arg >= n_tiers) return (int)cudaErrorInvalidValue;
    const TierArgs t = tiers[arg];
    const int n = t.B * t.S;
    if (n == 0) continue;
    if (op == kExchange || op == kIssue) {
      exchange_drain<<<blocks_for(n), kThreads, 0, stream>>>(a, t);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (op == kExchange || op == kCommit) {
      exchange_fill<<<blocks_for(n), kThreads, 0, stream>>>(a, t);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      exchange_credit<<<blocks_for(n), kThreads, 0, stream>>>(t);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
