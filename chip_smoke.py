#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

The main path is the paper's flagship: the 1024x1024 wafer-scale torus of
``ManycoreCell`` cores running a two-phase ring allreduce, partitioned over
2 pods x 2x2 granules with all 8 granules batched on one card, through
``Network``/``ChannelGraph`` -> ``Simulation`` -> ``FusedEngine``, whose
epoch is one call of the hand-written ``granule_step`` kernel
(``src/repro_torch/kernels/csrc/granule_step.cu``).

Phases (a failing phase raises, and the script exits non-zero):

  1. build   compile the kernel from the checkout's sources (nvcc, sm_90a).
  2. small   a 32x32 torus, 8 granules, tiers (2, 4), capacity 4: the
             kernel against the plain PyTorch version on a CPU copy, every
             state leaf bit-exact after each of 10 epochs, overlap off and on.
  3. full    the full-width wafer (1,048,576 cores, k_inner 16, k_outer 4,
             capacity 62): one epoch bit-exact against the plain version on
             a CPU copy; the kernel's and the plain version's times per
             simulated cycle on the card (medians over whole epochs) beside
             the memory bound counted from the run's tensors and data; then
             ``Simulation.run(until=allreduce_done)`` through the kernel,
             with the launch count set to 0 just before and read just
             after, and every core's total checked against the global sum
             4,718,592; then the same run again under ``torch.profiler``,
             whose trace gives the device's idle share and each kernel's
             time per cycle.

The output ends with a JSON line describing each kernel, the card's name and
power limit from nvidia-smi, and the one-line result JSON.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,small
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
TOTAL = 4_718_592.0  # sum over the wafer of (arange(R*C) % 8) + 1


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def to_cpu(tree):
    from repro_torch.core.struct import tree_map
    import torch

    return tree_map(
        lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree
    )


def compare(a, b) -> float:
    """Max |a - b| over every state leaf (tables excluded); raises unless
    every leaf is bit-exact."""
    import numpy as np
    from repro_torch.convert import fused_state_to_numpy

    na, nb = fused_state_to_numpy(a), fused_state_to_numpy(b)
    if sorted(na) != sorted(nb):
        raise AssertionError(f"leaf sets differ: {sorted(na)} vs {sorted(nb)}")
    worst = 0.0
    bad = []
    for k in na:
        if na[k].shape != nb[k].shape or not np.array_equal(na[k], nb[k]):
            bad.append(k)
        if na[k].size:
            d = np.abs(na[k].astype(np.float64) - nb[k].astype(np.float64))
            worst = max(worst, float(d.max()))
    if bad:
        raise AssertionError(f"kernel and plain version differ in {bad}")
    return worst


def wafer_engine(R, C, k_outer, k_inner, capacity, overlap, device):
    import numpy as np
    from repro_torch.core import ChannelGraph, tiered_grid_partition
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.manycore import ManycoreCell, make_core_params

    values = ((np.arange(R * C, dtype=np.int64) % 8) + 1).astype(np.float32)
    graph = ChannelGraph.torus(
        ManycoreCell(R, C), R, C, params=make_core_params(values.reshape(R, C)),
        capacity=capacity,
    )
    eng = FusedEngine(
        graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]), None,
        tiers=[(("pod",), k_outer), (("g",), k_inner)],
        batch_axes={"pod": 2, "g": 4}, overlap=overlap, device=device,
    )
    return eng, values


def phase_small() -> None:
    import torch

    for overlap in (False, True):
        eng, _ = wafer_engine(32, 32, 2, 4, 4, overlap, "cuda")
        gpu = eng.init(0)
        cpu = to_cpu(gpu)
        for ep in range(10):
            gpu = eng.run_epochs(gpu, 1)
            cpu = eng.run_epochs(cpu, 1)
            torch.cuda.synchronize()
            compare(gpu, cpu)
        cyc = int(gpu.cycle.reshape(-1)[0])
        log(f"[small] 32x32 tiers (2, 4) cap 4 overlap={overlap}: 10 epochs "
            f"({cyc} cycles) bit-exact against the plain version")


# CoreState leaves ManycoreCell.step reads, and writes, every cycle: it
# never touches ``value``, and writes ``own`` and ``total`` only at the two
# phase ends (12 B a core in a whole run).
STEP_READS = ("phase", "sent", "rcvd", "own", "acc", "fwd", "fwd_v", "fires")
STEP_WRITES = ("phase", "sent", "rcvd", "acc", "fwd", "fwd_v", "fires")


def sends_x2(local) -> int:
    """Sum of ``fires`` plus the packets held in registers and boundary
    queues.  A core's ``fires`` counts its sends and accepts, and packets in
    flight change by sends less accepts, so between two epoch boundaries
    (when no exchange slab holds a packet) this grows by twice the packets
    sent."""
    import torch
    from repro_torch.core import queue as qmod

    q = local.queues
    held = int(local.reg_v.sum())
    if q.buf.shape[0] > 1:
        held += int(qmod.size(q).sum())
    return int(local.block_states[0].fires.sum(dtype=torch.int64)) + held


def cycle_bytes(local, consts, program, pushes: float) -> dict:
    """The least bytes one simulated cycle must move, each input read once
    and each output written once, counted from this run's tensors and data:

      * block state: the leaves of ``STEP_READS`` read, of ``STEP_WRITES``
        written;
      * registers: the valid flag and payload word 0 read, the flag written;
      * boundary queue rows: head, tail and the front's word 0 read, head
        and tail written;
      * the payload of each packet pushed (``pushes`` per cycle, counted in
        the timed window);
      * the port and inverse tables, read;
      * per epoch, amortized over its cycles: each exchange reads its tables
        and reads and writes its credits.  The packets an exchange moves
        between boundary rows are left out (``xchg_payload_max`` is the most
        they could add).

    The per-cycle scratch that carries ``pay``/``val``/``rr`` from the step
    launch to the commit launch is the kernel's, not the function's, and is
    not counted."""
    def nb(x):
        return x.numel() * x.element_size()

    st = local.block_states[0]
    block = (sum(nb(getattr(st, f)) for f in STEP_READS)
             + sum(nb(getattr(st, f)) for f in STEP_WRITES))
    n_reg, W = local.reg_val.shape
    word = local.reg_val.element_size()
    regs = n_reg * (2 * local.reg_v.element_size() + word)
    q = local.queues
    rows = q.head.numel() if q.buf.shape[0] > 1 else 0
    queues = rows * (2 * (q.head.element_size() + q.tail.element_size()) + word)
    packets = pushes * W * word
    tables = (sum(nb(x) for x in consts.rx_idx) + sum(nb(x) for x in consts.tx_idx)
              + nb(consts.inv_tx) + nb(consts.inv_tx_mask) + nb(consts.inv_rx)
              + nb(consts.inv_rx_mask))
    n_cycles = sum(a for op, a in program if op == "C")
    xchg = xchg_payload = 0
    for op, t in program:
        if op in ("X", "XC"):
            xchg += sum(nb(x[t]) for x in (consts.send_idx, consts.send_mask,
                                           consts.recv_idx, consts.recv_mask,
                                           consts.bat_fwd, consts.bat_rev))
            xchg += 2 * nb(local.credits[t])
            xchg_payload += 2 * consts.send_idx[t].numel() * consts.depths[t] * W * word
    per_cycle = block + regs + queues + packets + tables + xchg / n_cycles
    return {"block": block, "regs": regs, "queues": queues, "packets": packets,
            "tables": tables, "per_cycle": per_cycle, "n_cycles": n_cycles,
            "xchg_payload_max": xchg_payload / n_cycles}


def time_reps(fn, reps: int) -> list:
    """ms of each of ``reps`` calls of ``fn()``, by CUDA events around each
    call (the caller warms up first)."""
    import torch

    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


KERNEL_NAMES = ("manycore_step", "fused_commit", "exchange_drain",
                "exchange_fill", "exchange_credit")


def traced_run(run) -> dict:
    """Call ``run()`` under ``torch.profiler`` (device activity only) and
    read its trace: host wall seconds of the call, device busy seconds (the
    union of every device event's interval) and device seconds per kernel
    of ``KERNEL_NAMES``.  ``busy`` is None when the trace holds no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    per_kernel = dict.fromkeys(KERNEL_NAMES, 0.0)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi, name in spans:
        kernel = next((k for k in KERNEL_NAMES if k in name), None)
        if kernel:
            per_kernel[kernel] += (hi - lo) * 1e-6
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    return {"wall": wall, "busy": busy_us * 1e-6 if spans else None,
            "per_kernel": per_kernel, "events": len(spans)}


def phase_full(result: dict) -> None:
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import Simulation
    from repro_torch.core.struct import tree_map
    from repro_torch.hw.manycore import allreduce_done
    from repro_torch.kernels import granule_step

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    t0 = time.perf_counter()
    eng, values = wafer_engine(R, C, CONFIG.k_outer, CONFIG.k_inner,
                               CONFIG.queue_capacity, False, "cuda")
    sim = Simulation(eng).reset(0)
    sim.block_until_ready()
    setup_s = time.perf_counter() - t0
    log(f"[full] {R}x{C} torus = {R * C} cores, {eng.G} granules batched, "
        f"tiers K={eng.K_tiers}, capacity {eng.capacity}, program "
        f"{eng._resident_program(0)}; set-up {setup_s:.2f} s")

    # one epoch: the kernel against the plain version on a CPU copy
    clone = lambda s: tree_map(  # noqa: E731
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, s)
    start = clone(sim.state)
    t1 = time.perf_counter()
    plain = eng.run_epochs(to_cpu(start), 1)
    plain_cpu_s = time.perf_counter() - t1
    kern = eng.run_epochs(clone(start), 1)
    torch.cuda.synchronize()
    err = compare(kern, plain)
    log(f"[full] one epoch bit-exact against the plain version on a CPU copy "
        f"(max |diff| {err}; the CPU copy took {plain_cpu_s:.2f} s)")

    # times per simulated cycle on the card: kernel vs plain PyTorch, the
    # median of each over whole epochs from the start of the run
    local = eng._local_view(clone(start))
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    program = eng._resident_program(0)
    consts = eng._consts(local.tables)
    n_cyc = sum(a for op, a in program if op == "C")
    n_before = granule_step.launches
    kernel = lambda: granule_step.epoch_program_cuda(carry, program, consts)  # noqa: E731
    kernel()  # warm-up
    torch.cuda.synchronize()
    reps = 10
    x2_before = sends_x2(local)
    k_times = [t / n_cyc for t in time_reps(kernel, reps)]
    pushes = (sends_x2(local) - x2_before) / 2 / (reps * n_cyc)
    granule_step.launches = n_before  # timing launches are not the main path
    ref_carry = carry

    def run_ref():
        nonlocal ref_carry
        ref_carry = granule_step.epoch_program_ref(
            eng._resident_cycle, ref_carry, program,
            exchange_fn=eng._resident_exchange,
            issue_fn=eng._resident_exchange_issue,
            commit_fn=eng._resident_exchange_commit, consts=consts)

    run_ref()  # warm-up
    p_times = [t / n_cyc for t in time_reps(run_ref, 7)]
    kern_ms, plain_ms = statistics.median(k_times), statistics.median(p_times)
    nbytes = cycle_bytes(local, consts, program, pushes)
    bound_ms = nbytes["per_cycle"] / HBM_BYTES_PER_S * 1e3
    per_core = {k: nbytes[k] / (R * C) for k in
                ("per_cycle", "block", "regs", "queues", "packets", "tables")}
    log(f"[full] per simulated cycle at {R * C} cores (median over {reps} "
        f"kernel and {len(p_times)} plain epochs): kernel {kern_ms:.5f} ms "
        f"({min(k_times):.5f}-{max(k_times):.5f}), plain PyTorch on the card "
        f"{plain_ms:.4f} ms ({min(p_times):.4f}-{max(p_times):.4f}), "
        f"{plain_ms / kern_ms:.1f}x the kernel; memory bound {bound_ms:.5f} ms, "
        f"kernel at {kern_ms / bound_ms:.2f}x it")
    log("[full] bound per core and cycle: " + ", ".join(
        f"{k} {v:.2f} B" for k, v in per_core.items())
        + f" ({pushes / (R * C):.4f} packets pushed a core and cycle); "
        f"exchange payloads left out, at most "
        f"{nbytes['xchg_payload_max'] / nbytes['per_cycle']:.2%} of the bound")
    del carry, ref_carry, local, start, plain, kern

    # the main path: Simulation.run(until=allreduce_done) through the kernel
    sim.reset(0)
    sim.block_until_ready()
    torch.cuda.reset_peak_memory_stats()
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    granule_step.launches = 0
    t2 = time.perf_counter()
    sim.run(until=done, max_epochs=1000)
    sim.block_until_ready()
    run_s = time.perf_counter() - t2
    launches = granule_step.launches
    if launches <= 0:
        raise AssertionError("the main path launched the granule_step kernel 0 times")
    totals = eng.gather_group(sim.state, 0).total
    phases = eng.gather_group(sim.state, 0).phase
    if not (phases == 2).all():
        raise AssertionError(f"{int((phases != 2).sum())} cores did not finish")
    if not np.array_equal(totals, np.full_like(totals, TOTAL)):
        raise AssertionError(f"allreduce totals {np.unique(totals)[:5]} != {TOTAL}")
    if float(values.astype(np.float64).sum()) != TOTAL:
        raise AssertionError("wafer values do not sum to the expected total")
    cycles = sim.cycle
    log(f"[full] converged: every one of {R * C} cores holds total {TOTAL:.0f} "
        f"after {cycles} cycles ({sim.epoch} epochs); run {run_s:.3f} s wall, "
        f"set-up {setup_s:.2f} s; {R * C * cycles / run_s:.4e} core-cycles/s; "
        f"granule_step launches {launches}; device memory in use "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the same until-run again under the profiler: the device's idle share
    # and each kernel's device time per simulated cycle, from its trace
    sim.reset(0)
    sim.block_until_ready()
    trace = traced_run(lambda: sim.run(until=done, max_epochs=1000))
    granule_step.launches = launches
    if sim.cycle != cycles:
        raise AssertionError(f"the traced run stopped at cycle {sim.cycle}, "
                             f"the main run at {cycles}")
    if trace["busy"] is None:
        log("[trace] device idle share: not measured (the trace holds no "
            "device event)")
    else:
        kernels = "; ".join(f"{k} {v / cycles * 1e6:.2f} us"
                            for k, v in trace["per_kernel"].items())
        log(f"[trace] traced repeat of the until-run: {trace['wall']:.3f} s "
            f"wall, device busy {trace['busy']:.3f} s over {trace['events']} "
            f"device events, idle share {1.0 - trace['busy'] / trace['wall']:.4f}; "
            f"per simulated cycle: {kernels}")
    result.update(
        name="granule_step", route="cuda",
        source="src/repro_torch/kernels/csrc/granule_step.cu",
        replaces="src/repro/kernels/granule_step.py:306",
        launches=launches, max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes", library_ms=None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,small,full",
                    help="comma-separated subset of build,small,full")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's package is missing ({SRC}/repro_torch); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build("granule_step")
    log(f"[build] granule_step built in {secs:.2f} s "
        f"({time.perf_counter() - t0:.2f} s wall)")
    for line in _build.PTXAS_REPORT.get("granule_step", "").splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            log(f"[build] {line.strip()}")
    if "small" in phases:
        phase_small()
    kernel = {}
    if "full" in phases:
        phase_full(kernel)
    print(json.dumps({"kernels": [kernel] if kernel else []}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
