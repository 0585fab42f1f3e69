"""Time the fused engine's epoch program kernel (``granule_step``, CUDA)
per simulated cycle on the two million-core cells that ``chip_smoke.py``
runs it on: the 1024x1024 wafer torus (``configs/manycore.py``) from its
initial state, and ``FusedEngine.grid(SystolicCell(1024), 1024, 1024,
K=62)`` from its mid-run state.  Each cell is timed for its resident
program (an even cycle count) and for the same program one cycle
shorter (an odd count, whose end copies the parity buffers back), each
called without the until-loop's stop flag and, where the package takes
one, with the flag clear.  CUDA events time each call of ``rounds``
rounds; a round runs every case in turn, each as ``seq`` programs back
to back from the same start state, so every version and case times the
same sequence of states.

Run it with the package under test on ``PYTHONPATH``, on a CUDA machine:

    PYTHONPATH=src python scripts/torch_program_times.py [--rounds 5] [--seq 10]

To compare two versions of the package on one card, run it on one
machine with each tree's ``src`` in turn (A, B, B, A).  Prints the card
(``nvidia-smi``), then one JSON object a case:
``{"cell", "case", "cycles", "ms_per_cycle": [median, min, max]}``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _wafer():
    import numpy as np
    from repro_torch.configs.manycore import CONFIG
    from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.manycore import ManycoreCell, make_core_params

    R, C = CONFIG.grid_rows, CONFIG.grid_cols
    values = ((np.arange(R * C, dtype=np.int64) % 8) + 1).astype(np.float32)
    graph = ChannelGraph.torus(
        ManycoreCell(R, C), R, C, params=make_core_params(values.reshape(R, C)),
        capacity=CONFIG.queue_capacity)
    eng = FusedEngine(
        graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]), None,
        tiers=[(("pod",), CONFIG.k_outer), (("g",), CONFIG.k_inner)],
        batch_axes={"pod": 2, "g": 4}, device="cuda")
    return eng, Simulation(eng).reset(0)


def _fsys():
    import numpy as np
    from repro_torch.core import Simulation
    from repro_torch.core.fused import FusedEngine
    from repro_torch.hw.systolic import SystolicCell, make_cell_params

    M = R = C = 1024
    K = 62
    rng = np.random.RandomState(0)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    eng = FusedEngine.grid(SystolicCell(m_stream=M), R, C, K=K,
                           params=make_cell_params(A, B), device="cuda")
    sim = Simulation(eng).reset(0)
    sim.run(epochs=(2 * M + R + C) // (2 * K))
    return eng, sim


def _odd(program):
    """``program`` with its last cycle op one cycle shorter."""
    i = max(j for j, (op, _) in enumerate(program) if op == "C")
    return tuple(program[:i]) + (("C", program[i][1] - 1),) + tuple(program[i + 1:])


def time_cell(name: str, build, rounds: int, seq: int) -> list:
    import torch
    from repro_torch.core.struct import tree_leaves
    from repro_torch.kernels import granule_step

    eng, sim = build()
    local = eng._local_view(sim.state)
    carry = (local.reg_val, local.reg_v, local.queues, local.block_states,
             local.cycle, local.credits)
    consts = eng._consts(local.tables)
    saved = [x.clone() for x in tree_leaves(carry) if isinstance(x, torch.Tensor)]

    def restore():
        live = [x for x in tree_leaves(carry) if isinstance(x, torch.Tensor)]
        for d, s in zip(live, saved):
            d.copy_(s)

    program = tuple(eng._resident_program(0))
    takes_stop = "stop" in inspect.signature(granule_step.epoch_program_cuda).parameters
    clear = torch.zeros((), dtype=torch.bool, device="cuda")
    cases = []
    for label, prog in (("even", program), ("odd", _odd(program))):
        cases.append((f"{label} no flag", prog, ()))
        if takes_stop:
            cases.append((f"{label} flag clear", prog, (clear,)))
    times = {c[0]: [] for c in cases}
    for _, prog, extra in cases:  # warm-up: build, load, first launch
        restore()
        granule_step.epoch_program_cuda(carry, prog, consts, *extra)
    for _ in range(rounds):
        for label, prog, extra in cases:
            restore()
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(seq)]
            torch.cuda.synchronize()
            for start, stop in events:
                start.record()
                granule_step.epoch_program_cuda(carry, prog, consts, *extra)
                stop.record()
            torch.cuda.synchronize()
            n = sum(a for op, a in prog if op == "C")
            times[label] += [a.elapsed_time(b) / n for a, b in events]
    out = []
    for label, prog, _ in cases:
        t = times[label]
        out.append({"cell": name, "case": label,
                    "cycles": sum(a for op, a in prog if op == "C"),
                    "ms_per_cycle": [statistics.median(t), min(t), max(t)]})
    del eng, sim, local, carry, saved
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seq", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(_card(), flush=True)
    for name, build in (("wafer-1M", _wafer), ("fsys-1M", _fsys)):
        for row in time_cell(name, build, args.rounds, args.seq):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
