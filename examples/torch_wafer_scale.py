"""Wafer-scale many-core simulation across tiered granules on the PyTorch
port (paper §IV-B).

The paper's flagship demo spreads a million RISC-V cores over thousands of
cloud cores with a *tiered* transport: fast shm queues inside a host, slow
TCP bridges between hosts, both tolerated by latency-insensitive channels.
This example is that scenario on one card:

  * a torus of message-passing mini-cores (``repro_torch.hw.manycore``),
    described by ``ChannelGraph.torus`` in vectorized numpy;
  * hierarchically partitioned over a ``pod`` tier and an intra-pod 2x2
    granule tier by ``tiered_grid_partition``, all 8 granules batched on
    one device (``batch_axes={"pod": 2, "gr": 2, "gc": 2}``);
  * per-tier sync rates: intra-pod boundaries exchange every K_inner
    cycles, pod boundaries every K_inner * K_outer;
  * end-to-end check: the fabric runs a two-phase ring allreduce in the
    data plane, so the run is correct iff **every core's total equals the
    global sum**.

``--engine graph`` (the default) runs the queue interpreter
(``GraphEngine``: every channel a ring of ``capacity`` slots, plain
PyTorch ops), ``--engine fused`` the fused engine, whose epoch is one call
of the hand-written ``granule_step`` kernel on the card; ``run(until=...)``
runs in the device loop on the card.  ``--engine procs`` runs the paper's
own deployment: 2 pods x 2 row strips, one free-running worker process a
strip (``ProcsEngine``), the strips joined by shared-memory rings, every
worker on the card (``--device cpu``: on the CPU); ``--batch-signatures``
steps the strips of one shape in one worker; ``--hosts N`` shards the
fleet over N launcher processes whose strips exchange across hosts only
through loopback TCP ring bridges (the paper's shm-inside, TCP-between
transport, end to end).  All give the same totals.

    python examples/torch_wafer_scale.py                  # 256x256 on the card
    python examples/torch_wafer_scale.py --rows 1024 --cols 1024 --k-inner 16 \\
        --capacity 62 --engine fused
    python examples/torch_wafer_scale.py --rows 32 --cols 32 --device cpu
    python examples/torch_wafer_scale.py --rows 32 --cols 32 --engine procs \
        [--batch-signatures] [--hosts 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.manycore import WAFER  # noqa: E402
from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition  # noqa: E402
from repro_torch.core.distributed import GraphEngine  # noqa: E402
from repro_torch.core.fused import FusedEngine  # noqa: E402
from repro_torch.core.graph import PartitionTree, Tier  # noqa: E402
from repro_torch.hw.manycore import (  # noqa: E402
    ManycoreCell, allreduce_done, expected_total, make_core_params,
)
from repro_torch.runtime import ProcsEngine  # noqa: E402


def build_engine(R: int, C: int, k_inner: int, k_outer: int,
                 capacity: int = WAFER.queue_capacity, engine: str = "graph",
                 overlap="auto", device="cuda", batch_signatures: bool = False,
                 hosts=None):
    """Torus fabric on 2 pods x 2x2 granules, every granule batched on one
    device — or, with ``engine="procs"``, on 2 pods x 2 worker processes
    over shared-memory rings (``batch_signatures`` stacks same-shape
    workers into one; ``hosts`` shards them over that many launcher
    processes joined by TCP ring bridges).  Returns (engine, per-core
    values)."""
    values = (np.arange(R * C, dtype=np.int64) % 97 + 1).astype(np.float32)
    graph = ChannelGraph.torus(
        ManycoreCell(R, C), R, C, params=make_core_params(values.reshape(R, C)),
        capacity=capacity,
    )
    if engine == "procs":
        ptree = PartitionTree(
            tiered_grid_partition(R, C, [(2, 1), (2, 1)]),
            (Tier(axes=("pod",), K=k_outer), Tier(axes=("g",), K=k_inner)),
            {"pod": 2, "g": 2},
        )
        return ProcsEngine(graph, ptree, timeout=120.0, overlap=overlap,
                           batch_signatures=batch_signatures, device=device,
                           hosts=hosts), values
    Engine = {"graph": GraphEngine, "fused": FusedEngine}[engine]
    eng = Engine(
        graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]), None,
        tiers=[(("pod",), k_outer), (("gr", "gc"), k_inner)],
        batch_axes={"pod": 2, "gr": 2, "gc": 2}, overlap=overlap, device=device,
    )
    return eng, values


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=WAFER.grid_rows)
    ap.add_argument("--cols", type=int, default=WAFER.grid_cols)
    ap.add_argument("--k-inner", type=int, default=WAFER.k_inner)
    ap.add_argument("--k-outer", type=int, default=WAFER.k_outer)
    ap.add_argument("--capacity", type=int, default=WAFER.queue_capacity)
    ap.add_argument("--engine", choices=("graph", "fused", "procs"), default="graph",
                    help="the queue interpreter, the fused-epoch fast path, or "
                         "one worker process a granule (identical results)")
    ap.add_argument("--batch-signatures", action="store_true",
                    help="procs only: step same-signature granules in one worker")
    ap.add_argument("--overlap", action="store_true",
                    help="split every tier exchange into issue/commit halves "
                         "(bit-identical results)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="procs only: shard the fleet over N launcher processes "
                         "joined by loopback TCP ring bridges (identical results)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda)")
    args = ap.parse_args(argv)
    if args.batch_signatures and args.engine != "procs":
        ap.error("--batch-signatures requires --engine procs")
    if args.hosts and args.engine != "procs":
        ap.error("--hosts requires --engine procs")
    R, C = args.rows, args.cols

    where = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
             and torch.cuda.is_available() else args.device)
    print(f"wafer-scale fabric: {R}x{C} torus = {R * C} cores on {where}, "
          f"engine={args.engine}")
    eng, values = build_engine(R, C, args.k_inner, args.k_outer, args.capacity,
                               engine=args.engine,
                               overlap=True if args.overlap else "auto",
                               device=args.device,
                               batch_signatures=args.batch_signatures,
                               hosts=args.hosts)
    periods = eng.periods
    plan = getattr(eng, "host_plan", None)
    if plan is not None:
        print(f"  host mesh: {plan.n_hosts} launcher processes "
              f"{plan.hosts}, {len(eng._links)} TCP ring bridge link(s), "
              f"granules {dict((h, plan.granules_of(h)) for h in plan.hosts)}")
    print(f"  partition: {eng.ptree.summary()}")
    if args.engine == "procs":
        print(f"  {eng.NW} worker processes for {eng.G} granules "
              f"({eng.build_stats['n_signatures']} signatures), sync periods "
              f"{periods} cycles")
    else:
        print(f"  exchange classes/tier: "
              f"{[len(c) for c in eng.tier_classes]}, sync periods {periods} cycles "
              f"(pod tier {periods[0] // periods[-1]}x rarer than intra-pod)")

    t0 = time.perf_counter()
    sim = Simulation(eng).reset(0)
    done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731
    sim.run(until=done, max_epochs=100_000, cache_key="allreduce")
    sim.block_until_ready()
    wall = time.perf_counter() - t0

    totals = eng.gather_group(sim.state, 0).total
    want = expected_total(values)
    assert np.array_equal(totals, np.full_like(totals, want)), (
        f"allreduce mismatch: {np.unique(totals)[:5]} != {want}"
    )
    cycles = sim.cycle
    if args.engine == "procs":
        eng.close()
    print(f"  all {R * C} cores converged to the global sum {want:.0f}")
    print(f"  {cycles} simulated cycles in {wall:.2f}s wall (set-up and the "
          f"device loop's capture included) = {R * C * cycles / wall:.3e} core-cycles/s")
    print("OK — tiered exchange delivered every packet across both tiers")


if __name__ == "__main__":
    main()
