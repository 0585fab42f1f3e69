"""Heterogeneous-model simulation on the PyTorch port — the web-app
scenario (paper §IV-A).

Three *different model types* interoperate through the same queue
abstraction (paper Fig. 3): a cycle-accurate "RTL-like" CPU block, a
functional "SW model" DRAM with fixed service latency, and an analog
"SPICE-like" PWL ramp generator behind a D2A/A2D bridge.  The CPU reads a
program of DRAM addresses, fetches each value, adds the digitized analog
sample, and emits results — while the analog block free-runs on its own
(rate-controlled) clock.

The same Network description is then **scaled out**: ``build(engine=
"graph")`` puts the three blocks on three granules, batched on one device,
and runs the epoch protocol (DESIGN.md §3).  At K=1 the exchange runs every
cycle, so the partitioned run is cycle-accurate and its results are
bit-identical to the single-netlist simulator; at K=8 every transaction
still completes and the analog drift stays bounded.

Then many SoCs, whole SoCs a granule, run on ``FusedEngine`` (the
paper's scale-up by more instances of the prebuilt simulators): on the
card each block type's step is a device function of ``granule_step.cu``,
all three in one launch a cycle; on the CPU the blocks' own steps.  Each
SoC's DRAM holds other contents, and every SoC's results are the single
netlist's shifted by them.

The blocks live in ``repro_torch.hw.soc`` and act on a leading instance
dim (``repro_torch.core.block``).

    python examples/torch_heterogeneous_soc.py               # on the card
    python examples/torch_heterogeneous_soc.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Simulation  # noqa: E402
from repro_torch.core.fused import FusedEngine  # noqa: E402
from repro_torch.hw.soc import (  # noqa: E402
    N_REQ, AnalogRamp, Cpu, DramModel, DramParams, build_soc, soc_done, soc_graph,
    soc_partition,
)

__all__ = ["AnalogRamp", "Cpu", "DramModel", "N_REQ", "build_soc", "run_distributed",
           "run_fused", "run_single"]


def run_single(cycles: int = 120, device="cuda"):
    """Single-netlist ground truth (cycle-accurate)."""
    net, cpu = build_soc()
    sim = net.build(device=device)
    sim.reset(0).run(cycles=cycles)
    return sim.probe(cpu)


def run_distributed(K: int = 1, cycles: int = 120, device="cuda"):
    """The same SoC, one block per granule on three granules batched on
    one device — the SAME session lifecycle as the single netlist, only
    build() differs."""
    net, cpu = build_soc()
    partition = {"cpu": 0, "dram": 1, "adc": 2}
    sim = net.build(engine="graph", partition=partition, K=K,
                    batch_axes={"gx": 3}, device=device)
    sim.reset(0).run(cycles=cycles)
    return sim.probe(cpu), sim.engine


def run_fused(n: int = 64, granules: int = 2, K: int = 8, device="cuda"):
    """``n`` SoCs, ``n / granules`` whole SoCs a granule, batched on one
    device, on ``FusedEngine``: SoC ``i``'s DRAM word ``a`` holds ``10 * a
    + i``.  Runs until every CPU retired its reads; returns every CPU's
    results (n, N_REQ), the stop cycle and the engine."""
    eng = FusedEngine(soc_graph(n), soc_partition(n, granules), None, K=K,
                      batch_axes={"g": granules}, overlap=False, device=device)
    sim = Simulation(eng)
    mem = (torch.arange(N_REQ, dtype=torch.float32) * 10.0
           + torch.arange(n, dtype=torch.float32)[:, None])
    sim.reset(0, group_params={1: DramParams(mem=mem.to(device))})
    sim.run(until=lambda s: soc_done(s.block_states[0], s.tables.active[0]),
            max_epochs=100)
    return eng.gather_group(sim.state, 0).results, sim.cycle, eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default cuda; cpu runs the same ops)")
    args = ap.parse_args(argv)

    cpu_state = run_single(device=args.device)
    results = cpu_state.results.cpu().numpy()
    print(f"heterogeneous SoC on {args.device}: RTL CPU + SW DRAM + analog ramp, "
          "one queue fabric")
    print("results:", results.round(3))
    print(f"completed {int(cpu_state.n_done)}/{N_REQ} transactions")
    assert int(cpu_state.n_done) == N_REQ
    base = np.arange(N_REQ) * 10.0
    drift = results - base
    assert (drift >= 0).all() and (drift < 1.0).all()  # analog sample in [0,1)
    print("OK — three model types interoperated through SPSC queues")

    # Scale-out: same description, partitioned engine, one block per granule.
    cpu_dist, eng = run_distributed(K=1, device=args.device)
    print(f"\npartitioned (GraphEngine, {eng.G} granules batched on one device, "
          f"{len(eng.classes)} exchange classes, K=1):")
    print("results:", cpu_dist.results.cpu().numpy().round(3))
    np.testing.assert_array_equal(cpu_dist.results.cpu().numpy(), results)
    assert int(cpu_dist.n_done) == N_REQ
    print("OK — the partitioned K=1 run is bit-identical to the single netlist")

    # Larger epochs trade timing fidelity for sync cost (paper Fig. 15):
    # the handshaked DRAM transactions still all complete.
    cpu_k8, _ = run_distributed(K=8, cycles=160, device=args.device)
    assert int(cpu_k8.n_done) == N_REQ
    drift8 = cpu_k8.results.cpu().numpy() - base
    assert (drift8 >= 0).all() and (drift8 < 1.0).all()
    print("OK — K=8 epochs: all transactions complete, analog drift bounded")

    # Scale-up: 64 SoCs, whole SoCs a granule, on the fused engine.
    many, stop, feng = run_fused(device=args.device)
    print(f"\nFusedEngine: {many.shape[0]} SoCs ({feng.graph.n_instances} blocks) on "
          f"{feng.G} batched granules, K=8: every CPU done at cycle {stop}")
    shift = np.arange(many.shape[0], dtype=np.float32)[:, None]
    np.testing.assert_array_equal(many, results[None, :] + shift)
    print("OK — every SoC's results are the single netlist's plus its own contents")


if __name__ == "__main__":
    main()
