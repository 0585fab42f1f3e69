"""The wafer allreduce (``configs/wafer-1M.json``) as the benchmark drives
it: a ``ManycoreCell`` torus on 2 pods x 4 granules batched on one card,
built by the port's public path (``ChannelGraph.torus`` and the engine's
constructor, as ``examples/torch_wafer_scale.py`` builds it), wrapped as a
``Simulation`` and run to ``allreduce_done``.

A run draws every core's value on the device from the seed and the run's
index (whole numbers ``values.low`` to ``values.high``), hands them to
``Simulation.reset`` and reads every core's total back.  The reference
(``reference/wafer_ref.py``) gets the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import epoch_count
from ..inputs import generator
from ..reference import wafer_ref


def values(cfg: dict, seed: int, run: int, device) -> torch.Tensor:
    """(R * C,) float32 core values of run ``run``, row-major."""
    n = cfg["grid_rows"] * cfg["grid_cols"]
    lo, hi = cfg["values"]["low"], cfg["values"]["high"]
    g = generator(seed, run, device)
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                         dtype=torch.int32).to(torch.float32)


class System:
    """One wafer on the engine the traffic mix names."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.core import ChannelGraph, Simulation, tiered_grid_partition
        from repro_torch.core.distributed import GraphEngine
        from repro_torch.core.fused import FusedEngine
        from repro_torch.hw.manycore import ManycoreCell, allreduce_done, make_core_params

        engines = {"fused": FusedEngine, "graph": GraphEngine}
        if mix["engine"] not in engines:
            raise ValueError(f"the wafer runs on {sorted(engines)}, not {mix['engine']!r}")
        R, C = cfg["grid_rows"], cfg["grid_cols"]
        self.cfg, self.seed, self.device = cfg, seed, device
        self.cores = R * C
        (pr, pc), (gr, gc) = cfg["tiles"]
        graph = ChannelGraph.torus(
            ManycoreCell(R, C), R, C,
            params=make_core_params(np.ones((R, C), np.float32)),
            capacity=cfg["queue_capacity"])
        self.engine = engines[mix["engine"]](
            graph, tiered_grid_partition(R, C, cfg["tiles"]), None,
            tiers=[(("pod",), cfg["k_outer"]), (("g",), cfg["k_inner"])],
            batch_axes={"pod": pr * pc, "g": gr * gc}, overlap=False, device=device)
        self.sim = Simulation(self.engine)
        # one predicate object for every run: the device loop's captured
        # span is cached under it
        self.done = lambda s: allreduce_done(s.block_states[0], s.tables.active[0])  # noqa: E731

    def reset(self, run: int) -> None:
        from repro_torch.hw.manycore import CoreParams

        v = values(self.cfg, self.seed, run, self.device)
        self.sim.reset(0, group_params={0: CoreParams(value=v)})

    def run(self) -> None:
        self.sim.run(until=self.done, max_epochs=self.cfg["max_epochs"])

    @property
    def cycle(self) -> int:
        return self.sim.cycle

    def readback(self) -> np.ndarray:
        """Every core's total, in row-major order."""
        return self.engine.gather_group(self.sim.state, 0).total

    def close(self) -> None:
        self.sim = self.engine = self.done = None


def reference_stop(cfg: dict, mix: dict, device) -> int:
    return wafer_ref.stop_cycle(
        cfg["grid_rows"], cfg["grid_cols"], cfg["tiles"],
        (cfg["k_outer"], cfg["k_inner"]), cfg["queue_capacity"],
        mix["intra_channel"], cfg["max_epochs"], device)


class Check:
    """Of a run: the cores whose total is not the exact sum of the run's
    values, and how far its stop cycle and the cycle after its reset lie
    from the reference's."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.stop = reference_stop(cfg, mix, device)

    def __call__(self, run: int, out, rec: dict) -> dict:
        want = wafer_ref.totals(values(self.cfg, self.seed, run, self.device))
        return {"total_mismatch": float(np.count_nonzero(np.asarray(out, np.float64) != want)),
                "stop_cycle_diff": float(abs(rec["cycles"] - self.stop)),
                "start_cycle": float(abs(rec["start_cycle"]))}


def control_output(cfg: dict, mix: dict, seed: int, run: int, device) -> tuple:
    """The control's answer and record: the allreduce accumulated in
    bfloat16 in the program's place, its total in every core, stopping
    where the reference stops."""
    v = values(cfg, seed, run, device)
    total = wafer_ref.totals_bf16(v.reshape(cfg["grid_rows"], cfg["grid_cols"]))
    out = np.full(v.shape[0], total, np.float32)
    return out, {"start_cycle": 0, "cycles": reference_stop(cfg, mix, device)}


def run_bytes(cfg: dict, cycles: int) -> float:
    """The per-epoch count of one run of ``cycles`` cycles."""
    return epoch_count(cfg, cfg["grid_rows"] * cfg["grid_cols"], run_events(cfg), cycles)


def run_events(cfg: dict) -> dict:
    """Per finished run, the events the per-epoch count charges apart from
    the cores' state: packets that cross an exchange.  A row ring sends
    ``C - 1`` packets over each of its links and a column ring ``R - 1``;
    a row crosses one granule boundary a granule column, a column one a
    granule row (the torus wraps)."""
    R, C = cfg["grid_rows"], cfg["grid_cols"]
    cols = int(np.prod([t[1] for t in cfg["tiles"]]))
    rows = int(np.prod([t[0] for t in cfg["tiles"]]))
    crossing = (R * (cols if cols > 1 else 0) * (C - 1)
                + C * (rows if rows > 1 else 0) * (R - 1))
    return {"exchanged_packet": crossing}
