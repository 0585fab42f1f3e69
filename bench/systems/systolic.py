"""The §IV-B systolic array (``configs/systolic-1M.json``) as the benchmark
drives it: an R x C grid of ``SystolicCell``s computing ``Y = A @ B`` for M
streamed rows, built by the port's public path and wrapped as a
``Simulation``, run until every south cell has collected M outputs.

``engine: register`` builds ``RegisterGridEngine.from_graph`` from the IR,
which holds the operands: they are drawn once in set-up (run index -1) and
every run resets to them.  ``engine: fused`` builds ``FusedEngine.grid``
and hands ``Simulation.reset`` new operands a run, drawn on the device.
``A`` and ``B`` are standard normal from the seed and the run's index; the
reference (``reference/systolic_ref.py``) gets the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import epoch_count
from ..inputs import generator
from ..reference import systolic_ref


def operands(cfg: dict, seed: int, run: int, device) -> tuple:
    """(M, R) ``A`` and (R, C) ``B`` of run ``run``, float32."""
    M, R, C = cfg["m_stream"], cfg["grid_rows"], cfg["grid_cols"]
    g = generator(seed, run, device)
    A = torch.randn((M, R), generator=g, device=device, dtype=torch.float32)
    B = torch.randn((R, C), generator=g, device=device, dtype=torch.float32)
    return A, B


def operand_run(mix: dict, run: int) -> int:
    """The run whose operands run ``run`` computes on."""
    return -1 if mix["inputs"] == "once" else run


class System:
    """One systolic array on the engine the traffic mix names."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.core import ChannelGraph, Simulation
        from repro_torch.core.fastgrid import RegisterGridEngine
        from repro_torch.core.fused import FusedEngine
        from repro_torch.hw.systolic import SystolicCell, make_cell_params
        from repro_torch.kernels import fused_checks

        M, R, C, K = cfg["m_stream"], cfg["grid_rows"], cfg["grid_cols"], cfg["k"]
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.cores = R * C
        self.kind = mix["engine"]
        if self.kind == "register":
            if mix["inputs"] != "once":
                raise ValueError("the register engine keeps its operands in the IR: inputs 'once'")
            A, B = (x.cpu().numpy() for x in operands(cfg, seed, -1, device))
            graph = ChannelGraph.grid(SystolicCell(M), R, C, params=make_cell_params(A, B))
            self.engine = RegisterGridEngine.from_graph(
                graph, K=K, tiles=tuple(cfg["tiles"]), device=device)
            self.done = self.engine.y_done
        elif self.kind == "fused":
            Dr, Dc = cfg["tiles"]
            batch = None if (Dr, Dc) == (1, 1) else {"gr": Dr, "gc": Dc}
            self.engine = FusedEngine.grid(SystolicCell(m_stream=M), R, C, K=K,
                                           batch_axes=batch, device=device)
            self.done = fused_checks.network_done(self.engine)
            edge = make_cell_params(np.zeros((1, R), np.float32), np.zeros((R, C), np.float32))
            self._edges = {k: torch.as_tensor(getattr(edge, k)).reshape(-1).to(device)
                           for k in ("is_west", "is_north", "is_south", "is_east")}
        else:
            raise ValueError(f"the systolic array runs on 'register' or 'fused', "
                             f"not {self.kind!r}")
        self.sim = Simulation(self.engine)

    def reset(self, run: int) -> None:
        if self.kind == "register":
            self.sim.reset()
            return
        from repro_torch.hw.systolic import SystolicParams

        M, R, C = self.cfg["m_stream"], self.cfg["grid_rows"], self.cfg["grid_cols"]
        A, B = operands(self.cfg, self.seed, operand_run(self.mix, run), self.device)
        a_buf = torch.zeros((R, C, M), dtype=torch.float32, device=self.device)
        a_buf[:, 0, :] = A.T
        params = SystolicParams(b=B.reshape(-1), a_buf=a_buf.reshape(R * C, M),
                                **self._edges)
        del A, B, a_buf
        self.sim.reset(0, group_params={0: params})

    def run(self) -> None:
        self.sim.run(until=self.done, max_epochs=self.cfg["max_epochs"])

    @property
    def cycle(self) -> int:
        return self.sim.cycle

    def readback(self) -> np.ndarray:
        """``Y``, (M, C)."""
        if self.kind == "register":
            return self.engine.result(self.sim.state)
        from repro_torch.kernels import fused_checks

        c = self.cfg
        return fused_checks.grid_result(self.engine, self.sim.state, 0, c["grid_rows"],
                                        c["grid_cols"], c["m_stream"])

    def close(self) -> None:
        self.sim = self.engine = self.done = None


def reference_stop(cfg: dict, mix: dict, device) -> int:
    if tuple(cfg["tiles"]) != (1, 1):
        raise ValueError("the reference models one tile")
    return systolic_ref.stop_cycle(cfg["m_stream"], cfg["grid_rows"], cfg["grid_cols"],
                                   cfg["k"], cfg["max_epochs"], device)


class Check:
    """Of a run: the largest ``|Y - Y_ref|``, and how far its stop cycle and
    the cycle after its reset lie from the reference's.  Runs on one set of
    operands share one reference product."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.stop = reference_stop(cfg, mix, device)
        self._key, self._want = None, None

    def __call__(self, run: int, out, rec: dict) -> dict:
        key = operand_run(self.mix, run)
        if key != self._key:
            A, B = operands(self.cfg, self.seed, key, self.device)
            self._key, self._want = key, systolic_ref.product(A, B).cpu().numpy()
        diff = np.abs(np.asarray(out, np.float64) - np.asarray(self._want, np.float64))
        return {"y_max_abs_diff": float(np.nan_to_num(diff, nan=np.inf).max()),
                "stop_cycle_diff": float(abs(rec["cycles"] - self.stop)),
                "start_cycle": float(abs(rec["start_cycle"]))}


def control_output(cfg: dict, mix: dict, seed: int, run: int, device) -> tuple:
    """The control's answer and record: the fused multiply-add chain in
    bfloat16 in the program's place, stopping where the reference stops."""
    A, B = operands(cfg, seed, operand_run(mix, run), device)
    y = systolic_ref.product(A, B, torch.bfloat16).float().cpu().numpy()
    return y, {"start_cycle": 0, "cycles": reference_stop(cfg, mix, device)}


def run_bytes(cfg: dict, cycles: int) -> float:
    """The per-epoch count of one run of ``cycles`` cycles."""
    return epoch_count(cfg, cfg["grid_rows"] * cfg["grid_cols"], run_events(cfg), cycles)


def run_events(cfg: dict) -> dict:
    """Per finished run, the events the per-epoch count charges apart from
    the cells' state: every A element read once by its west cell, every Y
    element written once by its south cell."""
    M, R, C = cfg["m_stream"], cfg["grid_rows"], cfg["grid_cols"]
    return {"stream_read": M * R, "collect_write": M * C}
