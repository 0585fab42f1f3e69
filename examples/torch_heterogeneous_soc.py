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

The blocks act on a leading instance dim (``repro_torch.core.block``);
none of them has a device step in the fused engine's kernel, so
``GraphEngine`` is the partitioned engine that runs them on the card.

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

from repro_torch.core import Block, Network  # noqa: E402
from repro_torch.core.struct import tensor_dataclass  # noqa: E402

N_REQ = 8


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


# ------------------------------------------------- "RTL" cycle-accurate CPU
@tensor_dataclass
class CpuState:
    pc: torch.Tensor       # (n,) int32
    acc: torch.Tensor      # (n,) f32 — latest analog sample
    results: torch.Tensor  # (n, N_REQ) f32
    n_done: torch.Tensor   # (n,) int32
    waiting: torch.Tensor  # (n,) bool


class Cpu(Block):
    """Issues DRAM reads 0..N-1; result = dram[addr] + latest analog sample."""

    in_ports = ("dram_resp", "adc_in")
    out_ports = ("dram_req",)
    payload_words = 2

    def init_state(self, n, params=None, *, generator=None, device=None):
        zi = torch.zeros((n,), dtype=torch.int32, device=device)
        return CpuState(
            pc=zi.clone(), acc=torch.zeros((n,), device=device),
            results=torch.zeros((n, N_REQ), device=device), n_done=zi.clone(),
            waiting=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def step(self, state, rx, tx_ready):
        (resp, resp_v) = rx["dram_resp"]
        (adc, adc_v) = rx["adc_in"]
        req_ready = tx_ready["dram_req"]

        # always consume the freshest analog sample
        acc = torch.where(adc_v, adc[:, 0], state.acc)

        issue = (~state.waiting) & (state.pc < N_REQ) & req_ready
        retire = state.waiting & resp_v
        result = resp[:, 0] + acc
        rows, slot = _rows(acc), (state.n_done % N_REQ).long()
        results = state.results.clone()
        results[rows, slot] = torch.where(retire, result, state.results[rows, slot])
        new = state.replace(
            pc=state.pc + issue.to(torch.int32),
            acc=acc,
            results=results,
            n_done=state.n_done + retire.to(torch.int32),
            waiting=(state.waiting | issue) & ~retire,
        )
        req = torch.stack([state.pc.to(torch.float32), torch.zeros_like(acc)], 1)
        return new, {"dram_resp": retire, "adc_in": adc_v}, {"dram_req": (req, issue)}


# ------------------------------------------------- "SW model" DRAM
@tensor_dataclass
class DramState:
    mem: torch.Tensor          # (n, N_REQ) f32
    delay: torch.Tensor        # (n,) int32
    pending: torch.Tensor      # (n,) f32
    has_pending: torch.Tensor  # (n,) bool


class DramModel(Block):
    """Functional model: fixed 3-cycle service latency, word-addressed."""

    in_ports = ("req",)
    out_ports = ("resp",)
    payload_words = 2
    LATENCY = 3

    def init_state(self, n, params=None, *, generator=None, device=None):
        mem = torch.arange(N_REQ, dtype=torch.float32, device=device) * 10.0
        return DramState(
            mem=mem.expand(n, N_REQ).clone(),
            delay=torch.zeros((n,), dtype=torch.int32, device=device),
            pending=torch.zeros((n,), device=device),
            has_pending=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def step(self, state, rx, tx_ready):
        (req, req_v) = rx["req"]
        resp_ready = tx_ready["resp"]
        accept = req_v & ~state.has_pending
        addr = req[:, 0].to(torch.int32) % N_REQ
        value = state.mem[_rows(addr), addr.long()]
        ready_to_send = state.has_pending & (state.delay <= 0)
        send = ready_to_send & resp_ready
        new = state.replace(
            delay=torch.where(accept, self.LATENCY, torch.clamp(state.delay - 1, min=0)),
            pending=torch.where(accept, value, state.pending),
            has_pending=(state.has_pending | accept) & ~send,
        )
        resp = torch.stack([state.pending, torch.ones_like(state.pending)], 1)
        return new, {"req": accept}, {"resp": (resp, send)}


# ------------------------------------------------- "SPICE" PWL analog block
@tensor_dataclass
class AnalogState:
    t: torch.Tensor  # (n,) int32


class AnalogRamp(Block):
    """PWL source v(t) = (t mod 16)/16, sampled by the A2D bridge every
    cycle of its own (divided) clock — the §III-G oversampling scheme."""

    in_ports = ()
    out_ports = ("adc_out",)
    payload_words = 2
    clock_divider = 4  # analog solver steps at 1/4 the digital rate

    def init_state(self, n, params=None, *, generator=None, device=None):
        return AnalogState(t=torch.zeros((n,), dtype=torch.int32, device=device))

    def step(self, state, rx, tx_ready):
        ready = tx_ready["adc_out"]
        v = (state.t % 16).to(torch.float32) / 16.0
        out = torch.stack([v, torch.zeros_like(v)], 1)
        return state.replace(t=state.t + 1), {}, {"adc_out": (out, ready)}


def build_soc(capacity: int = 8):
    """One Network description, reused by every engine backend."""
    net = Network(payload_words=2, capacity=capacity)
    cpu = net.instantiate(Cpu(), name="cpu")
    dram = net.instantiate(DramModel(), name="dram")
    adc = net.instantiate(AnalogRamp(), name="adc")
    net.connect(cpu["dram_req"], dram["req"])
    net.connect(dram["resp"], cpu["dram_resp"])
    net.connect(adc["adc_out"], cpu["adc_in"])
    return net, cpu


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


if __name__ == "__main__":
    main()
