"""The heterogeneous SoC of the paper's web-application scenario (§IV-A,
Fig. 3): three *different model types* behind one queue fabric.

  * ``Cpu``, a cycle-accurate "RTL" core: it reads DRAM words 0..N_REQ-1
    in turn, one outstanding read at a time, and retires each as the word
    plus the latest analog sample;
  * ``DramModel``, a functional "SW model" memory: a fixed service latency,
    word-addressed over ``N_REQ`` words, its contents a parameter;
  * ``AnalogRamp``, a "SPICE" PWL source ``v(t) = (t mod 16) / 16`` on a
    divided clock (a quarter of the digital rate), sampled by the A2D
    bridge every step of its own clock (§III-G).

``build_soc`` is one SoC as a ``Network``; ``soc_graph`` is N of them as
one ``ChannelGraph`` (``ChannelGraph.replicate``: no Python loop an
instance), the configuration the benchmark runs at 1,048,576 SoCs.  The
blocks act on a leading instance dim (``core.block``).

``kernels/csrc/granule_step.cu`` carries each step as a device function
(type codes 3, 4, 5 of ``kernels.granule_step.device_step_type``); any
change here must be made there too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block
from ..core.graph import ChannelGraph
from ..core.network import Network
from ..core.struct import tensor_dataclass

#: DRAM reads a CPU issues, and the words of a DRAM.
N_REQ = 8


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


# ------------------------------------------------- "RTL" cycle-accurate CPU
@tensor_dataclass
class CpuState:
    pc: torch.Tensor       # (n,) int32 — next address to read
    acc: torch.Tensor      # (n,) f32 — latest analog sample
    results: torch.Tensor  # (n, N_REQ) f32
    n_done: torch.Tensor   # (n,) int32 — reads retired
    waiting: torch.Tensor  # (n,) bool — a read is outstanding


class Cpu(Block):
    """Issues DRAM reads 0..N_REQ-1; result = dram[addr] + latest analog
    sample."""

    in_ports = ("dram_resp", "adc_in")
    out_ports = ("dram_req",)
    payload_words = 2

    def init_state(self, n, params=None, *, generator=None, device=None):
        """The CPU has no parameters and draws no random numbers."""
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
class DramParams:
    mem: torch.Tensor  # (n, N_REQ) f32 — the DRAM's contents


@tensor_dataclass
class DramState:
    mem: torch.Tensor          # (n, N_REQ) f32
    delay: torch.Tensor        # (n,) int32 — cycles left before the reply
    pending: torch.Tensor      # (n,) f32 — the word being served
    has_pending: torch.Tensor  # (n,) bool


class DramModel(Block):
    """Functional model: fixed 3-cycle service latency, word-addressed.
    Its contents are the ``DramParams`` it is given, word ``a`` holding
    ``10 * a`` where there are none."""

    in_ports = ("req",)
    out_ports = ("resp",)
    payload_words = 2
    LATENCY = 3

    def init_state(self, n, params=None, *, generator=None, device=None):
        """``params.mem`` (n, N_REQ) are the contents; draws no random
        numbers."""
        if params is None:
            mem = (torch.arange(N_REQ, dtype=torch.float32, device=device) * 10.0
                   ).expand(n, N_REQ).clone()
        else:
            mem = torch.as_tensor(params.mem, dtype=torch.float32, device=device).clone()
            if mem.shape != (n, N_REQ):
                raise ValueError(f"DRAM contents are {tuple(mem.shape)}, not ({n}, {N_REQ})")
        return DramState(
            mem=mem,
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
    t: torch.Tensor  # (n,) int32 — steps of the analog clock


class AnalogRamp(Block):
    """PWL source v(t) = (t mod 16)/16, sampled by the A2D bridge every
    cycle of its own (divided) clock — the §III-G oversampling scheme."""

    in_ports = ()
    out_ports = ("adc_out",)
    payload_words = 2
    clock_divider = 4  # analog solver steps at 1/4 the digital rate
    PERIOD = 16

    def init_state(self, n, params=None, *, generator=None, device=None):
        """The ramp has no parameters and draws no random numbers."""
        return AnalogState(t=torch.zeros((n,), dtype=torch.int32, device=device))

    def step(self, state, rx, tx_ready):
        ready = tx_ready["adc_out"]
        v = (state.t % self.PERIOD).to(torch.float32) / float(self.PERIOD)
        out = torch.stack([v, torch.zeros_like(v)], 1)
        return state.replace(t=state.t + 1), {}, {"adc_out": (out, ready)}


#: Per block type, the state leaves ``granule_step.cu``'s device step reads
#: and writes, with their dtypes, and those another thread reads within a
#: cycle (a consumer's readiness: the CPU's ``waiting``, the DRAM's
#: ``has_pending``), which the kernel keeps two buffers of, by cycle
#: parity.  The ramp has no in port, so nothing of it is read by another.
DEVICE_LEAVES = {
    Cpu: {"pc": torch.int32, "acc": torch.float32, "results": torch.float32,
          "n_done": torch.int32, "waiting": torch.bool},
    DramModel: {"mem": torch.float32, "delay": torch.int32, "pending": torch.float32,
                "has_pending": torch.bool},
    AnalogRamp: {"t": torch.int32},
}
PAIRED_LEAVES = {Cpu: ("waiting",), DramModel: ("has_pending",), AnalogRamp: ()}
#: Leaves of ``N_REQ`` words a slot.
WIDE_LEAVES = ("results", "mem")


def soc_done(cpu_state: CpuState, active=None) -> torch.Tensor:
    """() bool — every (active) CPU has retired its ``N_REQ`` reads.
    ``active`` masks padding slots (``local.tables.active[gi]``).  Nothing
    is read back to the host, so it serves as a device loop's predicate."""
    done = cpu_state.n_done >= N_REQ
    if active is not None:
        done = done | ~active
    return done.all()


def build_soc(capacity: int = 8):
    """One SoC as a ``Network``: the CPU's read requests to the DRAM, its
    replies back, and the ramp's samples into the CPU.  Returns the
    network and the CPU's instance."""
    net = Network(payload_words=2, capacity=capacity)
    cpu = net.instantiate(Cpu(), name="cpu")
    dram = net.instantiate(DramModel(), name="dram")
    adc = net.instantiate(AnalogRamp(), name="adc")
    net.connect(cpu["dram_req"], dram["req"])
    net.connect(dram["resp"], cpu["dram_resp"])
    net.connect(adc["adc_out"], cpu["adc_in"])
    return net, cpu


def soc_graph(n: int, capacity: int = 8) -> ChannelGraph:
    """N SoCs as one ``ChannelGraph``: SoC ``i``'s CPU, DRAM and ramp are
    instances ``3i``, ``3i + 1``, ``3i + 2``, in groups 0 (CPUs), 1
    (DRAMs) and 2 (ramps) by SoC; the tables equal ``from_network`` of a
    network that builds the N SoCs in turn."""
    return ChannelGraph.replicate(build_soc(capacity)[0], n)


def soc_partition(n: int, granules: int) -> np.ndarray:
    """Whole SoCs a granule: the ``n / granules`` SoCs of granule ``g`` in
    order, so every granule has the same shape and no channel crosses."""
    if n % granules:
        raise ValueError(f"{n} SoCs do not split evenly over {granules} granules")
    return np.repeat(np.arange(granules, dtype=np.int32), 3 * (n // granules))


__all__ = ["AnalogRamp", "AnalogState", "Cpu", "CpuState", "DEVICE_LEAVES",
           "DramModel", "DramParams", "DramState", "N_REQ", "PAIRED_LEAVES",
           "build_soc", "soc_done", "soc_graph", "soc_partition"]
