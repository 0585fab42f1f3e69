"""Network construction — the ``SbNetwork`` analogue (paper §III-F), as in
``repro.core.network``.

Usage mirrors the paper's Listing 5::

    net = Network(payload_words=2)
    a = net.instantiate(MyBlock(), name="a")
    b = net.instantiate(MyBlock(), name="b")
    net.connect(a["out"], b["in"])          # internal channel
    host_in = net.external_in(a["in"])      # host -> network
    host_out = net.external_out(b["out"])   # network -> host
    sim = net.build(device="cuda")          # Simulation session (single engine)
    sim.reset(0)
    sim.tx(host_in).send([1.0, 0.0])        # host queue handles (PySbTx/PySbRx)
    sim.run(cycles=1000)
    print(sim.rx(host_out).recv())

The builder lowers to the channel-graph IR (``repro_torch.core.graph``), and
``build(engine=...)`` hands that IR to a backend: ``"single"`` is
``NetworkSim`` below, the cycle-accurate oracle; ``"graph"`` is
``distributed.GraphEngine``, the partitioned queue interpreter (any block
type); ``"fused"`` is ``fused.FusedEngine``; ``"register"`` is
``fastgrid.RegisterGridEngine`` (systolic grids only); ``"procs"`` is
``runtime.launcher.ProcsEngine``, one free-running worker process a
granule joined by shared-memory rings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from . import queue as qmod
from ..obs.registry import REGISTRY
from .block import Block
from .device import group_generator, resolve_device, to_tensor
from .graph import ChannelGraph
from .struct import tensor_dataclass, tree_map

Tree = Any

@dataclasses.dataclass(frozen=True)
class PortRef:
    inst_id: int
    port: str
    is_output: bool


@dataclasses.dataclass
class Instance:
    inst_id: int
    block: Block
    name: str
    params: Tree  # per-instance parameters (un-stacked tree) or None

    def __getitem__(self, port: str) -> PortRef:
        if port in self.block.out_ports:
            return PortRef(self.inst_id, port, True)
        if port in self.block.in_ports:
            return PortRef(self.inst_id, port, False)
        raise KeyError(f"{self.block.type_name} has no port {port!r}")


@tensor_dataclass
class NetworkState:
    queues: qmod.QueueArray
    block_states: tuple  # stacked per block group
    cycle: torch.Tensor  # () int32
    push_count: torch.Tensor  # (n_channels,) int32 — handshakes, for perf stats
    pop_count: torch.Tensor  # (n_channels,) int32


class Network:
    """Builder: instantiate blocks, wire channels, produce a simulator."""

    def __init__(
        self,
        payload_words: int = 2,
        dtype: Any = torch.float32,
        capacity: int = qmod.DEFAULT_CAPACITY,
    ):
        self.payload_words = payload_words
        self.dtype = dtype
        self.capacity = capacity
        self._instances: list[Instance] = []
        self._connections: list[tuple[PortRef, PortRef]] = []
        self._external_in: dict[str, PortRef] = {}
        self._external_out: dict[str, PortRef] = {}

    # -- construction API ---------------------------------------------------
    def instantiate(self, block: Block, name: str | None = None, params: Tree = None) -> Instance:
        inst = Instance(len(self._instances), block, name or f"i{len(self._instances)}", params)
        self._instances.append(inst)
        return inst

    def connect(self, tx: PortRef, rx: PortRef) -> None:
        if not tx.is_output or rx.is_output:
            raise ValueError("connect(tx, rx) needs an output then an input port")
        self._connections.append((tx, rx))

    def external_in(self, rx: PortRef, name: str | None = None) -> str:
        """Expose an input port to the host; returns the external-port name."""
        name = name or f"ext_in{len(self._external_in)}"
        self._external_in[name] = rx
        return name

    def external_out(self, tx: PortRef, name: str | None = None) -> str:
        name = name or f"ext_out{len(self._external_out)}"
        self._external_out[name] = tx
        return name

    # -- lowering ------------------------------------------------------------
    def graph(self) -> ChannelGraph:
        """Lower the builder state to the engine-agnostic channel-graph IR."""
        return ChannelGraph.from_network(self)

    def build(self, engine: str = "single", session: bool = True,
              device="cuda", **kw):
        """Lower to the IR and construct the selected backend.

        Returns a ``session.Simulation`` facade over the engine; pass
        ``session=False`` for the raw engine object.

        engine="single"  -> NetworkSim (this module); no extra kwargs.
        engine="graph"   -> distributed.GraphEngine; kwargs: mesh, K,
                            partition (instance->granule map or a
                            graph.PartitionTree), axes, tiers, batch_axes,
                            overlap.
        engine="fused"   -> fused.FusedEngine; the same kwargs as "graph".
        engine="register" -> fastgrid.RegisterGridEngine (systolic-grid
                            networks only); kwargs: K, tiles, mesh.
        engine="procs"   -> runtime.launcher.ProcsEngine: one free-running
                            worker process a granule over shared-memory
                            rings, each on ``device`` (``"cuda"``: worker
                            i on ``cuda:(i % device_count)``); kwargs:
                            partition (flat map or PartitionTree),
                            n_workers, K, ring_depth, timeout, prebuild,
                            log_dir, batch_signatures, overlap (the
                            self-healing and multi-host kwargs of the
                            reference raise ``NotImplementedError``).
        """
        graph = self.graph()
        eng = self._build_engine(graph, engine, kw, device)
        if session:
            from .session import Simulation

            return Simulation(eng)
        return eng

    def _build_engine(self, graph: ChannelGraph, engine: str, kw: dict, device):
        if engine == "single":
            if kw:
                raise TypeError(f"engine='single' takes no kwargs, got {sorted(kw)}")
            return NetworkSim(graph, device=device)
        if engine in ("graph", "fused"):
            if engine == "graph":
                from .distributed import GraphEngine as Engine
            else:
                from .fused import FusedEngine as Engine

            extra = {k: kw.pop(k) for k in ("batch_axes", "overlap") if k in kw}
            mesh = kw.pop("mesh", None)
            K = kw.pop("K", 1)
            tiers = kw.pop("tiers", None)
            axes = kw.pop("axes", None)
            partition = kw.pop("partition", None)
            if kw:
                raise TypeError(
                    f"unknown build kwargs for engine={engine!r}: {sorted(kw)}"
                )
            return Engine(graph, partition, mesh, K=K, axes=axes, tiers=tiers,
                          device=device, **extra)
        if engine == "register":
            from .fastgrid import RegisterGridEngine

            return RegisterGridEngine.from_graph(graph, device=device, **kw)
        if engine == "procs":
            from ..runtime.launcher import ProcsEngine

            return ProcsEngine(graph, kw.pop("partition", None), device=device, **kw)
        raise ValueError(
            f"unknown engine {engine!r} (single | graph | fused | register | procs)"
        )


def _scatter_or(n: int, idx: torch.Tensor, val: torch.Tensor,
                acc: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) int32 counts of ``val`` at ``idx`` (a deterministic OR when
    several ports drive one sentinel)."""
    out = acc if acc is not None else torch.zeros((n,), dtype=torch.int32,
                                                  device=idx.device)
    return out.index_add_(0, idx, val.to(torch.int32))


class NetworkSim:
    """Single-netlist simulator: a thin interpreter of the channel-graph IR,
    and the cycle-accurate oracle the other engines are checked against."""

    engine_kind = "single"
    cycles_per_epoch = 1  # host-sync granularity: every cycle is a boundary

    def __init__(self, graph: ChannelGraph, device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        self.group_blocks: list[Block] = [g.block for g in graph.groups]
        self.NULL_RX, self.NULL_TX = graph.NULL_RX, graph.NULL_TX
        self.n_channels = graph.n_channels
        self.rx_idx = [torch.as_tensor(t, dtype=torch.long, device=self.device)
                       for t in graph.rx_idx]
        self.tx_idx = [torch.as_tensor(t, dtype=torch.long, device=self.device)
                       for t in graph.tx_idx]
        self.ext_in_chan = graph.ext_in
        self.ext_out_chan = graph.ext_out
        self.payload_words = graph.payload_words
        self.dtype = graph.dtype
        self.capacity = graph.capacity

    # -- state ---------------------------------------------------------------
    def init(self, key=0) -> NetworkState:
        """Initial state.  ``key`` (an int seed or a ``torch.Generator``)
        seeds each group's ``init_state``."""
        states = []
        for gi, (g, blk) in enumerate(zip(self.graph.groups, self.group_blocks)):
            params = tree_map(lambda x: to_tensor(x, self.device), g.params)
            states.append(blk.init_state(
                g.n_members, params, generator=group_generator(key, gi),
                device=self.device,
            ))
        z = lambda: torch.zeros((self.n_channels,), dtype=torch.int32,  # noqa: E731
                                device=self.device)
        return NetworkState(
            queues=qmod.make_queues(self.n_channels, self.payload_words,
                                    self.capacity, self.dtype, self.device),
            block_states=tuple(states),
            cycle=torch.zeros((), dtype=torch.int32, device=self.device),
            push_count=z(),
            pop_count=z(),
        )

    # -- one network cycle ----------------------------------------------------
    def step(self, state: NetworkState) -> NetworkState:
        q = state.queues
        n = self.n_channels
        fronts, valids = qmod.peek(q)  # (N,W), (N,)
        readies = ~qmod.full(q)  # (N,)
        # Sentinels: NULL_RX never valid; NULL_TX always ready.
        valids[self.NULL_RX] = False
        readies[self.NULL_TX] = True

        push_payload = torch.zeros((n, self.payload_words), dtype=self.dtype,
                                   device=self.device)
        push_valid = pop_ready = None

        new_states = []
        for gi, blk in enumerate(self.group_blocks):
            rxm, txm = self.rx_idx[gi], self.tx_idx[gi]
            rx = {
                port: (fronts[rxm[:, p]], valids[rxm[:, p]])
                for p, port in enumerate(blk.in_ports)
            }
            tx_ready = {port: readies[txm[:, p]] for p, port in enumerate(blk.out_ports)}
            st = state.block_states[gi]
            new_st, rx_ready, tx = blk.step(st, rx, tx_ready)

            if blk.clock_divider > 1:
                en = (state.cycle % blk.clock_divider) == 0
                new_st = tree_map(lambda a, b: torch.where(en, a, b), new_st, st)
                rx_ready = {k: v & en for k, v in rx_ready.items()}
                tx = {k: (p, v & en) for k, (p, v) in tx.items()}
            new_states.append(new_st)

            for p, port in enumerate(blk.in_ports):
                pop_ready = _scatter_or(n, rxm[:, p], rx_ready[port], pop_ready)
            for p, port in enumerate(blk.out_ports):
                pay, val = tx[port]
                # only the NULL_TX sentinel has several writers; it is
                # never pushed, so which write lands there is irrelevant
                push_payload[txm[:, p]] = pay.to(self.dtype)
                push_valid = _scatter_or(n, txm[:, p], val, push_valid)

        zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
        push_valid = (push_valid if push_valid is not None else zeros) > 0
        pop_ready = (pop_ready if pop_ready is not None else zeros) > 0
        # Sentinel writes are dropped: never push to NULL_TX's storage, and
        # NULL_RX is never popped.
        push_valid[self.NULL_TX] = False
        pop_ready[self.NULL_RX] = False

        q2, did_push, did_pop = qmod.cycle(q, push_payload, push_valid, pop_ready)
        return NetworkState(
            queues=q2,
            block_states=tuple(new_states),
            cycle=state.cycle + 1,
            push_count=state.push_count + did_push.to(torch.int32),
            pop_count=state.pop_count + did_pop.to(torch.int32),
        )

    def run(self, state: NetworkState, n_cycles: int) -> NetworkState:
        """Advance ``n_cycles``."""
        REGISTRY.inc("single.dispatch.count")
        REGISTRY.inc("single.cycles", float(n_cycles))
        for _ in range(n_cycles):
            state = self.step(state)
        return state

    def run_until(
        self,
        state: NetworkState,
        done_fn: Callable[[NetworkState], torch.Tensor],
        max_cycles: int,
    ) -> NetworkState:
        """Step until ``done_fn(state)`` holds, or at most ``max_cycles``
        MORE cycles from the input state (a relative budget).  An
        already-done state runs zero cycles."""
        ran = 0
        while ran < max_cycles and not bool(done_fn(state)):
            state = self.step(state)
            ran += 1
        return state

    # -- host-side external port access (PySbTx / PySbRx analogue) -----------
    def host_push(self, state: NetworkState, name: str, payload):
        q2, ok = qmod.host_push(
            state.queues, self.ext_in_chan[name],
            torch.as_tensor(np.asarray(payload), dtype=self.dtype, device=self.device),
        )
        return state.replace(queues=q2), ok

    def host_pop(self, state: NetworkState, name: str):
        q2, front, valid = qmod.host_pop(state.queues, self.ext_out_chan[name])
        return state.replace(queues=q2), front, valid

    def host_push_many(self, state: NetworkState, name: str, payloads):
        """Batched push: up to ``free`` packets land, the rest are refused
        (count returned).  payloads: (k, W)."""
        payloads = torch.as_tensor(np.asarray(payloads), dtype=self.dtype,
                                   device=self.device).reshape(-1, self.payload_words)
        q2, n = qmod.host_push_many(state.queues, self.ext_in_chan[name], payloads)
        return state.replace(queues=q2), n

    def host_pop_many(self, state: NetworkState, name: str, max_n: int):
        """Batched pop: returns (state, payloads (max_n, W), count)."""
        q2, pays, cnt = qmod.host_pop_many(
            state.queues, self.ext_out_chan[name], max_n
        )
        return state.replace(queues=q2), pays, cnt

    def group_state(self, state: NetworkState, inst: Instance | int):
        """Extract one instance's (unstacked) state from the network state."""
        inst_id = inst if isinstance(inst, int) else inst.inst_id
        gi, slot = self.graph.locate(inst_id)
        return tree_map(lambda x: x[slot], state.block_states[gi])

    def port_stats(self, state: NetworkState) -> dict:
        """Per external port: live queue occupancy + remaining credit."""
        size = qmod.size(state.queues).cpu().numpy()

        def rec(cid):
            return {"occupancy": int(size[cid]),
                    "credit": int(self.capacity - 1 - size[cid])}

        return {
            "tx": {n: rec(c) for n, c in self.graph.ext_in.items()},
            "rx": {n: rec(c) for n, c in self.graph.ext_out.items()},
        }
