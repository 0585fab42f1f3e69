"""Simulation sessions — one user-facing lifecycle over the port's engines,
as in ``repro.core.session`` (paper §III-E/§IV-A; DESIGN.md §4).

``Network.build(engine=...)`` returns a ``Simulation``::

    sim = net.build(engine="fused", batch_axes={"g": 4}, tiers=[...])
    sim.reset(0)                          # engine state, owned by the session
    tx, rx = sim.tx("cmd.q"), sim.rx("resp.q")
    tx.send([41.0, 1.0])                  # host -> network queue handle
    sim.run(cycles=1000)
    print(rx.recv(), sim.cycle)

**The host is the outermost tier.**  Host packets enter and leave at
*boundaries* — every ``cycles_per_epoch`` simulated cycles — through the
same SPSC ring operations the tier exchange uses.  A ``TxPort`` never
drops traffic: packets that do not fit the device queue stay in a
host-side buffer and are flushed at later boundaries during ``run``.

The register engine (``engine="register"``) has no external ports; its
``reset`` takes no seed (the operands live in the IR), and its ``until``
predicate sees the tile-local cell dict.

**State ownership.**  The session owns the engine state and lets the
engine update it in place (``donate=True``).  Monitors, ``trace`` and
``save``/``load`` of the JAX session are not ported yet.
"""
from __future__ import annotations

import collections
from typing import Any, Callable

import numpy as np
import torch

from ..obs.registry import REGISTRY

Tree = Any

_ENGINE_KINDS = ("single", "graph", "fused", "register")
_DEFAULT_MAX_EPOCHS = 100_000
STATS_SCHEMA = "repro-stats-v1"


class TxPort:
    """Host -> network queue handle for one ``external_in`` port (PySbTx).

    ``send``/``send_many`` never drop packets: what does not fit the
    device-side queue is buffered host-side (``pending``) and flushed at
    the next epoch boundary during ``Simulation.run``.
    """

    def __init__(self, sim: "Simulation", name: str):
        self._sim = sim
        self.name = name
        self.sent = 0  # handshakes into the device queue
        self._pending: collections.deque = collections.deque()

    @property
    def pending(self) -> int:
        """Packets buffered host-side, awaiting queue space."""
        return len(self._pending)

    def send(self, payload) -> bool:
        """Queue one packet.  Returns True if it landed in the device queue
        immediately (False: buffered until the next run boundary)."""
        return self.send_many([payload]) == 1

    def send_many(self, payloads) -> int:
        """Queue a batch (k, W).  Returns how many landed in the device
        queue now; the remainder is buffered and flushed during ``run``."""
        for row in np.atleast_2d(np.asarray(payloads, np.float64)):
            self._pending.append(np.asarray(row))
        before = self.sent
        self._sim._flush_tx(self)
        return self.sent - before

    def __repr__(self):
        return f"TxPort({self.name!r}, sent={self.sent}, pending={self.pending})"


class RxPort:
    """Network -> host queue handle for one ``external_out`` port (PySbRx)."""

    def __init__(self, sim: "Simulation", name: str):
        self._sim = sim
        self.name = name
        self.received = 0

    def recv(self):
        """Pop one packet; returns its (W,) payload or None when empty."""
        out = self.drain(max_n=1)
        return out[0] if len(out) else None

    def drain(self, max_n: int | None = None) -> np.ndarray:
        """Pop up to ``max_n`` packets (all available by default).
        Returns a (k, W) array, k possibly 0."""
        return self._sim._drain_rx(self, max_n)

    def __repr__(self):
        return f"RxPort({self.name!r}, received={self.received})"


class Simulation:
    """One session facade over an engine of the port.

    Lifecycle: ``reset(seed)`` -> [``tx``/``rx``/``probe``/``run``]*.  The
    raw engine stays reachable as ``.engine``.
    """

    def __init__(self, engine):
        kind = getattr(engine, "engine_kind", None)
        if kind not in _ENGINE_KINDS:
            raise TypeError(
                f"Simulation needs an engine with engine_kind in "
                f"{_ENGINE_KINDS}, got {type(engine).__name__}"
            )
        self.engine = engine
        self.kind = kind
        self.device = engine.device
        self._state: Tree | None = None
        self._tx_ports: dict[str, TxPort] = {}
        self._rx_ports: dict[str, RxPort] = {}
        graph = getattr(engine, "graph", None)
        self._ext_in = dict(graph.ext_in) if graph is not None else {}
        self._ext_out = dict(graph.ext_out) if graph is not None else {}

    # ------------------------------------------------------------- lifecycle
    @property
    def period(self) -> int:
        """Cycles between host boundaries (the engine's epoch length)."""
        return int(self.engine.cycles_per_epoch)

    def reset(self, key: int | torch.Generator = 0, **init_kw) -> "Simulation":
        """(Re)initialize and take ownership of the engine state.  ``key``
        (an int seed or a ``torch.Generator``) seeds per-block
        ``init_state``, and is ignored by the register engine, whose
        operands live in the IR; extra kwargs go to ``engine.init``."""
        if self.kind == "register":
            self._state = self.engine.init(**init_kw)
        else:
            self._state = self.engine.init(key, **init_kw)
        for p in self._tx_ports.values():
            p.sent = 0
            p._pending.clear()
        for p in self._rx_ports.values():
            p.received = 0
        return self

    @property
    def state(self) -> Tree:
        """The live engine state.  The session lets the engine update it in
        place on the next ``run``, so hold results (e.g. from ``probe``),
        not this object."""
        return self._require_state()

    def _require_state(self) -> Tree:
        if self._state is None:
            raise RuntimeError("call reset(seed) before using the session")
        return self._state

    @property
    def cycle(self) -> int:
        """Current simulated cycle (identical on every granule)."""
        return int(self._require_state().cycle.reshape(-1)[0])

    @property
    def epoch(self) -> int:
        st = self._require_state()
        if hasattr(st, "epoch"):
            return int(st.epoch.reshape(-1)[0])
        return self.cycle // max(self.period, 1)

    def block_until_ready(self) -> "Simulation":
        """Wait for every queued device operation on the state."""
        self._require_state()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # ----------------------------------------------------------------- ports
    def tx(self, name: str) -> TxPort:
        """Host Tx queue handle for external-in port ``name``."""
        if name not in self._ext_in:
            have = sorted(self._ext_in) or "none (graph has no external-in)"
            raise KeyError(f"no external-in port {name!r}; available: {have}")
        if name not in self._tx_ports:
            self._tx_ports[name] = TxPort(self, name)
        return self._tx_ports[name]

    def rx(self, name: str) -> RxPort:
        """Host Rx queue handle for external-out port ``name``."""
        if name not in self._ext_out:
            have = sorted(self._ext_out) or "none (graph has no external-out)"
            raise KeyError(f"no external-out port {name!r}; available: {have}")
        if name not in self._rx_ports:
            self._rx_ports[name] = RxPort(self, name)
        return self._rx_ports[name]

    def _flush_tx(self, port: TxPort) -> int:
        """Push as many of ``port``'s pending packets as fit (host tier
        credit = the external queue's free space)."""
        st = self._require_state()
        cap = int(self.engine.capacity)
        moved = 0
        while port._pending:
            batch = [port._pending[i]
                     for i in range(min(len(port._pending), cap - 1))]
            st, n = self.engine.host_push_many(st, port.name, np.stack(batch))
            n = int(n)
            for _ in range(n):
                port._pending.popleft()
            port.sent += n
            moved += n
            if n < len(batch):
                break  # queue full — the rest waits for the next boundary
        self._state = st
        return moved

    def _flush_all_tx(self) -> None:
        for port in self._tx_ports.values():
            if port._pending:
                self._flush_tx(port)

    def _drain_rx(self, port: RxPort, max_n: int | None) -> np.ndarray:
        st = self._require_state()
        cap = int(self.engine.capacity)
        W = int(self.engine.W if hasattr(self.engine, "W")
                else self.engine.payload_words)
        out: list[np.ndarray] = []
        while max_n is None or len(out) < max_n:
            ask = cap - 1 if max_n is None else min(cap - 1, max_n - len(out))
            st, pays, cnt = self.engine.host_pop_many(st, port.name, ask)
            cnt = int(cnt)
            out.extend(pays.cpu().numpy()[:cnt])
            port.received += cnt
            if cnt < ask:
                break
        self._state = st
        if not out:
            return np.zeros((0, W), np.float32)
        return np.stack(out)

    # ---------------------------------------------------------------- probes
    def probe(self, inst) -> Tree:
        """One instance's live (unstacked) state.  ``inst`` is an
        ``Instance`` or a global instance id."""
        return self.engine.group_state(self._require_state(), inst)

    def stats(self) -> dict:
        """Cycle/epoch counters plus per-port session counters and live
        queue occupancy/credit, and a snapshot of the metrics registry."""
        st = self._require_state()
        occ = self.engine.port_stats(st)

        def _occ(direction: str, name: str) -> dict:
            rec = occ.get(direction, {}).get(name, {})
            return {"occupancy": int(rec.get("occupancy", 0)),
                    "credit": int(rec.get("credit", 0))}

        d: dict[str, Any] = {
            "schema": STATS_SCHEMA,
            "engine": self.kind,
            "cycle": self.cycle,
            "epoch": self.epoch,
            "ports": {
                "tx": {n: {"sent": p.sent, "pending": p.pending,
                           **_occ("tx", n)}
                       for n, p in self._tx_ports.items()},
                "rx": {n: {"received": p.received, **_occ("rx", n)}
                       for n, p in self._rx_ports.items()},
            },
        }
        if self.kind == "single":
            d["detail"] = {
                "push_count": st.push_count.cpu().numpy(),
                "pop_count": st.pop_count.cpu().numpy(),
            }
        d["metrics"] = REGISTRY.snapshot()
        return d

    # ------------------------------------------------------------------- run
    def _advance(self, n_epochs: int) -> None:
        if n_epochs <= 0:
            return
        st = self._require_state()
        if self.kind == "single":
            self._state = self.engine.run(st, n_epochs)
        else:
            self._state = self.engine.run_epochs(st, n_epochs, donate=True)
        REGISTRY.inc("session.epochs", float(n_epochs))

    def run(
        self,
        cycles: int | None = None,
        *,
        epochs: int | None = None,
        until: Callable | None = None,
        max_cycles: int | None = None,
        max_epochs: int | None = None,
        cache_key: Any = None,
    ) -> "Simulation":
        """Advance the simulation.

        cycles / epochs:  advance at least this far (cycles round UP to
            whole boundary periods on epoch-batched engines).
        until:  run until a predicate holds, within the ``max_cycles`` /
            ``max_epochs`` budget (relative to now; default 100k epochs).
            The predicate sees the engine's ``run_until`` view, and is
            checked at every boundary.  On the epoch engines it runs in
            the engine's device loop: it must return a device tensor
            without reading it back.  ``cache_key`` pins the engine's
            captured loop when the predicate is a fresh lambda per call.

        Pending Tx packets are flushed at every boundary.
        """
        if (cycles is None) + (epochs is None) + (until is None) != 2:
            raise TypeError("run() takes exactly one of cycles/epochs/until")
        self._require_state()
        self._flush_all_tx()
        per = self.period
        if until is not None:
            if max_cycles is not None and max_epochs is not None:
                raise TypeError("pass max_cycles or max_epochs, not both")
            if max_epochs is None:
                max_epochs = (-(-int(max_cycles) // per) if max_cycles is not None
                              else _DEFAULT_MAX_EPOCHS)
            if not any(p._pending for p in self._tx_ports.values()):
                st = self._require_state()
                if self.kind == "single":
                    self._state = self.engine.run_until(st, until, max_epochs * per)
                else:
                    self._state = self.engine.run_until(
                        st, until, max_epochs, cache_key=cache_key, donate=True)
                return self
            ran = 0  # pending host traffic: one boundary at a time
            while ran < max_epochs and not self._host_done(until):
                self._advance(1)
                ran += 1
                self._flush_all_tx()
            return self
        n_ep = int(epochs) if epochs is not None else -(-int(cycles) // per)
        if not any(p._pending for p in self._tx_ports.values()):
            self._advance(n_ep)
            return self
        for _ in range(n_ep):
            self._advance(1)
            self._flush_all_tx()
        return self

    def _host_done(self, done_fn) -> bool:
        st = self._require_state()
        if self.kind == "single":
            return bool(done_fn(st))
        if self.kind == "register":
            return bool(self.engine.tiles_done(st.cell, done_fn))
        local = self.engine._local_view(st)
        return bool(torch.as_tensor(done_fn(self.engine._done_view(local))).all())

    def __repr__(self):
        st = "reset" if self._state is not None else "unreset"
        return (f"Simulation(engine={type(self.engine).__name__}, "
                f"kind={self.kind!r}, {st})")
