"""Simulation sessions — one user-facing lifecycle over the port's engines,
as in ``repro.core.session`` (paper §III-E/§IV-A; DESIGN.md §4).

``Network.build(engine=...)`` returns a ``Simulation``::

    sim = net.build(engine="fused", batch_axes={"g": 4}, tiers=[...])
    sim.reset(0)                          # engine state, owned by the session
    tx, rx = sim.tx("cmd.q"), sim.rx("resp.q")
    tx.send([41.0, 1.0])                  # host -> network queue handle
    sim.run(cycles=1000)
    print(rx.recv(), sim.cycle)
    sim.save("/tmp/ckpt")                 # checkpoint; sim.load() resumes

**The host is the outermost tier.**  Host packets enter and leave at
*boundaries* — every ``cycles_per_epoch`` simulated cycles — through the
same SPSC ring operations the tier exchange uses.  A ``TxPort`` never
drops traffic: packets that do not fit the device queue stay in a
host-side buffer and are flushed at later boundaries during ``run``.

The register engine (``engine="register"``) has no external ports; its
``reset`` takes no seed (the operands live in the IR), and its ``until``
predicate sees the tile-local cell dict.  The procs engine
(``engine="procs"``) keeps its state in worker processes: the session
holds a handle, its until-predicates run on the host over every granule's
view (``eval_done``), ``save``/``load`` go through the engine's
``gather_state``/``scatter_state``, and ``stats()`` carries one row a
worker's granule under ``"workers"``.

**State ownership.**  The session owns the engine state and lets the
engine update it in place (``donate=True``).  The legacy
engine-state-threading surface (``init(key)`` / ``run(state, n)`` /
``run_epochs(state, n)`` / ``push_external``) keeps working through
deprecation shims, and an input a shim donated is *poisoned*: touching it
afterwards raises ``DonatedStateError``.

**Probes and monitors** (the paper's PyMonitor): ``sim.probe(inst)``
returns one instance's live state; ``sim.stats()`` reports the
``repro-stats-v1`` schema (``obs.schema``); ``sim.add_monitor(fn,
every=...)`` samples a host callback at epoch boundaries during ``run``,
counted on the global boundary index.  ``sim.trace(path)`` records the
run's windows into a Chrome/Perfetto ``trace.json`` (``obs.trace``), and
``sim.save``/``sim.load`` checkpoint the state and the ports' buffers
(``checkpoint.checkpointing``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from ..obs.schema import STATS_SCHEMA
from .mesh import unshard
from .struct import tree_leaves

Tree = Any

_ENGINE_KINDS = ("single", "graph", "fused", "register", "procs")
_DEFAULT_MAX_EPOCHS = 100_000


class DonatedStateError(RuntimeError):
    """A state that was donated to an engine run was reused."""


class _Donated:
    """Poison sentinel installed over a donated state's fields."""

    __slots__ = ("_api",)

    def __init__(self, api: str):
        object.__setattr__(self, "_api", api)

    def _fail(self, *a, **k):
        raise DonatedStateError(
            f"state was donated to {object.__getattribute__(self, '_api')}; "
            "use Simulation (which owns its state) or pass donate=False"
        )

    __getattr__ = __array__ = __iter__ = __len__ = __bool__ = _fail
    __getitem__ = __add__ = __mul__ = _fail

    def __repr__(self):
        return f"<donated state ({object.__getattribute__(self, '_api')})>"


def poison_donated(state: Tree, api: str) -> None:
    """Overwrite a donated state's fields with a guard that raises a clear
    ``DonatedStateError`` on any later use (a CUDA run may have updated
    its tensors in place).  Mutates ``state`` in place; no-op for
    non-dataclass states."""
    if not dataclasses.is_dataclass(state):
        return
    guard = _Donated(api)
    for f in dataclasses.fields(state):
        object.__setattr__(state, f.name, guard)


def _poison_input(state: Tree, out: Tree, api: str) -> None:
    """Poison the donated input ``state`` unless the engine returned that
    very object (a CUDA until-run updates the state in place and returns
    its input): the state the caller gets back stays usable."""
    if out is not state:
        poison_donated(state, api)


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


class Monitor:
    """A host callback sampled at epoch boundaries during ``run``.

    Cadence is counted on the GLOBAL boundary index (simulated cycle /
    period), not per ``run`` call — ten ``run(epochs=1)`` calls sample
    exactly like one ``run(epochs=10)``.
    """

    def __init__(self, sim: "Simulation", fn: Callable[["Simulation"], None],
                 every: int):
        self._sim = sim
        self.fn = fn
        self.every = max(int(every), 1)  # boundary cadence, in epochs
        self.samples = 0
        self._last = 0  # last global boundary index fired at

    def remove(self) -> None:
        if self in self._sim._monitors:
            self._sim._monitors.remove(self)

    def _fire(self):
        self.samples += 1
        self.fn(self._sim)


class Simulation:
    """One session facade over an engine of the port.

    Lifecycle: ``reset(seed)`` -> [``tx``/``rx``/``probe``/``run``]* ->
    ``save``/``load``.  The raw engine stays reachable as ``.engine``;
    unknown attributes delegate to it, and the legacy state-threading
    surface keeps working via deprecation shims (with donated inputs
    poisoned — see ``DonatedStateError``).

    ``period`` (cycles between host boundaries) defaults to the engine's
    epoch and must be a multiple of it.
    """

    def __init__(self, engine, *, period: int | None = None):
        kind = getattr(engine, "engine_kind", None)
        if kind not in _ENGINE_KINDS:
            raise TypeError(
                f"Simulation needs an engine with engine_kind in "
                f"{_ENGINE_KINDS}, got {type(engine).__name__}"
            )
        self.engine = engine
        self.kind = kind
        self.device = engine.device
        if period is not None and kind != "single":
            cpe = int(engine.cycles_per_epoch)
            if period % cpe:
                raise ValueError(
                    f"period={period} must be a multiple of the engine's "
                    f"epoch ({cpe} cycles)"
                )
        self._period = period
        self._state: Tree | None = None
        self._tx_ports: dict[str, TxPort] = {}
        self._rx_ports: dict[str, RxPort] = {}
        self._monitors: list[Monitor] = []
        graph = getattr(engine, "graph", None)
        self._ext_in = dict(graph.ext_in) if graph is not None else {}
        self._ext_out = dict(graph.ext_out) if graph is not None else {}
        # flight recorder: REPRO_TRACE=<path> arms the process-global
        # recorder (exported at interpreter exit); engines that carry
        # worker telemetry switch it on too
        if _trace.maybe_enable_from_env():
            st = getattr(engine, "set_tracing", None)
            if st is not None:
                st(True)

    # ------------------------------------------------------------- lifecycle
    @property
    def period(self) -> int:
        """Cycles between host boundaries (the engine's epoch length unless
        the session was given a ``period``)."""
        if self._period is not None:
            return self._period
        return int(self.engine.cycles_per_epoch)

    def reset(self, key: int | torch.Generator = 0, **init_kw) -> "Simulation":
        """(Re)initialize and take ownership of the engine state.  ``key``
        (an int seed or a ``torch.Generator``) seeds per-block
        ``init_state``, and is ignored by the register engine, whose
        operands live in the IR; extra kwargs go to ``engine.init``.  Each
        call is a new ``run`` of the trace recorder: the ``session.reset``
        span and the spans of the run after it carry its number."""
        rec = _trace.recorder()
        rec.run += 1
        with rec.session_span("session.reset"):
            if self.kind == "register":
                self._state = self.engine.init(**init_kw)
            else:
                self._state = self.engine.init(key, **init_kw)
        for p in self._tx_ports.values():
            p.sent = 0
            p._pending.clear()
        for p in self._rx_ports.values():
            p.received = 0
        for m in self._monitors:
            m.samples = 0
            m._last = 0
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
        if isinstance(getattr(self._state, "cycle", None), _Donated):
            self._state.cycle._fail()  # raises DonatedStateError
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
        """Wait for every queued device operation on the state (a procs
        run returns once every worker has finished its epochs)."""
        self._require_state()
        if self.device.type == "cuda" and self.kind != "procs":
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

    # ------------------------------------------------------ probes / monitors
    def probe(self, inst) -> Tree:
        """One instance's live (unstacked) state.  ``inst`` is an
        ``Instance`` or a global instance id."""
        return self.engine.group_state(self._require_state(), inst)

    def stats(self) -> dict:
        """Cycle/epoch counters plus per-port state, behind the ONE
        validated schema on every engine (``repro-stats-v1``; see
        ``obs.schema.validate_stats``): each tx/rx entry nests the session
        counters (sent/pending resp. received) and the port's live queue
        occupancy/credit.  Engine-specific extras (the single engine's
        per-channel push/pop handshake counts) live under ``"detail"``,
        and ``"metrics"`` is a snapshot of the process-global registry."""
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
        REGISTRY.set("session.tx.sent",
                     float(sum(p.sent for p in self._tx_ports.values())))
        REGISTRY.set("session.rx.received",
                     float(sum(p.received for p in self._rx_ports.values())))
        if self.kind == "single":
            d["detail"] = {
                "push_count": st.push_count.cpu().numpy(),
                "pop_count": st.pop_count.cpu().numpy(),
            }
        fs = getattr(self.engine, "fault_stats", None)
        if fs is not None:
            # the procs runtime's self-healing surface: policy, restart
            # count, snapshot cadence/epoch, replayed epochs
            d["faults"] = fs()
        if self.kind == "procs":
            d["workers"] = self.engine.worker_stats(st)
        bs = getattr(self.engine, "bridge_stats", None)
        if bs is not None:
            # multi-host fleets: one row per TCP ring bridge side —
            # bytes/slabs/credits each way, credit RTT, wait fraction
            # (steady-state pump only; cold-start under "connect_s")
            rows = bs()
            if rows:
                d["bridges"] = rows
        d["metrics"] = REGISTRY.snapshot()
        return d

    @contextlib.contextmanager
    def trace(self, path: str):
        """Flight-recorder window: record span/instant events for the body,
        then export a Perfetto/Chrome-loadable ``trace.json`` to ``path``::

            with sim.trace("/tmp/trace.json"):
                sim.run(epochs=200)

        Tracing changes no simulated behavior: final state and host Rx
        traffic stay bit-identical to an untraced run.  No span
        synchronizes with the card: each ends when the host returns from
        the call (a CUDA run returns at launch), and the device's time
        comes from a device trace (``torch.profiler``) of the same window,
        laid beside the spans through the clock anchors the file carries
        (``obs.trace``).  The ``REPRO_TRACE=<path>`` env knob is the
        non-contextual variant (exports at interpreter exit)."""
        rec = _trace.recorder()
        prev = rec.enabled
        rec.enable()
        st = getattr(self.engine, "set_tracing", None)
        if st is not None:
            st(True)
        try:
            yield self
        finally:
            try:
                flush = getattr(self.engine, "flush_telemetry", None)
                if flush is not None:
                    flush()
                if st is not None:
                    st(False)
            finally:
                rec.export(path)
                if not prev:
                    rec.disable()

    def add_monitor(self, fn: Callable[["Simulation"], None],
                    every: int = 1) -> Monitor:
        """Register a host callback fired every ``every`` epoch boundaries
        during ``run`` (the paper's PyMonitor).  Returns a removable
        handle."""
        mon = Monitor(self, fn, every)
        self._monitors.append(mon)
        return mon

    # ------------------------------------------------------------------- run
    def _window_span(self, t0: float, args: dict) -> None:
        """Record the ``epoch_window`` span begun at ``t0``, ended now: when
        the host returns, which on a CUDA state may be before the stream
        has finished the window (the device trace holds that)."""
        _trace.recorder().span("epoch_window", t0, time.monotonic() - t0,
                               cat="session", args=args)

    def _advance_epochs(self, n_epochs: int) -> None:
        """``n_epochs`` boundary periods through the engine, which may
        update the owned state in place."""
        if n_epochs <= 0:
            return
        st = self._require_state()
        rec = _trace.recorder()
        t0 = time.monotonic() if rec.enabled else 0.0
        if self.kind == "single":
            self._state = self.engine.run(st, n_epochs * self.period)
        else:
            per = self.period // int(self.engine.cycles_per_epoch)
            self._state = self.engine.run_epochs(st, n_epochs * per, donate=True)
        if rec.enabled:
            self._window_span(t0, {"epochs": int(n_epochs)})

    def _advance_cycles_single(self, n_cycles: int) -> None:
        if n_cycles > 0:
            rec = _trace.recorder()
            t0 = time.monotonic() if rec.enabled else 0.0
            self._state = self.engine.run(self._require_state(), n_cycles)
            if rec.enabled:
                self._window_span(t0, {"cycles": int(n_cycles)})

    def _host_done(self, done_fn) -> bool:
        """The predicate read on the host, on the view the engine's
        ``run_until`` shows it: the full state (single), each tile's cell
        dict (register), or each shard's granule-local state via
        ``_done_view``."""
        st = self._require_state()
        if self.kind == "single":
            return bool(done_fn(st))
        if self.kind == "procs":
            # worker states never enter this process: the engine gathers
            # each granule's view and evaluates host-side
            return bool(self.engine.eval_done(st, done_fn))
        return self.engine.host_done(st, done_fn)

    def _session_run(
        self,
        cycles: int | None = None,
        *,
        epochs: int | None = None,
        until: Callable | None = None,
        max_cycles: int | None = None,
        max_epochs: int | None = None,
        cache_key: Any = None,
    ) -> "Simulation":
        """Advance the simulation — the implementation behind
        ``run(cycles=... | epochs=... | until=...)``.

        cycles / epochs:  advance at least this far (cycles round UP to
            whole boundary periods on epoch-batched engines).
        until:  run until a predicate holds, within the ``max_cycles`` /
            ``max_epochs`` budget (relative to now; default 100k epochs).
            The predicate sees the engine's ``run_until`` view, and is
            checked before every epoch.  On the epoch engines it runs in
            the engine's device loop: it must return a device tensor
            without reading it back.  ``cache_key`` pins the engine's
            captured loop when the predicate is a fresh lambda per call.

        Pending Tx packets are flushed and monitors sampled at every
        boundary; with no monitors and no pending traffic the whole run
        is a single engine call.
        """
        if (cycles is None) + (epochs is None) + (until is None) != 2:
            raise TypeError("run() takes exactly one of cycles/epochs/until")
        self._require_state()
        self._flush_all_tx()
        if until is not None:
            return self._run_until(until, max_cycles, max_epochs, cache_key)

        per = self.period
        n_ep = int(epochs) if epochs is not None else -(-int(cycles) // per)
        exact_cycles = (
            int(cycles) if (cycles is not None and self.kind == "single")
            else None
        )

        chunk = self._boundary_chunk()
        if chunk is None:  # no boundary work: one engine call
            if exact_cycles is not None:
                self._advance_cycles_single(exact_cycles)
            else:
                self._advance_epochs(n_ep)
            return self

        total_c = exact_cycles if exact_cycles is not None else n_ep * per
        done_c = 0
        while done_c < total_c:
            if chunk == 1:
                step_c = min(per, total_c - done_c)
            else:
                # align chunks to the GLOBAL boundary grid so monitor
                # cadences are invariant to how runs are sliced
                cur_b = self.cycle // per
                step_c = min((chunk - cur_b % chunk) * per, total_c - done_c)
            if exact_cycles is not None:
                self._advance_cycles_single(step_c)
            else:
                self._advance_epochs(step_c // per)
            done_c += step_c
            self._boundary()
        return self

    def _boundary_chunk(self) -> int | None:
        """Epochs between host boundaries, or None when nothing needs
        them (one engine call).  The gcd of the monitor cadences, so
        boundaries land on every multiple of every monitor's ``every``
        (min would silently skip non-dividing cadences)."""
        cadences = [m.every for m in self._monitors]
        if any(p._pending for p in self._tx_ports.values()):
            cadences.append(1)
        if not cadences:
            return None
        return functools.reduce(math.gcd, cadences)

    def _boundary(self) -> None:
        self._flush_all_tx()
        if not self._monitors:
            return
        cyc = self.cycle
        if cyc % self.period:
            return  # mid-period (single-engine exact-cycle remainder)
        b = cyc // self.period  # global boundary index
        for mon in list(self._monitors):
            if b and b % mon.every == 0 and b != mon._last:
                mon._last = b
                mon._fire()
                REGISTRY.inc("session.monitor.fired")

    def _run_until(self, done_fn, max_cycles, max_epochs, cache_key):
        per = self.period
        if max_cycles is not None and max_epochs is not None:
            raise TypeError("pass max_cycles or max_epochs, not both")
        if max_epochs is None:
            max_epochs = (
                -(-int(max_cycles) // per) if max_cycles is not None
                else _DEFAULT_MAX_EPOCHS
            )
        if any(p._pending for p in self._tx_ports.values()):
            # pending host traffic: one boundary at a time, the predicate
            # read on the host before every epoch
            ran = 0
            while ran < max_epochs and not self._host_done(done_fn):
                self._advance_epochs(1)
                ran += 1
                self._boundary()
            return self
        chunk = self._boundary_chunk()
        if chunk is None:
            self._until(done_fn, max_epochs, cache_key)
            return self
        # monitors: each stretch up to the next boundary runs in the
        # engine's until-loop with the stretch as its budget.  The loop
        # checks the predicate before every epoch and its budget is
        # relative, so it stops where the monitor-free run stops, and a
        # done state runs no epoch.
        ran = 0
        while ran < max_epochs:
            step = min(chunk - (self.cycle // per) % chunk, max_epochs - ran)
            n = self._until_stretch(done_fn, step, cache_key)
            ran += n  # fewer than step: the predicate held
            self._boundary()
            if n < step:
                break
        return self

    def _until_stretch(self, done_fn, step: int, cache_key) -> int:
        """Up to ``step`` epochs of the engine's until-loop; returns how
        many ran.  While the trace recorder is on, the stretch runs as
        one-epoch calls, each its own ``epoch_window`` span, as the
        reference records one span an epoch; untraced it is one call."""
        per = self.period
        rec = _trace.recorder()
        if not rec.enabled:
            c0 = self.cycle
            self._until(done_fn, step, cache_key)
            return (self.cycle - c0) // per
        n = 0
        while n < step:
            c0, t0 = self.cycle, time.monotonic()
            self._until(done_fn, 1, cache_key)
            if self.cycle == c0:
                break
            n += 1
            self._window_span(t0, {"epochs": 1})
        return n

    def _until(self, done_fn, n_epochs: int, cache_key) -> None:
        """The engine's until-loop within a budget of ``n_epochs`` boundary
        periods (relative to now), traced as one ``session.until`` span
        whose ``epochs`` are the device loop's (``until.epochs``, a host
        counter)."""
        st = self._require_state()
        rec = _trace.recorder()
        with rec.session_span("session.until") as args:
            e0 = REGISTRY.counters().get("until.epochs", 0.0) if rec.enabled else 0.0
            if self.kind == "single":
                self._state = self.engine.run_until(st, done_fn, n_epochs * self.period)
            else:
                per_engine = self.period // int(self.engine.cycles_per_epoch)
                self._state = self.engine.run_until(
                    st, done_fn, n_epochs * per_engine, cache_key=cache_key,
                    donate=True)
            if rec.enabled:
                args["epochs"] = int(REGISTRY.counters().get("until.epochs", 0.0) - e0)

    # ---------------------------------------------------------- checkpoints
    def save(self, path: str, step: int | None = None, *,
             keep_last: int = 3) -> str:
        """Checkpoint the session (engine state + host-port buffers) under
        ``path`` via ``checkpoint.checkpointing`` (atomic tmp+rename).  A
        sharded engine's state is written in the global layout
        (``core.mesh.unshard``); a procs engine's is gathered from its
        workers (``gather_state``).  Returns the written directory."""
        from ..checkpoint import checkpointing

        st = unshard(self._require_state())
        if self.kind == "procs":
            st = self.engine.gather_state(st)
        if step is None:
            step = self.cycle
        meta = {
            "engine_kind": self.kind,
            "cycle": self.cycle,
            "ports": {
                "tx": {
                    n: {"sent": p.sent,
                        "pending": [np.asarray(r).tolist()
                                    for r in p._pending]}
                    for n, p in self._tx_ports.items()
                },
                "rx": {n: {"received": p.received}
                       for n, p in self._rx_ports.items()},
            },
        }
        return checkpointing.save(path, step, st, meta=meta,
                                  keep_last=keep_last)

    def load(self, path: str, step: int | None = None) -> "Simulation":
        """Restore a checkpoint into this session; the current state is the
        template, so call ``reset`` first.  A procs engine scatters it into
        its workers (``scatter_state``).  On a CUDA state the leaves are
        copied into the live state's own tensors: their addresses stay,
        and an until-loop the engine captured for this state replays
        after the load instead of capturing again."""
        from ..checkpoint import checkpointing

        template = self._require_state()
        gathered = self.kind == "procs"
        if gathered:  # the workers' state, gathered as the template
            template = self.engine.gather_state(template)
        tree, meta = checkpointing.restore(path, unshard(template), step)
        if meta.get("engine_kind") not in (None, self.kind):
            raise ValueError(
                f"checkpoint was saved from engine "
                f"{meta['engine_kind']!r}, this session is {self.kind!r}"
            )
        place = getattr(self.engine, "place", None)
        if place is not None:
            tree = place(tree)  # the global layout onto the shards
        if gathered:
            self._state = self.engine.scatter_state(self._require_state(), tree)
        elif self.device.type == "cuda":
            for dst, src in zip(tree_leaves(template), tree_leaves(tree)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        else:
            self._state = tree
        for n, rec in meta.get("ports", {}).get("tx", {}).items():
            port = self.tx(n)
            port.sent = int(rec.get("sent", 0))
            port._pending = collections.deque(
                np.asarray(r) for r in rec.get("pending", [])
            )
        for n, rec in meta.get("ports", {}).get("rx", {}).items():
            self.rx(n).received = int(rec.get("received", 0))
        return self

    # ------------------------------------------------------ deprecation shims
    # The pre-session surface: explicit engine-state threading.  Each shim
    # warns, delegates to the engine, and poisons a donated input so stale
    # reuse raises DonatedStateError.
    def _shim(self, old: str, new: str) -> None:
        warnings.warn(
            f"Simulation.{old} is the legacy engine-state-threading surface;"
            f" use {new} (see DESIGN.md §4 migration notes)",
            DeprecationWarning, stacklevel=3,
        )

    def init(self, *args, **kw):
        self._shim("init(...)", "reset(key)")
        return self.engine.init(*args, **kw)

    def run_epochs(self, state, n_epochs, **kw):
        self._shim("run_epochs(state, n)", "run(epochs=n)")
        out = self.engine.run_epochs(state, n_epochs, **kw)
        if kw.get("donate", True):
            _poison_input(state, out, "run_epochs")
        return out

    def run_cycles(self, state, n_cycles):
        self._shim("run_cycles(state, n)", "run(cycles=n)")
        out = self.engine.run_cycles(state, n_cycles)
        _poison_input(state, out, "run_cycles")  # run_cycles always donates
        return out

    def run_until(self, state, done_fn, max_epochs, **kw):
        self._shim("run_until(state, ...)", "run(until=...)")
        out = self.engine.run_until(state, done_fn, max_epochs, **kw)
        if kw.get("donate", True):
            _poison_input(state, out, "run_until")
        return out

    def run_until_done(self, state, max_epochs, **kw):
        self._shim("run_until_done(state, ...)", "run(until=...)")
        out = self.engine.run_until_done(state, max_epochs, **kw)
        if kw.get("donate", True):
            _poison_input(state, out, "run_until_done")
        return out

    def push_external(self, state, name, payload):
        self._shim("push_external(state, ...)", "tx(name).send(...)")
        return self.engine.host_push(state, name, payload)

    def pop_external(self, state, name):
        self._shim("pop_external(state, ...)", "rx(name).recv()")
        return self.engine.host_pop(state, name)

    def run(self, *args, **kw):
        """``run(cycles=... | epochs=... | until=...)`` — see
        ``_session_run``.  Also accepts the legacy ``run(state, n_cycles)``
        call shape of the single engine as a deprecation shim (which
        donates nothing: ``NetworkSim.run`` returns a new state)."""
        if args and not isinstance(args[0], (int, np.integer)):
            self._shim("run(state, n)", "run(cycles=n)")
            return self.engine.run(*args, **kw)
        if args:
            kw.setdefault("cycles", int(args[0]))
        return self._session_run(**kw)

    def __getattr__(self, name: str):
        # Anything the facade does not define delegates to the engine
        # (group_state, gather_group, graph, result, ...).
        if name.startswith("__") or name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    def __repr__(self):
        st = "reset" if self._state is not None else "unreset"
        return (f"Simulation(engine={type(self.engine).__name__}, "
                f"kind={self.kind!r}, {st})")
