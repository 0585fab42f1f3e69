"""The until-loop on the device, as the reference's ``jax.lax.while_loop``
(``repro.core.distributed.GraphEngine.run_until``,
``repro.core.fastgrid.RegisterGridEngine.run_until``).

``run_until`` of both engines (``distributed.GraphEngine``, which
``fused.FusedEngine`` inherits, and ``fastgrid.RegisterGridEngine``) runs
through :func:`run_until`: spans of :data:`SPAN` epochs, each epoch gated
on the device by two () tensors of the call::

    stop |= done(view) | (ran >= max_epochs)
    state = epoch(state, stop)      # leaves the state as it was where stop is set
    ran  += ~stop

— the reference's ``cond``/``body`` pair moved onto the stream.  The
predicate is checked before every epoch (and once more at a span's end,
so the host sees a stop as soon as the span that reached it ends), so a
state that is already done runs no epoch, and the stop point is the
reference's: the first epoch at which the predicate holds, within the
budget of ``max_epochs`` epochs counted from the call.

On a CUDA state one span, predicate included, is captured once into a
CUDA graph and replayed until the host reads ``stop`` set: the host waits
once a span, never once an epoch.  The graph is cached, as the reference
caches its jit, under (``cache_key`` or the predicate, ``max_epochs``,
``donate``, the span) and the addresses of the state's tensors, which the
kernels update in place: a run re-entered on the same state replays, and
so does the run after a ``Simulation.reset``, which writes the new initial
values into the same tensors; a state at new addresses (the clone that
``donate=False`` runs on, or a reset that had to build its state anew)
captures anew.  On the CPU the same span runs eagerly with the
kernels' plain versions, so the CPU tests hold the stop and budget logic
that the card replays.  :func:`host_loop` is the plain version of the
loop, the predicate read back on the host before every epoch.

A predicate must return a tensor on the state's device without reading it
back (no ``bool()``, ``.item()`` or ``.cpu()``), as a JAX predicate must
be traceable; one that reads back raises :class:`HostSyncError`.

A sharded state (``core.mesh.ShardedState``) runs here as one state: the
engine's ``enter`` gives every shard's view, its epoch runs them all and
its ``done`` combines their predicates on the device.  With every shard on
one card, one capture holds every shard's work and the cache keys on every
shard's addresses; a CUDA graph holds one card's work, so the engines
refuse shards on several cards before they get here.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable

import torch

from ..kernels import granule_step, systolic_step
from ..obs import trace as _trace
from ..obs.registry import REGISTRY
from .struct import tree_leaves

Tree = Any

#: Epochs a captured span runs between two host reads of ``stop``.  A run
#: replays at most ``SPAN`` epochs that find ``stop`` set and do nothing.
#: ``chip_smoke.py``'s sweep on the 1024x1024 systolic until-run (spans of
#: 1, 4, 8, 16 and 32 epochs) found 4 fastest.
SPAN = 4
#: Captured spans an engine keeps (the oldest goes first).
CACHE_SIZE = 4
#: The kernel wrappers an epoch may call; each counts the calls a capture
#: records (``recorded``) and the launches a replay makes (``replayed``).
_KERNELS = (granule_step, systolic_step)


class HostSyncError(RuntimeError):
    """A ``run_until`` predicate read its result back to the host."""


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def flag(done, device: torch.device) -> torch.Tensor:
    """The predicate's result as a () bool tensor on ``device``: it holds
    everywhere.  Raises :class:`HostSyncError` where a CUDA state's
    predicate gave anything but a tensor on its device."""
    if isinstance(done, torch.Tensor) and done.device == device:
        return done.all()
    if device.type == "cpu":
        return torch.as_tensor(done).all()
    raise HostSyncError(
        f"run_until's predicate returned {type(done).__name__} "
        f"{getattr(done, 'device', '')}: on a CUDA state it must return a "
        f"tensor on {device} without reading it back to the host (no bool(), "
        ".item() or .cpu()), as a JAX predicate must be traceable")


@contextlib.contextmanager
def _no_sync(device: torch.device):
    """Raise :class:`HostSyncError` where the code inside synchronizes the
    host with the card (PyTorch's sync debug mode, on CUDA only)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        raise HostSyncError(
            "run_until's predicate read a device value back to the host: it "
            "must return a device tensor without reading it back (no bool(), "
            ".item() or .cpu()), as a JAX predicate must be traceable") from e
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _span_fn(enter, leave, epoch, done, max_epochs: int, span: int, device):
    """One span of ``span`` gated epochs on ``(state, stop, ran)``."""

    def check(c, stop, ran):
        with _no_sync(device):
            flag_ = flag(done(c), device)
        stop.logical_or_(flag_ | (ran >= max_epochs))

    def run(state, stop, ran):
        c = enter(state)
        for _ in range(span):
            check(c, stop, ran)
            c = epoch(c, stop)
            ran.add_((~stop).to(ran.dtype))
        check(c, stop, ran)
        return leave(c)

    return run


class _Captured:
    """One captured span: its graph, the ``stop``/``ran`` flags it reads
    and writes, and the state addresses it was captured on.  It holds the
    span function, and so the predicate and epoch it closes over with
    every tensor they read, for as long as the graph lives, and pins the
    cache key's anchor (as the reference pins its jit's).  ``calls``:
    ``(kernel module, calls)`` of each kernel wrapper the span recorded,
    which every replay launches again."""

    def __init__(self, run, anchor, graph, stop, ran, ptrs, calls):
        self.run, self.anchor, self.graph = run, anchor, graph
        self.stop, self.ran = stop, ran
        self.ptrs, self.calls = ptrs, calls


def capture_cause(entry: _Captured | None, ptrs: tuple) -> str | None:
    """Why :func:`run_until` captures its span: ``"first"`` where the cache
    holds no entry under the key, ``"moved"`` where its entry was captured
    on state tensors at other addresses (or of other shapes or dtypes) than
    ``ptrs``, and None where the entry replays."""
    if entry is None:
        return "first"
    return "moved" if entry.ptrs != ptrs else None


def _capture(run, state, anchor, ptrs, device) -> _Captured:
    """Capture ``run`` (one span) on ``state`` into a CUDA graph whose last
    nodes copy every leaf the span left in a new tensor back into the
    state's own, so a replay reads and writes one set of addresses."""
    stop = torch.ones((), dtype=torch.bool, device=device)
    ran = torch.zeros((), dtype=torch.int32, device=device)
    dst = _tensors(state)

    def body():
        out = _tensors(run(state, stop, ran))
        if len(out) != len(dst):
            raise AssertionError("the span changed the state's structure")
        for d, s in zip(dst, out):
            if s.data_ptr() != d.data_ptr():
                d.copy_(s)

    # the warm-up, eager on a side stream as PyTorch's recipe has it, with
    # stop set: every epoch in it launches its kernels, which leave the
    # state as it was
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            body()
    finally:
        torch.cuda.current_stream(device).wait_stream(side)

    # Python's collector stays off while the stream captures: a graph it
    # frees then (an engine dropped in a reference cycle) would return its
    # memory with a call that the capture does not permit
    graph = torch.cuda.CUDAGraph()
    before = [m.recorded for m in _KERNELS]
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            body()
    except HostSyncError:
        raise
    except RuntimeError as e:
        raise RuntimeError(f"capturing run_until's span failed: {e}") from e
    finally:
        if collecting:
            gc.enable()
    calls = [(m, m.recorded - b) for m, b in zip(_KERNELS, before) if m.recorded > b]
    return _Captured(run, anchor, graph, stop, ran, ptrs, calls)


def run_until(cache: dict, state: Tree, *, epoch: Callable, done: Callable,
              max_epochs: int, anchor: Any, donate: bool,
              enter: Callable = lambda s: s,
              leave: Callable = lambda c: c) -> Tree:
    """Run gated epochs of ``state`` until ``done`` holds or ``max_epochs``
    epochs ran, on the state's device.

    ``enter(state)`` is the view the epochs run on and ``leave`` its
    inverse; ``epoch(view, stop)`` is one epoch gated by the () bool
    ``stop``; ``done(view)`` the predicate, a bool tensor on the device.
    ``cache`` (the engine's) holds the captured spans; ``anchor`` is the
    object the cache key pins (``cache_key`` or the predicate).  A replay
    runs the predicate that was captured, as the reference's jit runs the
    first predicate it traced under a key.  On a CUDA state the state's
    tensors are updated in place and the state itself is returned; a
    state at new addresses (an engine's ``donate=False`` clone of its
    input, or a ``reset`` that built a new state) captures its span anew.

    Counters: ``until.epochs`` (epochs run), ``until.spans`` (spans run or
    replayed), ``until.host_syncs`` (host reads of the card),
    ``until.captures``, split by :func:`capture_cause` into
    ``until.captures.first`` and ``until.captures.moved``, and
    ``until.capture_s``; each kernel wrapper counts its own launches, a
    replay's through the module's ``replayed``.  A capture is traced as an
    ``until.capture`` span (``obs.trace``) with its ``cause``: the old
    entry's graph released, the warm-up and the capture."""
    span, max_epochs = int(SPAN), int(max_epochs)
    if span < 1:
        raise ValueError(f"SPAN must be at least 1, got {span}")
    leaves = _tensors(state)
    device = leaves[0].device
    run = _span_fn(enter, leave, epoch, done, max_epochs, span, device)
    if device.type != "cuda":
        stop = torch.zeros((), dtype=torch.bool, device=device)
        ran = torch.zeros((), dtype=torch.int32, device=device)
        spans = 0
        while True:
            state = run(state, stop, ran)
            spans += 1
            if bool(stop):
                break
        _count(spans, int(ran))
        return state

    key = (id(anchor), max_epochs, bool(donate), span)
    ptrs = tuple((x.data_ptr(), tuple(x.shape), x.dtype) for x in leaves)
    entry = cache.get(key)
    cause = capture_cause(entry, ptrs)
    if cause is not None:
        with _trace.recorder().session_span("until.capture", cause=cause):
            cache.pop(key, None)  # its graph's memory goes before the next capture
            while len(cache) >= CACHE_SIZE:
                cache.pop(next(iter(cache)))
            t0 = time.perf_counter()
            entry = cache[key] = _capture(run, state, anchor, ptrs, device)
        REGISTRY.inc("until.captures")
        REGISTRY.inc(f"until.captures.{cause}")
        REGISTRY.observe("until.capture_s", time.perf_counter() - t0)
    entry.stop.zero_()
    entry.ran.zero_()
    spans = 0
    while True:
        entry.graph.replay()
        for kernel, calls in entry.calls:
            kernel.replayed(calls)
        spans += 1
        if bool(entry.stop):
            break
    _count(spans, int(entry.ran))
    return state


def _count(spans: int, epochs: int) -> None:
    REGISTRY.inc("until.epochs", float(epochs))
    REGISTRY.inc("until.spans", float(spans))
    REGISTRY.inc("until.host_syncs", float(spans + 1))  # and the read of ran


def host_loop(state: Tree, *, epoch: Callable, done: Callable,
              max_epochs: int, enter: Callable = lambda s: s,
              leave: Callable = lambda c: c) -> Tree:
    """The plain version of :func:`run_until`: the predicate read back on
    the host before every epoch, the epochs ungated."""
    c, ran = enter(state), 0
    while ran < max_epochs:
        REGISTRY.inc("until.host_syncs")
        if bool(torch.as_tensor(done(c)).all()):
            break
        c = epoch(c, None)
        ran += 1
    REGISTRY.inc("until.epochs", float(ran))
    return leave(c)


__all__ = ["CACHE_SIZE", "HostSyncError", "SPAN", "capture_cause", "flag", "host_loop",
           "run_until"]
