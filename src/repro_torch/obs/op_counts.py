"""Op-level counts of the work a step dispatches: FLOPs, bytes and aten
ops, as a context manager around the step (``with count() as c:
step(*args)``).  ``launch.op_analysis`` turns them into roofline terms.

  * FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
    convolutions and attention, 2 per multiply-add), forward and backward;
  * bytes from a ``TorchDispatchMode`` that adds the input and output
    bytes of every aten op that is not a view (an in-place op's output,
    being one of its inputs, once).  That is ``hlo_analysis``'s model of
    an unfused op.  Nothing here is fused, so the count is an upper bound
    on the step's HBM traffic.

The hand-written kernels are loaded through ``ctypes``, so no dispatch
mode sees them.  Each kernel module's dispatcher (``flash_attention``,
``rglru_scan``, ``slstm_scan``), on its CUDA route and while a counter
is active, calls :func:`kernel`: the launch runs outside the modes, and
the counter gains what the kernel's plain version would have counted at
the same call (``plain_counts``).  So a step counts the same through the
kernels on the card as through their plain versions.  With no counter
active a dispatcher pays one check of :data:`active`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

#: The counter that kernel dispatchers report to, or None.
active: "count | None" = None

_aten = torch.ops.aten
#: Non-view ops that move no data: allocations without a fill, and the
#: reshape ``matmul`` puts on its fresh output.
_NO_DATA = {_aten.empty.memory_format, _aten.empty_like.default,
            _aten.empty_strided.default, _aten.new_empty.default,
            _aten.new_empty_strided.default, _aten._unsafe_view.default,
            _aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Counts:
    """FLOPs, bytes and aten ops counted, and the kernel calls that
    reported their plain versions' counts (kernel -> calls)."""

    flops: int = 0
    bytes: int = 0
    ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)


class _ByteMode(TorchDispatchMode):
    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _NO_DATA:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                and not any(t is i for i in ins)]
        self.counts.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.counts.ops += 1
        return out


class count(Counts):
    """``with count() as c: step(...)``: the FLOPs, bytes and aten ops of
    everything dispatched inside, kernels included by their plain
    versions' counts (:func:`kernel`); read ``c`` after the block."""

    def __enter__(self) -> "count":
        global active
        self._flop = FlopCounterMode(display=False)
        self._bytes = _ByteMode(self)
        self._prev = active
        self._flop.__enter__()
        self._bytes.__enter__()
        active = self
        return self

    def __exit__(self, *exc) -> None:
        global active
        active = self._prev
        self._bytes.__exit__(*exc)
        self._flop.__exit__(*exc)
        self.flops += int(self._flop.get_total_flops())

    def add(self, counts: Counts, name: str) -> None:
        """A kernel call ``name`` reported ``counts``."""
        self.flops += counts.flops
        self.bytes += counts.bytes
        self.ops += counts.ops
        self.kernels[name] = self.kernels.get(name, 0) + 1


def kernel(name: str, run: Callable, plain_counts: Callable[[], Counts]):
    """Called by a kernel module's dispatcher on its CUDA route while a
    counter is :data:`active`: ``run()`` (the launch and its allocations)
    outside the modes, then the counter gains ``plain_counts()``, the
    kernel's plain version's counts at this call.  Returns ``run()``."""
    counter = active
    with _disable_current_modes():
        out = run()
        counter.add(plain_counts(), name)
    return out


# ------------------------------------------------------- plain versions' counts
def signature(t: torch.Tensor | None):
    """A tensor's part of a counts key: (shape, dtype, dim order: the
    dims by falling stride, so a transposed input stays transposed)."""
    if t is None:
        return None
    order = tuple(sorted(range(t.dim()), key=lambda i: (-t.stride(i), i)))
    return tuple(t.shape), t.dtype, order


def like(sig, device, shape=None) -> torch.Tensor | None:
    """A tensor of zeros of a :func:`signature`'s dtype and dim order on
    ``device``, of ``shape`` (the signature's where None)."""
    if sig is None:
        return None
    own, dtype, order = sig
    shape = tuple(own if shape is None else shape)
    base = torch.zeros([shape[i] for i in order], dtype=dtype, device=device)
    return base.permute([order.index(i) for i in range(len(shape))])


def run_counts(fn: Callable, *args, **kwargs) -> Counts:
    """The counts of ``fn(*args, **kwargs)`` alone, whatever counter is
    active around it."""
    with _disable_current_modes(), count() as c:
        fn(*args, **kwargs)
    return Counts(c.flops, c.bytes, c.ops)


def linear_counts(measure: Callable[[tuple], Counts], points: list[tuple],
                  target: tuple) -> Counts:
    """Counts at ``target`` by a model linear in the features of a call
    (loop trips, block pairs): ``measure(p)`` counts the plain version at
    the small call whose features are ``p``; the model
    ``c = c0 + sum_i p_i c_i`` goes exactly through the first
    ``len(target) + 1`` of ``points`` whose features are independent.
    Exact where every trip of a loop dispatches the same ops on the same
    shapes."""
    rows, got = [], []
    for p in points:
        trial = rows + [(1,) + tuple(p)]
        if np.linalg.matrix_rank(np.array(trial, dtype=float)) == len(trial):
            rows.append(trial[-1])
            got.append(measure(p))
        if len(rows) == len(target) + 1:
            break
    else:
        raise ValueError(f"no {len(target) + 1} independent points among {points}")
    solve = np.linalg.solve(np.array(rows, dtype=float),
                            np.array([[c.flops, c.bytes, c.ops] for c in got], dtype=float))
    flops, nbytes, ops = (int(round(v)) for v in
                          np.array((1,) + tuple(target), dtype=float) @ solve)
    return Counts(flops, nbytes, ops)


__all__ = ["Counts", "active", "count", "kernel", "like", "linear_counts", "run_counts",
           "signature"]
