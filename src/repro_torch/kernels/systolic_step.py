"""K cycles of a tile of systolic MAC cells, as in
``repro.kernels.systolic_step`` (the Pallas kernel) and
``repro.kernels.ref.systolic_step_ref`` (its oracle).

A tile of (R, C) MAC cells with *depth-1 elastic register* channels: each
cell owns one eastward register (``a_reg``/``a_v``) and one southward
register (``p_reg``/``p_v``).  A cell fires when both inputs are valid and
both of its own registers are free (or it sits on a sink edge); firing
latches its outputs into its registers, which the downstream cells consume
on a later cycle.  Tile boundaries are *slabs* (the epoch exchange unit):

  west_slab (R, W)/west_cnt   packets available to column 0 this call,
  north_slab (C, W)/north_cnt packets available to row 0,
  east_slab (R, W)/east_cnt   packets emitted by column C-1 (at most
                              ``east_limit`` of them),
  south_slab (C, W)/south_cnt packets emitted by row R-1.

Edge-of-grid behaviour comes from per-cell flags: ``is_west`` cells stream
from ``a_buf``, ``is_north`` cells synthesize 0, ``is_south`` cells collect
into ``y_buf``, ``is_east`` cells drop.  ``widx``/``nidx`` (slab read
positions) start at 0 and the egress slabs start empty on every call; the
egress slabs are as wide as ``west_slab``.

Every tensor may carry the same leading tile dimensions (the register
engine stacks its ``(Dr, Dc)`` tiles there); tiles are independent within a
call.  :func:`systolic_step` dispatches by device:

  * CPU tensors go to :func:`systolic_step_ref`, the plain PyTorch version,
    which follows the reference's op order with its one-hot sums and the
    same fused multiply-add (``hw.systolic.mac``);
  * CUDA tensors go to :func:`systolic_step_cuda`, the hand-written Hopper
    kernel ``csrc/systolic_step.cu``, or raise.  Nothing falls back.  The
    kernel runs a call as ``ceil(K / k)`` launches, each of which keeps a
    window of cells (a block and a halo of k cells) in shared memory for k
    cycles; :func:`tile_plan` chooses the block and k.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..hw.systolic import mac
from ..obs.registry import REGISTRY
from ._build import tensor_ptr

#: Calls of the CUDA kernel: one per :func:`systolic_step_cuda` call,
#: which runs all K cycles in ``tile_plan(...).launches`` launches, and one
#: per call a CUDA graph recorded each time that graph is replayed
#: (:func:`replayed`).  A plain integer, so a run can show that its main
#: path went through the kernel; set it to 0 before the run.
launches = 0
#: Calls made while the stream was capturing a CUDA graph: they launch
#: nothing until the graph is replayed.
recorded = 0


def replayed(calls: int) -> None:
    """Count ``calls`` recorded calls that a replay of their graph launched."""
    global launches
    launches += calls
    REGISTRY.inc("systolic_step.launches", float(calls))

#: Per-cell leaves the call returns updated, and the fresh per-row/column
#: outputs; with the inputs these are the keys of the returned dict.
CELL_OUT = ("a_reg", "a_v", "p_reg", "p_v", "a_idx", "y_idx", "y_buf")
EDGE_OUT = ("widx", "nidx", "east_slab", "east_cnt", "south_slab", "south_cnt")


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) f32 one-hot of ``idx`` (an index outside [0, n) is all 0)."""
    return (idx[..., None] == torch.arange(n, dtype=idx.dtype, device=idx.device)
            ).to(torch.float32)


def _limits(state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """East/south emission limits; the slab width when the state has none."""
    b, ws = state["b"], state["west_slab"]
    W = ws.shape[-1]
    lead, (R, C) = b.shape[:-2], b.shape[-2:]
    full = lambda n: torch.full(lead + (n,), W, dtype=torch.int32,  # noqa: E731
                                device=b.device)
    return (state["east_limit"] if "east_limit" in state else full(R),
            state["south_limit"] if "south_limit" in state else full(C))


# ------------------------------------------------------- the plain version
def systolic_step_ref(state: dict, k_cycles: int,
                      stop: torch.Tensor | None = None) -> dict:
    """Run ``k_cycles`` cycles with plain PyTorch ops; returns a new dict
    (the input is untouched).  The reference's op order throughout: one-hot
    sums for the stream gather, the slab reads and the output scatters.
    Where ``stop`` (a () bool tensor, the until-loop's flag) is set, the
    cells come back bit for bit as they went in and the slabs carry no
    packets."""
    s = dict(state)
    b = s["b"]
    lead, (R, C) = b.shape[:-2], b.shape[-2:]
    M = s["a_buf"].shape[-1]
    W = s["west_slab"].shape[-1]
    dev = b.device
    zi = lambda *shape: torch.zeros(lead + shape, dtype=torch.int32,  # noqa: E731
                                    device=dev)
    e_lim, s_lim = _limits(s)
    is_w, is_n, is_s, is_e = s["is_west"], s["is_north"], s["is_south"], s["is_east"]
    a_reg, a_v, p_reg, p_v = s["a_reg"], s["a_v"], s["p_reg"], s["p_v"]
    a_idx, y_idx, y_buf = s["a_idx"], s["y_idx"], s["y_buf"]
    widx, nidx = zi(R), zi(C)
    east_slab = torch.zeros(lead + (R, W), dtype=torch.float32, device=dev)
    south_slab = torch.zeros(lead + (C, W), dtype=torch.float32, device=dev)
    east_cnt, south_cnt = zi(R), zi(C)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    no_r = torch.zeros(lead + (R, 1), dtype=torch.bool, device=dev)
    no_c = torch.zeros(lead + (1, C), dtype=torch.bool, device=dev)

    for _ in range(k_cycles):
        # West input of cell (r, c): c>0 -> neighbour register; c==0 -> slab.
        w_slab_val = (s["west_slab"] * _onehot(widx, W)).sum(-1)
        w_slab_ok = widx < s["west_cnt"]
        w_val = torch.cat([w_slab_val[..., None], a_reg[..., :-1]], -1)
        w_vld = torch.cat([w_slab_ok[..., None], a_v[..., :-1]], -1)
        n_slab_val = (s["north_slab"] * _onehot(nidx, W)).sum(-1)
        n_slab_ok = nidx < s["north_cnt"]
        n_val = torch.cat([n_slab_val[..., None, :], p_reg[..., :-1, :]], -2)
        n_vld = torch.cat([n_slab_ok[..., None, :], p_v[..., :-1, :]], -2)

        a_src = (s["a_buf"] * _onehot(a_idx, M)).sum(-1)
        a_in = torch.where(is_w, a_src, w_val)
        a_ok = torch.where(is_w, a_idx < M, w_vld)
        p_in = torch.where(is_n, zero, n_val)
        p_ok = is_n | n_vld

        # Output readiness: own register free, or edge/boundary sink.
        e_free = ~a_v
        e_free[..., :, C - 1] = east_cnt < e_lim
        e_free = e_free | is_e
        s_free = ~p_v
        s_free[..., R - 1, :] = south_cnt < s_lim
        s_free = s_free | is_s

        fire = a_ok & p_ok & e_free & s_free
        y = mac(p_in, a_in, b)

        # Drain consumed upstream storage.
        cons_a = fire & ~is_w
        cons_p = fire & ~is_n
        widx = widx + cons_a[..., :, 0].to(torch.int32)
        nidx = nidx + cons_p[..., 0, :].to(torch.int32)
        drain_a = torch.cat([cons_a[..., :, 1:], no_r], -1)
        drain_p = torch.cat([cons_p[..., 1:, :], no_c], -2)
        a_v2 = a_v & ~drain_a
        p_v2 = p_v & ~drain_p

        # Latch fired outputs; column C-1 / row R-1 emit into slabs.
        emit_e = fire & ~is_e
        emit_s = fire & ~is_s
        a_reg = torch.where(fire, a_in, a_reg)
        p_reg = torch.where(fire, y, p_reg)
        to_east = emit_e[..., :, C - 1]
        to_south = emit_s[..., R - 1, :]
        a_v = emit_e | a_v2
        a_v[..., :, C - 1] = a_v2[..., :, C - 1]
        p_v = emit_s | p_v2
        p_v[..., R - 1, :] = p_v2[..., R - 1, :]
        east_slab = east_slab + (
            a_in[..., :, C - 1, None] * _onehot(east_cnt, W)) * to_east[..., None]
        east_cnt = east_cnt + to_east.to(torch.int32)
        south_slab = south_slab + (
            y[..., R - 1, :, None] * _onehot(south_cnt, W)) * to_south[..., None]
        south_cnt = south_cnt + to_south.to(torch.int32)

        collect = fire & is_s
        y_buf = y_buf + (y[..., None] * _onehot(y_idx, M)) * collect[..., None]
        a_idx = a_idx + (fire & is_w).to(torch.int32)
        y_idx = y_idx + collect.to(torch.int32)

    s.update(a_reg=a_reg, a_v=a_v, p_reg=p_reg, p_v=p_v, a_idx=a_idx,
             y_idx=y_idx, y_buf=y_buf, widx=widx, nidx=nidx,
             east_slab=east_slab, east_cnt=east_cnt,
             south_slab=south_slab, south_cnt=south_cnt)
    if stop is not None:
        s.update({k: torch.where(stop, state[k], s[k]) for k in CELL_OUT})
        s.update({k: torch.where(stop, torch.zeros_like(s[k]), s[k])
                  for k in EDGE_OUT})
    return s


def systolic_step(state: dict, k_cycles: int,
                  stop: torch.Tensor | None = None) -> dict:
    """Run ``k_cycles`` cycles of every tile on the state's device: the
    plain version on the CPU, the Hopper kernel on CUDA (which overwrites
    the per-cell tensors of ``state``).  Where ``stop`` is set the call
    leaves the cells as they were."""
    device = state["b"].device
    if device.type == "cpu":
        return systolic_step_ref(state, k_cycles, stop)
    if device.type == "cuda":
        return systolic_step_cuda(state, k_cycles, stop=stop)
    raise ValueError(f"no systolic_step for device {device}")


# ------------------------------------------------------------- the kernel
#: Shared memory a CTA may use on Hopper (232,448 B of an SM's 256 KB).
SMEM_LIMIT = 232_448
#: Cycles a launch and block shape of the plan at a tile larger than one
#: block.
PLAN_K = 8
PLAN_BLOCK = (64, 64)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How ``csrc/systolic_step.cu`` runs a call: CTAs of ``block`` cells
    (rows, columns) of a tile, each keeping its block and a halo of ``k``
    cells in shared memory (``smem`` bytes) for ``k`` cycles a launch;
    a call of ``K`` cycles is ``launches`` launches."""

    block: tuple
    k: int
    smem: int
    launches: int


def window_smem(R: int, C: int, block: tuple, k: int) -> int:
    """Shared-memory bytes of a launch (the kernel's ``window_smem``): the
    largest window, ``min(R, br + 2k)`` rows of ``min(C, bc + 2k)`` cells,
    each row 3 slots more rounded up to a multiple of 4 (so the interior
    falls into aligned groups of 4), at 26 B a slot (``a_reg``, ``p_reg``,
    ``b``, ``a_in``, ``y``, ``a_idx``, the packed flags and the fire byte),
    plus four int32 counters a window row and column."""
    wr, wc = min(R, block[0] + 2 * k), min(C, block[1] + 2 * k)
    return wr * ((wc + 6) // 4 * 4) * 26 + (2 * wr + 2 * wc) * 4


@functools.lru_cache(maxsize=None)
def tile_plan(R: int, C: int, K: int, *, k: int | None = None,
              block: tuple | None = None) -> TilePlan:
    """The plan of a call of ``K`` cycles on ``R x C`` tiles.

    By default a tile that fits in one CTA with no halo is one block run
    for all K cycles in one launch; a larger tile is cut into blocks of up
    to ``PLAN_BLOCK`` cells run ``PLAN_K`` cycles a launch.  ``k`` and
    ``block`` override those choices (the k sweep, tests).  The block is
    halved (its longer side first) until the window fits in
    ``SMEM_LIMIT``; k is never cut below what was asked, and a plan that
    cannot fit raises ``ValueError``."""
    if min(R, C) < 1 or K < 0:
        raise ValueError(f"no plan for R={R} C={C} K={K}")
    if block is None and k is None and window_smem(R, C, (R, C), 0) <= SMEM_LIMIT:
        block, k = (R, C), max(K, 1)
    if k is None:
        k = min(max(K, 1), PLAN_K)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    br, bc = block or PLAN_BLOCK
    br, bc = min(br, R), min(bc, C)
    if min(br, bc) < 1:
        raise ValueError(f"empty block {block}")
    while window_smem(R, C, (br, bc), k) > SMEM_LIMIT:
        if max(br, bc) == 1:
            raise ValueError(f"no block fits k={k} in {SMEM_LIMIT} B of shared memory")
        if br >= bc:
            br = (br + 1) // 2
        else:
            bc = (bc + 1) // 2
    return TilePlan(block=(br, bc), k=k, smem=window_smem(R, C, (br, bc), k),
                    launches=-(-K // k))


_PAIRED = ("a_reg", "a_v", "p_reg", "p_v", "a_idx", "widx", "nidx",
           "east_cnt", "south_cnt")
_SINGLE = ("b", "is_west", "is_north", "is_south", "is_east", "a_buf",
           "y_buf", "y_idx", "west_slab", "west_cnt", "north_slab",
           "north_cnt", "east_limit", "south_limit", "east_slab",
           "south_slab", "stop")
_INTS = ("T", "R", "C", "M", "W")


class _StepArgs(ctypes.Structure):
    """``StepArgs`` of ``csrc/systolic_step.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p * 2) for n in _PAIRED]
                + [(n, ctypes.c_void_p) for n in _SINGLE]
                + [(n, ctypes.c_int32) for n in _INTS])


def _library():
    from . import _build

    lib = _build.load("systolic_step")
    if lib.systolic_step.argtypes is None:
        lib.systolic_step.argtypes = [ctypes.POINTER(_StepArgs)] + [
            ctypes.c_int] * 4 + [ctypes.c_int64, ctypes.c_void_p]
        lib.systolic_step.restype = ctypes.c_int
        lib.systolic_mac.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                                             ctypes.c_void_p]
        lib.systolic_mac.restype = ctypes.c_int
    return lib


def systolic_step_cuda(state: dict, k_cycles: int,
                       plan: TilePlan | None = None,
                       stop: torch.Tensor | None = None) -> dict:
    """Run ``csrc/systolic_step.cu`` on the current stream: ``k_cycles``
    cycles of every tile in ``plan.launches`` launches (``plan`` defaults
    to :func:`tile_plan`).  Returns a new dict with the updated per-cell
    leaves (``a_reg``, ``a_v``, ``p_reg``, ``p_v``, ``a_idx``, ``y_idx``,
    ``y_buf``) and fresh ``widx``/``nidx`` and egress slabs.  The kernel
    overwrites those leaves of ``state``: ``y_idx`` and ``y_buf`` are
    updated in place, the double-buffered ones end in the input tensor
    after an even number of launches and in a new one after an odd.  Every
    launch reads ``stop`` (a () bool tensor) first; where it is set the
    launch carries the cells to the other buffer unchanged, so the call
    returns its input state and empty slabs.  Raises for anything the
    kernel does not take."""
    global launches, recorded
    b = state["b"]
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"systolic_step_cuda needs CUDA tensors, got {dev}")
    if b.dim() < 2:
        raise ValueError(f"b: expected (..., R, C), got {tuple(b.shape)}")
    lead, (R, C) = tuple(b.shape[:-2]), tuple(b.shape[-2:])
    M = state["a_buf"].shape[-1]
    W = state["west_slab"].shape[-1]
    if min(R, C, M, W) < 1 or k_cycles < 0:
        raise ValueError(f"empty tile or slab: R={R} C={C} M={M} W={W}, "
                         f"k_cycles={k_cycles}")
    if plan is None:
        plan = tile_plan(R, C, int(k_cycles))
    if plan.launches != -(-int(k_cycles) // plan.k):
        raise ValueError(f"{plan} does not run {k_cycles} cycles")
    e_lim, s_lim = _limits(state)
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    cell, cm = lead + (R, C), lead + (R, C, M)
    shapes = {
        "b": (f32, cell), "is_west": (u8, cell), "is_north": (u8, cell),
        "is_south": (u8, cell), "is_east": (u8, cell), "a_buf": (f32, cm),
        "y_buf": (f32, cm), "y_idx": (i32, cell),
        "west_slab": (f32, lead + (R, W)), "west_cnt": (i32, lead + (R,)),
        "north_slab": (f32, lead + (C, W)), "north_cnt": (i32, lead + (C,)),
        "a_reg": (f32, cell), "a_v": (u8, cell), "p_reg": (f32, cell),
        "p_v": (u8, cell), "a_idx": (i32, cell),
    }
    ptr = {k: tensor_ptr(state[k], k, dt, shp, dev) for k, (dt, shp) in shapes.items()}
    ptr["east_limit"] = tensor_ptr(e_lim, "east_limit", i32, lead + (R,), dev)
    ptr["south_limit"] = tensor_ptr(s_lim, "south_limit", i32, lead + (C,), dev)
    ptr["stop"] = None if stop is None else tensor_ptr(stop, "stop", u8, (), dev)

    zeros = lambda dt, *shape: torch.zeros(lead + shape, dtype=dt, device=dev)  # noqa: E731
    out = {
        "widx": zeros(i32, R), "nidx": zeros(i32, C),
        "east_cnt": zeros(i32, R), "south_cnt": zeros(i32, C),
        "east_slab": zeros(f32, R, W), "south_slab": zeros(f32, C, W),
    }
    ptr["east_slab"] = out["east_slab"].data_ptr()
    ptr["south_slab"] = out["south_slab"].data_ptr()
    # the second buffer of every leaf another CTA reads at a launch's
    # start: launch j reads buffer j % 2 and writes the other, so the
    # results sit in buffer plan.launches % 2.  Freeing the other when this
    # returns is safe: the caching allocator reuses its memory only for
    # later work on the same stream.
    pair = {}
    for k in _PAIRED:
        first = state[k] if k in CELL_OUT else out[k]
        pair[k] = (first, torch.empty_like(first))
    args = _StepArgs(
        **{k: (ctypes.c_void_p * 2)(p.data_ptr(), q.data_ptr())
           for k, (p, q) in pair.items()},
        **{k: p for k, p in ptr.items() if k not in pair},
        T=math.prod(lead), R=R, C=C, M=M, W=W,
    )
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.systolic_step(ctypes.byref(args), int(k_cycles),
                               plan.block[0], plan.block[1], plan.k, plan.smem,
                               ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"systolic_step kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        recorded += 1  # launched by each replay of the graph
    else:
        launches += 1
        REGISTRY.inc("systolic_step.launches")
    new = dict(state)  # y_idx and y_buf were updated in place
    new.update({k: p[plan.launches & 1] for k, p in pair.items()})
    new.update(east_slab=out["east_slab"], south_slab=out["south_slab"])
    return new


def mac_cuda(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's MAC (``__fmaf_rn``) on flat f32 CUDA tensors — for
    holding ``hw.systolic.mac`` against the kernel's arithmetic."""
    n = p.numel()
    dev = p.device
    ptrs = [tensor_ptr(x, name, torch.float32, (n,), dev)
            for x, name in ((p, "p"), (a, "a"), (b, "b"))]
    out = torch.empty_like(p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().systolic_mac(*ptrs, out.data_ptr(), n,
                                     ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"systolic_mac kernel launch failed: CUDA error {rc}")
    return out


__all__ = ["TilePlan", "launches", "mac_cuda", "systolic_step",
           "systolic_step_cuda", "systolic_step_ref", "tile_plan", "window_smem"]
