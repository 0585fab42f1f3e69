"""The fused engine's resident epoch program, as in
``repro.kernels.granule_step``.

The fused engine (``repro_torch.core.fused``) runs an epoch as a flat op
program: ``("C", n)`` steps its cycle body ``n`` cycles, ``("X", t)``
exchanges tier ``t``'s boundary queues, and ``("XI", t)`` / ``("XC", t)``
are the issue and commit halves of that exchange (see
:func:`overlap_program`).  :func:`epoch_program` runs such a program:

  * on CPU tensors, the plain PyTorch version :func:`epoch_program_ref`,
    which walks the program calling the engine's Python cycle and
    exchange functions — generic over block types;
  * on CUDA tensors, the hand-written Hopper kernel
    ``csrc/granule_step.cu``.  A kernel cannot trace a Python cycle
    function as Pallas does, so it carries the fused cycle itself and
    each block type's step as a device function: one launch a cycle, in
    which each slot steps and commits the channel ends it owns (the
    registers it produces, with the consumer's readiness recomputed
    through :func:`consumer_table`; the boundary rows it pushes or pops),
    and the credit-bounded slab exchange between cycles.  ``ManycoreCell``,
    ``SystolicCell`` and ``PipeStage`` have a device step
    (:func:`device_step_type`); a program of up to :data:`MAX_GROUPS`
    groups of them, of any type and mix, runs in one launch a cycle, each
    group on its own warps.  Any other block type raises
    ``NotImplementedError`` on a CUDA state.
    The kernel updates the carry's tensors in place and returns the same
    carry.

Nothing falls back: a CUDA carry either launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..core.struct import static_field, tensor_dataclass, tree_map
from ..obs.registry import REGISTRY
from ._build import tensor_ptr

Tree = Any

#: Op list executed by :func:`epoch_program`: ``("C", n)`` runs ``n``
#: cycles of the cycle body; ``("X", t)`` runs tier ``t``'s exchange;
#: ``("XI", t)`` / ``("XC", t)`` are its issue and commit halves.
Program = Sequence[Tuple[str, int]]

_OPCODES = {"C": 0, "X": 1, "XI": 2, "XC": 3}

#: Launches of the CUDA program kernel: one per :func:`epoch_program`
#: call on a CUDA carry, and one per call a CUDA graph recorded each time
#: that graph is replayed (:func:`replayed`).  A plain integer, so a run
#: can show that its main path went through the kernel; set it to 0
#: before the run.
launches = 0
#: Calls made while the stream was capturing a CUDA graph: they launch
#: nothing until the graph is replayed.
recorded = 0


def replayed(calls: int) -> None:
    """Count ``calls`` recorded calls that a replay of their graph launched."""
    global launches
    launches += calls
    REGISTRY.inc("granule_step.launches", float(calls))


def resolve_overlap(overlap: Any = "auto") -> bool:
    """Resolve the overlapped-exchange knob (split issue/commit phases).

    An explicit non-"auto" argument (bool, or one of
    ``on|off|1|0|true|false``) always wins; the environment variable
    ``REPRO_OVERLAP`` overrides a caller-passed ``"auto"``; "auto" resolves
    to off.  The split schedule is bit-identical by construction.
    """
    def parse(v: Any, src: str) -> bool:
        if isinstance(v, bool):
            return v
        s = str(v).strip().lower()
        if s in ("1", "on", "true", "yes"):
            return True
        if s in ("0", "off", "false", "no"):
            return False
        raise ValueError(f"{src}={v!r} not a boolean (on|off|1|0|auto)")

    if not (isinstance(overlap, str) and overlap.strip().lower() == "auto"):
        return parse(overlap, "overlap")
    env = os.environ.get("REPRO_OVERLAP", "auto").strip().lower()
    if env and env != "auto":
        return parse(env, "REPRO_OVERLAP")
    return False


def overlap_program(program: Program) -> Program:
    """Rewrite a serial op program into the split-exchange schedule.

    Every maximal run of consecutive ``("X", t)`` ops — the tiers firing
    at one sync boundary — becomes all their issues followed by all their
    commits: ``X_a, X_b -> XI_a, XI_b, XC_a, XC_b``.  Drains touch only
    egress queues and fills only ingress queues, and each tier's credits
    are its own, so the reorder is bit-safe: every tier's drain still
    precedes its own fill, and every fill still precedes the first cycle
    that could pop its packets.
    """
    out: list[Tuple[str, int]] = []
    run: list[int] = []

    def flush() -> None:
        out.extend(("XI", t) for t in run)
        out.extend(("XC", t) for t in run)
        run.clear()

    for op, arg in program:
        if op == "X":
            run.append(arg)
        else:
            flush()
            out.append((op, arg))
    flush()
    return tuple(out)


def validate_program(program: Program) -> Tuple[Tuple[str, int], ...]:
    """Normalize + statically validate an op program.

    Checks the op vocabulary and the split-exchange pairing discipline:
    every ``("XI", t)`` must be followed by exactly one ``("XC", t)``
    before the tier issues again, and the program must end with every
    issue committed.
    """
    program = tuple((op, int(arg)) for op, arg in program)
    pending: set = set()
    for op, arg in program:
        if op not in _OPCODES:
            raise ValueError(f"unknown program op {op!r} (C|X|XI|XC)")
        if op == "XI":
            if arg in pending:
                raise ValueError(
                    f"tier {arg} issued twice without an intervening commit")
            pending.add(arg)
        elif op == "XC":
            if arg not in pending:
                raise ValueError(f"tier {arg} committed with no pending issue")
            pending.remove(arg)
        elif op == "X" and arg in pending:
            raise ValueError(
                f"tier {arg} has a serial exchange while a split one is "
                f"pending")
    if pending:
        raise ValueError(
            f"program ends with uncommitted exchanges for tiers "
            f"{sorted(pending)}")
    return program


@tensor_dataclass
class ProgramConsts:
    """Read-only tables of a resident program, in the flat local layout.

    Port tables use combined channel ids: ``[0, n_reg)`` registers (row
    b's at ``b * n_reg_row + c``), then queue rows (row b's at
    ``n_reg + b * n_q + k``).  Exchange tables are ``(B, S_t)`` per tier.
    """

    rx_idx: tuple  # per group: (B*n_slot, n_in) int32
    tx_idx: tuple  # per group: (B*n_slot, n_out) int32
    inv_tx: torch.Tensor  # (B*(n_reg_row + n_q),) int32
    inv_tx_mask: torch.Tensor  # bool
    inv_rx: torch.Tensor
    inv_rx_mask: torch.Tensor
    send_idx: tuple  # per tier: (B, S_t) int32 queue row within the batch row
    send_mask: tuple
    recv_idx: tuple
    recv_mask: tuple
    bat_fwd: tuple  # per tier: (B, S_t) int32 source batch row
    bat_rev: tuple
    cons: Any = None  # per group: (B*n_slot, 2) int32 consumer table (CUDA only)
    blocks: tuple = static_field(default=())  # per group: the Block
    depths: tuple = static_field(default=())  # per tier: slab depth E_t
    n_q: int = static_field(default=1)  # queue rows per batch row


# ------------------------------------------------------- the plain version
def epoch_program_ref(
    cycle_fn: Callable[..., Tree],
    carry: Tree,
    program: Program,
    *,
    exchange_fn: Callable[..., Tree] | None = None,
    issue_fn: Callable[..., Tuple[Tree, Tree]] | None = None,
    commit_fn: Callable[..., Tree] | None = None,
    consts: Tree | None = None,
    stop: torch.Tensor | None = None,
) -> Tree:
    """Run an op program with plain PyTorch ops — the reference the
    kernel is held against.

    ``cycle_fn(carry, consts)`` steps one cycle; ``exchange_fn(carry, t,
    consts)`` runs tier ``t``'s serial exchange; ``issue_fn(carry, t,
    consts) -> (carry, pending)`` and ``commit_fn(carry, t, pending,
    consts)`` are its halves.  ``stop`` (a () bool tensor, the until-loop's
    flag) gates the program: where it is set the carry comes back bit for
    bit as it went in.  Functional: the input carry is untouched.
    """
    program = validate_program(program)
    if any(op == "X" for op, _ in program) and exchange_fn is None:
        raise ValueError("program has ('X', t) ops but no exchange_fn")
    if any(op in ("XI", "XC") for op, _ in program) and (
            issue_fn is None or commit_fn is None):
        raise ValueError(
            "program has split ('XI'/'XC') ops but no issue_fn/commit_fn")
    out = carry
    pending: dict = {}
    for op, arg in program:
        if op == "C":
            for _ in range(arg):
                out = cycle_fn(out, consts)
        elif op == "X":
            out = exchange_fn(out, arg, consts)
        elif op == "XI":
            out, pending[arg] = issue_fn(out, arg, consts)
        else:  # "XC"
            out = commit_fn(out, arg, pending.pop(arg), consts)
    if stop is not None:
        out = tree_map(lambda new, old: torch.where(stop, old, new), out, carry)
    return out


def epoch_program(
    cycle_fn: Callable[..., Tree],
    carry: Tree,
    program: Program,
    *,
    exchange_fn: Callable[..., Tree] | None = None,
    issue_fn: Callable[..., Tuple[Tree, Tree]] | None = None,
    commit_fn: Callable[..., Tree] | None = None,
    consts: ProgramConsts,
    stop: torch.Tensor | None = None,
) -> Tree:
    """Run a resident op program on the carry's device.

    ``carry`` is the fused engine's ``(reg_val, reg_v, queues,
    block_states, cycle, credits)``.  On the CPU this is
    :func:`epoch_program_ref`; on a CUDA device the Hopper kernel, which
    updates the carry's tensors in place (the callables are not used
    there: the kernel carries the cycle and exchange itself).  Where
    ``stop`` (a () bool tensor on the carry's device) is set, the program
    leaves the carry as it was.
    """
    device = carry[0].device
    if device.type == "cpu":
        return epoch_program_ref(
            cycle_fn, carry, program, exchange_fn=exchange_fn,
            issue_fn=issue_fn, commit_fn=commit_fn, consts=consts, stop=stop,
        )
    if device.type == "cuda":
        return epoch_program_cuda(carry, program, consts, stop)
    raise ValueError(f"no epoch program for device {device}")


# ------------------------------------------------------------- the kernel
def consumer_table(tx_tables, inv_tx, inv_tx_mask, inv_rx, inv_rx_mask,
                   n_reg: int):
    """The kernel's consumer tables: for each group, ``(n_slot, n_out)``
    int32, the flat consumer of the channel each output port drives — the
    inverse map's id, ``in_base + slot * n_in + port`` with the groups'
    in ports laid end to end in group order, so the consumer may sit in
    another group — -1 where that channel has no local consumer (a
    boundary or external queue row), -2 where the port drives no channel
    (a sentinel).  Arguments are the flat tables (numpy, any leading size-1
    dims): ``tx_tables`` one ``(n_slot, n_out)`` port table per group and
    the inverse maps over the combined ids.

    Raises ``NotImplementedError`` for a queue row with a local producer
    and a local consumer (the kernel commits each row on its one local
    side), and ``ValueError`` where a port's channel names another
    producer."""
    inv_tx = np.asarray(inv_tx).reshape(-1).astype(np.int64)
    inv_rx = np.asarray(inv_rx).reshape(-1).astype(np.int64)
    tx_m = np.asarray(inv_tx_mask).reshape(-1).astype(bool)
    rx_m = np.asarray(inv_rx_mask).reshape(-1).astype(bool)
    both = np.nonzero(tx_m[n_reg:] & rx_m[n_reg:])[0]
    if both.size:
        raise NotImplementedError(
            f"queue rows {both[:8].tolist()} have a local producer and a local "
            "consumer: the CUDA cycle commits each boundary row on its one "
            "local side")
    out, off = [], 0
    for tbl in tx_tables:
        tx = np.asarray(tbl).reshape(np.asarray(tbl).shape[-2:]).astype(np.int64)
        n_slot, n_out = tx.shape
        own = off + np.arange(n_slot * n_out).reshape(n_slot, n_out)
        off += n_slot * n_out
        driven = tx_m[tx]
        if not (inv_tx[tx] == own)[driven].all():
            raise ValueError("a port's channel names another producer (not SPSC)")
        cons = np.where(rx_m[tx], inv_rx[tx], -1)
        out.append(np.where(driven, cons, -2).astype(np.int32))
    return tuple(out)


#: Most groups one CUDA program steps (``kMaxGroups`` of the kernel).
MAX_GROUPS = 4
_PTR, _PAIR, _I32 = ctypes.c_void_p, ctypes.c_void_p * 2, ctypes.c_int32


class _CoreLeaves(ctypes.Structure):
    """``CoreLeaves`` of ``csrc/granule_step.cu`` (``ManycoreCell``)."""

    _fields_ = [("own", _PTR), ("acc", _PTR), ("total", _PTR),
                ("phase", _PAIR), ("sent", _PAIR), ("rcvd", _PAIR),
                ("fwd", _PTR), ("fwd_v", _PAIR), ("fires", _PTR),
                ("R", _I32), ("C", _I32)]


class _CellLeaves(ctypes.Structure):
    """``CellLeaves`` of ``csrc/granule_step.cu`` (``SystolicCell``)."""

    _fields_ = [("b", _PTR), ("is_west", _PTR), ("is_north", _PTR),
                ("is_south", _PTR), ("is_east", _PTR), ("a_buf", _PTR),
                ("a_idx", _PAIR), ("y_buf", _PTR), ("y_idx", _PTR),
                ("fires", _PTR), ("M", _I32)]


class _PipeLeaves(ctypes.Structure):
    """``PipeLeaves`` of ``csrc/granule_step.cu`` (``PipeStage``)."""

    _fields_ = [("count", _PTR), ("delta", ctypes.c_float)]


class _Leaves(ctypes.Union):
    _fields_ = [("core", _CoreLeaves), ("cell", _CellLeaves), ("pipe", _PipeLeaves)]


class _Group(ctypes.Structure):
    _fields_ = [("type", _I32), ("base", _I32), ("n_slot", _I32),
                ("in_base", _I32), ("divider", _I32), ("rx_idx", _PTR),
                ("tx_idx", _PTR), ("cons", _PTR), ("u", _Leaves)]


class _ProgramArgs(ctypes.Structure):
    """``ProgramArgs`` of ``csrc/granule_step.cu``, field for field."""

    _fields_ = ([("reg_val", _PTR), ("reg_v", _PAIR), ("q_buf", _PTR),
                 ("q_head", _PAIR), ("q_tail", _PAIR), ("cycle", _PTR),
                 ("stop", _PTR)]
                + [(n, _I32) for n in ("n_reg", "n_qrows", "n_q_row", "cap",
                                       "have_q", "W", "n_groups", "n_threads")]
                + [("g", _Group * MAX_GROUPS)])


_TIER_PTRS = (
    "send_idx", "send_mask", "recv_idx", "recv_mask", "bat_fwd", "bat_rev",
    "credits", "slab", "cnt", "cred",
)
_TIER_INTS = ("B", "S", "E")


class _TierArgs(ctypes.Structure):
    _fields_ = ([(n, _PTR) for n in _TIER_PTRS]
                + [(n, _I32) for n in _TIER_INTS])


def device_step_type(block) -> int | None:
    """The kernel's type code of ``block`` (0 ``ManycoreCell``, 1
    ``SystolicCell``, 2 ``PipeStage``), or None where the kernel has no
    step for it.  A subclass counts only where it keeps its base's
    ``step`` (a clock divider, say): any other step has no device
    function."""
    from ..hw.manycore import ManycoreCell
    from ..hw.pipestage import PipeStage
    from ..hw.systolic import SystolicCell

    for code, cls in enumerate((ManycoreCell, SystolicCell, PipeStage)):
        if isinstance(block, cls) and type(block).step is cls.step:
            return code
    return None


def _library():
    from . import _build

    lib = _build.load("granule_step")
    fn = lib.granule_program
    if fn.argtypes is None:
        size = lib.granule_args_size()
        if size != ctypes.sizeof(_ProgramArgs):
            raise RuntimeError(f"ProgramArgs is {size} B in the kernel, "
                               f"{ctypes.sizeof(_ProgramArgs)} B here")
        fn.argtypes = [ctypes.POINTER(_ProgramArgs), ctypes.POINTER(_TierArgs),
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


#: Port columns of each type's tables (``rx_idx``, ``tx_idx``, ``cons``)
#: and in-port ids a slot, by type code: PipeStage has one of each.
_PORTS = (2, 2, 1)


def _group_leaves(code: int, block, st, n_slot: int, dev, keep: list):
    """The state leaves of one group for the kernel, checked; each paired
    leaf gets its second buffer (kept alive in ``keep``)."""
    from ..hw import manycore, pipestage, systolic

    mod, cls = ((manycore, manycore.CoreState), (systolic, systolic.CellState),
                (pipestage, pipestage.PipeStageState))[code]
    if not isinstance(st, cls):
        raise TypeError(f"{type(block).__name__}: expected {cls.__name__}, "
                        f"got {type(st).__name__}")
    ptr = {}
    for name, dtype in mod.DEVICE_LEAVES.items():
        x = getattr(st, name)
        shape = (n_slot,) + ((block.m_stream,) if name in ("a_buf", "y_buf") else ())
        p0 = tensor_ptr(x, name, dtype, shape, dev)
        if name in mod.PAIRED_LEAVES:
            # ManycoreCell's paired leaves are written by every slot every
            # cycle; a_idx only by west cells, so its copy starts equal
            x1 = x.clone() if code == 1 else torch.empty_like(x)
            keep.append(x1)
            ptr[name] = _PAIR(p0, x1.data_ptr())
        else:
            ptr[name] = p0
    if code == 0:
        return _Leaves(core=_CoreLeaves(**ptr, R=block.R, C=block.C))
    if code == 1:
        return _Leaves(cell=_CellLeaves(**ptr, M=block.m_stream))
    return _Leaves(pipe=_PipeLeaves(**ptr, delta=block.delta))


def epoch_program_cuda(carry: Tree, program: Program,
                       consts: ProgramConsts,
                       stop: torch.Tensor | None = None) -> Tree:
    """Launch ``csrc/granule_step.cu`` on the carry, in place, on the
    current stream: one launch a simulated cycle over every slot of every
    group, each group by its block type's device step.  Every leaf that
    another thread reads within a cycle gets a second buffer here, the
    kernel alternates the two by cycle parity, and the results end in the
    carry's own tensors.  Every launch reads ``stop`` (a () bool tensor)
    first and does nothing where it is set.  Raises for anything the
    kernel does not take: ``NotImplementedError`` for a block type with
    no device step."""
    global launches, recorded
    program = validate_program(program)
    reg_val, reg_v, q, block_states, cycle, credits = carry
    dev = reg_val.device
    codes = [device_step_type(b) for b in consts.blocks]
    if None in codes or not 1 <= len(codes) <= MAX_GROUPS:
        names = ", ".join(type(b).__name__ for b in consts.blocks)
        raise NotImplementedError(
            f"no device step for block types [{names}]: the CUDA epoch "
            f"program steps up to {MAX_GROUPS} groups of ManycoreCell, "
            "SystolicCell and PipeStage"
        )
    n_reg, W = reg_val.shape
    if W != 2:
        raise ValueError(f"the device steps take 2-word packets, carry has {W}")
    n_qrows, cap = q.buf.shape[0], q.capacity
    have_q = n_qrows > 1
    B = consts.send_idx[0].shape[0] if consts.send_idx else 1
    if consts.cons is None or len(consts.cons) != len(codes):
        raise ValueError("consts.cons is missing: the CUDA program needs a "
                         "consumer table a group (granule_step.consumer_table)")
    if have_q and n_qrows != B * consts.n_q:
        raise ValueError("queue rows do not match the batch of the exchange tables")

    keep: list = []

    def paired(x, name, dtype, shape):
        x1 = x.clone()  # no thread commits the sentinels or idle rows
        keep.append(x1)
        return _PAIR(tensor_ptr(x, name, dtype, shape, dev), x1.data_ptr())

    groups = (_Group * MAX_GROUPS)()
    base = in_base = 0
    for gi, (code, block, st) in enumerate(zip(codes, consts.blocks, block_states)):
        n_slot, ports = consts.rx_idx[gi].shape[0], _PORTS[code]
        tables = {}
        for name, t in (("rx_idx", consts.rx_idx[gi]), ("tx_idx", consts.tx_idx[gi]),
                        ("cons", consts.cons[gi])):
            tables[name] = tensor_ptr(t, f"{name}.{gi}", torch.int32, (n_slot, ports), dev)
            if tables[name] % (4 * ports):
                raise ValueError(f"{name}.{gi}: the kernel loads int2 pairs, "
                                 "the table must be 8-byte aligned")
        groups[gi] = _Group(
            type=code, base=base, n_slot=n_slot, in_base=in_base,
            divider=int(block.clock_divider),
            u=_group_leaves(code, block, st, n_slot, dev, keep), **tables)
        base += -(-n_slot // 32) * 32  # the next group starts on a warp boundary
        in_base += ports * n_slot
    args = _ProgramArgs(
        reg_val=tensor_ptr(reg_val, "reg_val", torch.float32, (n_reg, W), dev),
        reg_v=paired(reg_v, "reg_v", torch.bool, (n_reg,)),
        q_buf=tensor_ptr(q.buf, "queues.buf", torch.float32, (n_qrows, cap, W), dev),
        q_head=paired(q.head, "queues.head", torch.int32, (n_qrows,)),
        q_tail=paired(q.tail, "queues.tail", torch.int32, (n_qrows,)),
        cycle=tensor_ptr(cycle, "cycle", torch.int32, (), dev),
        stop=None if stop is None else tensor_ptr(stop, "stop", torch.bool, (), dev),
        n_reg=n_reg, n_qrows=n_qrows, n_q_row=consts.n_q, cap=cap,
        have_q=int(have_q), W=W, n_groups=len(codes),
        n_threads=groups[len(codes) - 1].base + groups[len(codes) - 1].n_slot,
        g=groups,
    )

    n_tiers = len(consts.send_idx)
    tiers = (_TierArgs * max(n_tiers, 1))()
    for t in range(n_tiers):  # the scratch stays referenced until queued
        S, E = consts.send_idx[t].shape[1], consts.depths[t]
        shp = (B, S)
        slab = torch.empty((B, S, E, W), dtype=torch.float32, device=dev)
        cnt = torch.empty(shp, dtype=torch.int32, device=dev)
        cred = torch.empty(shp, dtype=torch.int32, device=dev)
        keep += [slab, cnt, cred]
        tiers[t] = _TierArgs(
            send_idx=tensor_ptr(consts.send_idx[t], f"send_idx.{t}", torch.int32, shp, dev),
            send_mask=tensor_ptr(consts.send_mask[t], f"send_mask.{t}", torch.bool, shp, dev),
            recv_idx=tensor_ptr(consts.recv_idx[t], f"recv_idx.{t}", torch.int32, shp, dev),
            recv_mask=tensor_ptr(consts.recv_mask[t], f"recv_mask.{t}", torch.bool, shp, dev),
            bat_fwd=tensor_ptr(consts.bat_fwd[t], f"bat_fwd.{t}", torch.int32, shp, dev),
            bat_rev=tensor_ptr(consts.bat_rev[t], f"bat_rev.{t}", torch.int32, shp, dev),
            credits=tensor_ptr(credits[t], f"credits.{t}", torch.int32, shp, dev),
            slab=slab.data_ptr(), cnt=cnt.data_ptr(), cred=cred.data_ptr(),
            B=B, S=S, E=E,
        )
    ops = (ctypes.c_int32 * (2 * len(program) or 1))(
        *[v for op, arg in program for v in (_OPCODES[op], arg)]
    )
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ctypes.byref(args), tiers, n_tiers, ops, len(program),
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"granule_step kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        recorded += 1  # launched by each replay of the graph
    else:
        launches += 1
        REGISTRY.inc("granule_step.launches")
    return carry


__all__ = [
    "MAX_GROUPS", "Program", "ProgramConsts", "consumer_table",
    "device_step_type", "epoch_program",
    "epoch_program_ref", "epoch_program_cuda", "overlap_program",
    "resolve_overlap", "validate_program",
]
