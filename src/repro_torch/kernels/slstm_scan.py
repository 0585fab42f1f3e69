"""The sLSTM recurrence (xLSTM), as ``repro.kernels.slstm_scan`` (the Pallas
kernel ``_slstm_kernel``).

r: {'i','f','z','o': (H, hd, hd)} block-diagonal recurrent weights (bf16 or
f32, widened to f32); pre: (B, T, 4, d) f32 hoisted input projections;
carry0: (c, n, h, m), each (B, d) f32.  Returns (hs, (cs, ns, ms), final
carry) with the sequences (B, T, d) f32.  :func:`slstm_scan` dispatches by
device:

  * CPU tensors go to :func:`slstm_scan_ref`, the plain PyTorch version,
    one step at a time;
  * CUDA tensors go to :func:`slstm_scan_cuda`, the hand-written Hopper
    kernel ``csrc/slstm_scan.cu`` (one thread-block cluster per head and
    group of batch rows, R resident in the cluster's shared memory,
    :func:`cluster_plan`), or raise.  Nothing falls back.  While an
    ``obs.op_counts`` counter is active, the launch reports its plain
    version's counts at the call (:func:`plain_counts`).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..obs import op_counts
from ..obs.registry import REGISTRY
from . import ref
from ._build import SMEM_LIMIT, tensor_ptr

#: Launches of the CUDA kernel (one per :func:`slstm_scan_cuda` call, which
#: runs the whole sequence).  A plain integer, so a run can show that its
#: main path went through the kernel; set it to 0 before the run.
launches = 0

GATES = ("i", "f", "z", "o")


def _check_block_t(pre, block_t: int) -> None:
    T = pre.shape[1]
    bt = min(block_t, T)
    if T % bt:
        raise ValueError(f"T={T} must divide block_t={bt}")


def slstm_scan_ref(r: dict, pre, carry0: tuple, *, block_t: int = 128):
    """``_slstm_kernel`` in plain PyTorch: the TPU kernel's shape rule on
    ``block_t``, then the oracle ``ref.slstm_scan_ref``.  The kernel's time
    chunks walk T one step at a time in order, as the oracle does, so they
    change nothing."""
    _check_block_t(pre, block_t)
    return ref.slstm_scan_ref(r, pre, carry0)


def slstm_scan(r: dict, pre, carry0: tuple, *, block_t: int = 128):
    """The recurrence on the inputs' device: the plain version on the CPU,
    the Hopper kernel (the whole sequence in one launch) on CUDA."""
    _check_block_t(pre, block_t)
    if pre.device.type == "cpu":
        return slstm_scan_ref(r, pre, carry0, block_t=block_t)
    if pre.device.type == "cuda":
        if op_counts.active is None:
            return slstm_scan_cuda(r, pre, carry0)
        run = functools.partial(slstm_scan_cuda, r, pre, carry0)
        sig = op_counts.signature
        return op_counts.kernel("slstm_scan", run, lambda: plain_counts(
            str(pre.device), tuple(sig(r[g]) for g in GATES), sig(pre),
            tuple(map(sig, carry0)), block_t))
    raise ValueError(f"no slstm_scan for device {pre.device}")


@functools.lru_cache(maxsize=256)
def plain_counts(device: str, r_sigs: tuple, pre_sig, carry_sigs: tuple,
                 block_t: int) -> op_counts.Counts:
    """What :func:`slstm_scan_ref` counts under ``obs.op_counts`` at a call
    on ``device`` of these signatures (``op_counts.signature``): its
    runs there at 2 and 3 steps, fitted in the steps (every step after
    the first dispatches the same ops), or the call itself where T <= 3."""
    B, T, four, d = pre_sig[0]

    def measure(p):
        like = op_counts.like
        return op_counts.run_counts(
            slstm_scan_ref, {g: like(s, device) for g, s in zip(GATES, r_sigs)},
            like(pre_sig, device, (B, p[0], four, d)),
            tuple(like(s, device) for s in carry_sigs), block_t=block_t)

    if T <= 3:
        return measure((T,))
    return op_counts.linear_counts(measure, [(2,), (3,)], (T,))


# ------------------------------------------------------------- the kernel
_R_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VECS = ("c0", "n0", "h0", "m0")
_SEQS = ("hs", "cs", "ns", "ms")
_FINAL = ("cf", "nf", "hf", "mf")
CLUSTER_SIZES = (1, 2, 4, 8)
#: Threads a CTA may have (``MAX_THREADS`` of the kernel: 128 registers each).
MAX_THREADS = 512
#: Fewest channels a CTA of a cluster of two or more owns.
MIN_CHANNELS = 8
#: Most batch rows a cluster serves (``ROWS`` of the kernel: the rows a
#: thread's accumulators hold).
MAX_ROWS = 4


@dataclass(frozen=True)
class ClusterPlan:
    """How ``csrc/slstm_scan.cu`` splits the work: ``groups`` clusters a
    head, each of ``C`` CTAs serving at most ``Bg`` (<= ``MAX_ROWS``)
    batch rows, CTA c
    owning channels [c E, (c + 1) E) of all four gates; ``KS`` groups of E
    threads split the k-sum (``threads`` = E * KS); ``smem`` bytes of
    shared memory a CTA (the kernel's ``Plan`` counts the same, and its
    launch refuses another count)."""

    C: int
    E: int
    KS: int
    threads: int
    Bg: int
    groups: int
    smem: int


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def cluster_plan(B: int, hd: int, r_dtype: torch.dtype,
                 sizes: tuple = CLUSTER_SIZES) -> ClusterPlan:
    """The largest cluster of ``sizes`` that divides ``hd``, leaves each
    CTA at least ``MIN_CHANNELS`` channels and fits its R slice (4 x hd x E
    in R's dtype) and the buffers of one batch row in ``SMEM_LIMIT``;
    raises where none does.  The largest, not the smallest that fits: each
    CTA's share of a step's products (4 hd E B FMAs) sets the chain's
    pace, so spreading them wins (at xlstm-125m's prefill, 3.62, 2.85 and
    2.29 us a step at C = 2, 4, 8 on an H100: ``chip_smoke.py``'s xl-full
    phase).  B is cut into the fewest groups of balanced size of at most
    ``MAX_ROWS`` rows that fit, one cluster each (one at the served B = 4;
    eight of 4 at B = 32)."""
    if r_dtype not in _R_DTYPES:
        raise ValueError(f"R must be f32 or bf16, got {r_dtype}")
    if B < 1:
        raise ValueError(f"B must be at least 1, got {B}")
    r_size = r_dtype.itemsize
    for C in sorted(sizes, reverse=True):
        E = hd // C
        if hd % C or E > MAX_THREADS or (E < MIN_CHANNELS and C > 1):
            continue
        KS = min(_pow2_floor(MAX_THREADS // E), _pow2_floor(hd), 16)
        r_bytes = -(-4 * hd * E * r_size // 16) * 16

        def smem(Bg):  # + two mbarriers
            floats = KS * Bg * 4 * E + 2 * hd * MAX_ROWS + 2 * Bg * 4 * E + 3 * Bg * E
            return r_bytes + 16 + 4 * floats

        most = next((bg for bg in range(min(B, MAX_ROWS), 0, -1)
                     if smem(bg) <= SMEM_LIMIT), 0)
        if most:
            groups = -(-B // most)
            Bg = -(-B // groups)
            return ClusterPlan(C, E, KS, E * KS, Bg, groups, smem(Bg))
    raise ValueError(f"no cluster of {tuple(sizes)} CTAs holds R (hd={hd}, "
                     f"{r_dtype}) and the buffers of one batch row in {SMEM_LIMIT} B")


class _SlstmArgs(ctypes.Structure):
    """``SlstmArgs`` of ``csrc/slstm_scan.cu``, field for field."""

    _fields_ = ([("r", ctypes.c_void_p * 4), ("pre", ctypes.c_void_p)]
                + [(k, ctypes.c_void_p) for k in _VECS + _SEQS + _FINAL]
                + [(k, ctypes.c_int) for k in ("T", "H", "hd")])


def _library():
    from . import _build

    lib = _build.load("slstm_scan")
    if lib.slstm_scan_fwd.argtypes is None:
        lib.slstm_scan_fwd.argtypes = ([ctypes.POINTER(_SlstmArgs)] + [ctypes.c_int] * 5
                                       + [ctypes.c_size_t, ctypes.c_void_p])
        lib.slstm_scan_fwd.restype = ctypes.c_int
    return lib


def slstm_scan_cuda(r: dict, pre, carry0: tuple, *, plan: ClusterPlan | None = None):
    """Launch ``csrc/slstm_scan.cu`` on the current stream: one launch runs
    all T steps, with ``plan`` (by default :func:`cluster_plan`'s): a
    cluster of C CTAs per head and group of batch rows, R resident in
    their shared memory.  The four R matrices share one dtype, bf16 or
    f32, and are made contiguous here; pre and the carry are f32.  The
    four sequences and the final carry are views of one allocation.
    Raises for anything the kernel does not take."""
    global launches
    dev = pre.device
    if dev.type != "cuda":
        raise ValueError(f"slstm_scan_cuda needs CUDA tensors, got {dev}")
    if pre.dim() != 4 or pre.shape[2] != 4:
        raise ValueError(f"pre: expected (B, T, 4, d), got {tuple(pre.shape)}")
    B, T, _, d = pre.shape
    H, hd = r["i"].shape[:2]
    r_dtype = r["i"].dtype
    if r_dtype not in _R_DTYPES or H * hd != d or min(B, T) < 1:
        raise ValueError(f"r {r_dtype} (H={H}, hd={hd}) against d={d}: R must be "
                         "f32 or bf16 with H * hd == d")
    if plan is None:
        plan = cluster_plan(B, hd, r_dtype)
    f32 = torch.float32
    rs = [r[g].contiguous() for g in GATES]  # alive until the launch
    r_ptrs = [tensor_ptr(x, f"r_{g}", r_dtype, (H, hd, hd), dev)
              for x, g in zip(rs, GATES)]
    ptrs = [tensor_ptr(pre, "pre", f32, (B, T, 4, d), dev)]
    ptrs += [tensor_ptr(x, name, f32, (B, d), dev) for name, x in zip(_VECS, carry0)]
    n_seq, n_vec = B * T * d, B * d
    out = torch.empty(4 * (n_seq + n_vec), dtype=f32, device=dev)
    base, size = out.data_ptr(), out.element_size()
    ptrs += [base + size * n_seq * i for i in range(4)]
    ptrs += [base + size * (4 * n_seq + n_vec * i) for i in range(4)]
    args = _SlstmArgs((ctypes.c_void_p * 4)(*r_ptrs), *ptrs, T, H, hd)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().slstm_scan_fwd(ctypes.byref(args), _R_DTYPES[r_dtype], B,
                                       plan.Bg, plan.C, plan.KS, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    REGISTRY.inc("slstm_scan.launches")
    hs, cs, ns, ms = out[:4 * n_seq].view(4, B, T, d).unbind(0)
    return hs, (cs, ns, ms), tuple(out[4 * n_seq:].view(4, B, d).unbind(0))


__all__ = ["ClusterPlan", "cluster_plan", "launches", "slstm_scan", "slstm_scan_cuda",
           "slstm_scan_ref"]
