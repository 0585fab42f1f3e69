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
    kernel ``csrc/slstm_scan.cu``, or raise.  Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..obs.registry import REGISTRY
from . import ref
from ._build import tensor_ptr

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
        return slstm_scan_cuda(r, pre, carry0)
    raise ValueError(f"no slstm_scan for device {pre.device}")


# ------------------------------------------------------------- the kernel
_R_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VECS = ("c0", "n0", "h0", "m0")
_SEQS = ("hs", "cs", "ns", "ms")
_FINAL = ("cf", "nf", "hf", "mf")


class _SlstmArgs(ctypes.Structure):
    """``SlstmArgs`` of ``csrc/slstm_scan.cu``, field for field."""

    _fields_ = ([("r", ctypes.c_void_p * 4), ("pre", ctypes.c_void_p)]
                + [(k, ctypes.c_void_p) for k in _VECS + _SEQS + _FINAL]
                + [(k, ctypes.c_int) for k in ("T", "H", "hd")])


def _library():
    from . import _build

    lib = _build.load("slstm_scan")
    if lib.slstm_scan_fwd.argtypes is None:
        lib.slstm_scan_fwd.argtypes = [ctypes.POINTER(_SlstmArgs), ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
        lib.slstm_scan_fwd.restype = ctypes.c_int
    return lib


def slstm_scan_cuda(r: dict, pre, carry0: tuple):
    """Launch ``csrc/slstm_scan.cu`` on the current stream: one launch runs
    all T steps.  The four R matrices share one dtype, bf16 or f32, and are
    made contiguous here; pre and the carry are f32.  4 * hd threads a
    block, so hd is at most 256.  Raises for anything the kernel does not
    take."""
    global launches
    dev = pre.device
    if dev.type != "cuda":
        raise ValueError(f"slstm_scan_cuda needs CUDA tensors, got {dev}")
    if pre.dim() != 4 or pre.shape[2] != 4:
        raise ValueError(f"pre: expected (B, T, 4, d), got {tuple(pre.shape)}")
    B, T, _, d = pre.shape
    H, hd = r["i"].shape[:2]
    r_dtype = r["i"].dtype
    if r_dtype not in _R_DTYPES or H * hd != d or hd > 256 or min(B, T) < 1:
        raise ValueError(f"r {r_dtype} (H={H}, hd={hd}) against d={d}: R must be "
                         "f32 or bf16 with H * hd == d and hd <= 256")
    rs = [r[g].contiguous() for g in GATES]
    f32 = torch.float32
    ptr = {"pre": tensor_ptr(pre, "pre", f32, (B, T, 4, d), dev)}
    r_ptrs = [tensor_ptr(x, f"r_{g}", r_dtype, (H, hd, hd), dev)
              for x, g in zip(rs, GATES)]
    for name, x in zip(_VECS, carry0):
        ptr[name] = tensor_ptr(x, name, f32, (B, d), dev)
    out = {k: torch.empty((B, T, d), dtype=f32, device=dev) for k in _SEQS}
    out.update({k: torch.empty((B, d), dtype=f32, device=dev) for k in _FINAL})
    args = _SlstmArgs(r=(ctypes.c_void_p * 4)(*r_ptrs), T=T, H=H, hd=hd, **ptr,
                      **{k: v.data_ptr() for k, v in out.items()})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().slstm_scan_fwd(ctypes.byref(args), _R_DTYPES[r_dtype], B,
                                       ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    REGISTRY.inc("slstm_scan.launches")
    return (out["hs"], (out["cs"], out["ns"], out["ms"]),
            (out["cf"], out["nf"], out["hf"], out["mf"]))


__all__ = ["launches", "slstm_scan", "slstm_scan_cuda", "slstm_scan_ref"]
