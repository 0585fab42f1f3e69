"""The RG-LRU linear recurrence h_t = a_t h_{t-1} + x_t over (B, T, D), as
``repro.kernels.rglru_scan`` (the Pallas kernel ``_rglru_kernel``).

Returns (h (B, T, D), h_last (B, D)) in x's dtype, f32 math.
:func:`rglru_scan` dispatches by device:

  * CPU tensors go to :func:`rglru_scan_ref`, the plain PyTorch version:
    the TPU kernel's time chunks of ``block_t`` steps, a Hillis–Steele scan
    inside each and the carry across them;
  * CUDA tensors go to :func:`rglru_scan_cuda`, the hand-written Hopper
    kernel ``csrc/rglru_scan.cu`` (a chunked single-pass scan with
    decoupled look-back; the same h up to rounding), or raise.  Nothing
    falls back.  While an ``obs.op_counts`` counter is active, the launch
    reports its plain version's counts at the call (:func:`plain_counts`).

:func:`rglru_scan` takes the TPU kernel's shape rule (T and D divisible by
the blocks); :func:`rglru_scan_cuda` takes any B, T, D >= 1.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..obs import op_counts
from ..obs.registry import REGISTRY
from ._build import tensor_ptr
from .ref import affine_scan

#: Launches of the CUDA kernel (one per :func:`rglru_scan_cuda` call).  A
#: plain integer, so a run can show that its main path went through the
#: kernel; set it to 0 before the run.
launches = 0


def _blocks(x, block_t: int, block_d: int) -> tuple[int, int]:
    if x.dim() != 3:
        raise ValueError(f"expected x (B, T, D), got {tuple(x.shape)}")
    _, T, D = x.shape
    bt, bd = min(block_t, T), min(block_d, D)
    if T % bt or D % bd:
        raise ValueError(f"T={T}, D={D} must divide blocks ({bt}, {bd})")
    return bt, bd


def rglru_scan_ref(x, a, h0=None, *, block_t: int = 256, block_d: int = 256):
    """``_rglru_kernel`` in plain PyTorch: per time chunk of ``block_t``
    steps, the Hillis–Steele scan of the affine maps (a, x), then the carry
    applied and the chunk's last row carried on.  Channels are independent,
    so ``block_d`` only checks the shape rule."""
    bt, _ = _blocks(x, block_t, block_d)
    B, T, D = x.shape
    h_in = (torch.zeros((B, 1, D), dtype=torch.float32, device=x.device)
            if h0 is None else h0.float()[:, None])
    hs = []
    for t0 in range(0, T, bt):
        A, X = affine_scan(a[:, t0:t0 + bt].float(), x[:, t0:t0 + bt].float(), dim=1)
        h = X + A * h_in
        h_in = h[:, -1:]
        hs.append(h)
    h = torch.cat(hs, 1)
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def rglru_scan(x, a, h0=None, *, block_t: int = 256, block_d: int = 256):
    """The recurrence on the inputs' device: the plain version on the CPU,
    the Hopper kernel on CUDA."""
    _blocks(x, block_t, block_d)
    if x.device.type == "cpu":
        return rglru_scan_ref(x, a, h0, block_t=block_t, block_d=block_d)
    if x.device.type == "cuda":
        if op_counts.active is None:
            return rglru_scan_cuda(x, a, h0)
        run = functools.partial(rglru_scan_cuda, x, a, h0)
        return op_counts.kernel("rglru_scan", run, lambda: plain_counts(
            str(x.device), *map(op_counts.signature, (x, a, h0)), block_t, block_d))
    raise ValueError(f"no rglru_scan for device {x.device}")


@functools.lru_cache(maxsize=256)
def plain_counts(device: str, x_sig, a_sig, h0_sig, block_t: int,
                 block_d: int) -> op_counts.Counts:
    """What :func:`rglru_scan_ref` counts under ``obs.op_counts`` at a call
    on ``device`` of these signatures (``op_counts.signature``): its
    runs there at one and two time chunks, fitted in the chunks (each
    chunk dispatches the same ops)."""
    B, T, D = x_sig[0]
    bt = min(block_t, T)

    def measure(p):
        shape = (B, p[0] * bt, D)
        like = op_counts.like
        return op_counts.run_counts(
            rglru_scan_ref, like(x_sig, device, shape), like(a_sig, device, shape),
            like(h0_sig, device), block_t=block_t, block_d=block_d)

    if T // bt <= 2:
        return measure((T // bt,))
    return op_counts.linear_counts(measure, [(1,), (2,)], (T // bt,))


# ------------------------------------------------------------- the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The chunk sizes (steps a CTA) of ``chip_smoke.py`` rg-full's sweep; the
#: source fixes its own (``RGLRU_CHUNK``), and :func:`chunk_variant`
#: builds the others on request.
CHUNK_SWEEP = (64, 128, 256, 512)


class ScanPlan(NamedTuple):
    """How ``rglru_fwd`` cuts (B, T, D), as the kernel's library reports
    it: tiles of 32 channels by chunks of ``chunk`` steps, one CTA of
    ``threads`` each, and the 8-byte status pairs of its look-back."""
    tiles: int
    chunks: int
    ctas: int
    threads: int
    chunk: int
    status_pairs: int


def _library(chunk: int | None = None):
    from . import _build

    lib = _build.load("rglru_scan", () if chunk is None else (f"RGLRU_CHUNK={chunk}",))
    if lib.rglru_scan_fwd.argtypes is None:
        lib.rglru_scan_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.rglru_scan_plan.restype = ctypes.c_int
        lib.rglru_scan_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.rglru_scan_fwd.restype = ctypes.c_int
    return lib


def scan_plan(B: int, T: int, D: int, chunk: int | None = None) -> ScanPlan:
    """The kernel's cut of (B, T, D) (built with ``chunk`` steps a CTA
    when given, else the source's); raises for a shape it does not take."""
    out = (ctypes.c_longlong * 6)()
    if _library(chunk).rglru_scan_plan(B, T, D, out) != 0:
        raise ValueError(f"rglru_scan kernel does not take (B, T, D) = {(B, T, D)}")
    return ScanPlan(*out)


def _scan(chunk, x, a, h0):
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors, got {dev}")
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"x: expected f32 or bf16 (B, T, D), got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    px = tensor_ptr(x, "x", x.dtype, (B, T, D), dev)
    pa = tensor_ptr(a, "a", x.dtype, (B, T, D), dev)
    plan = scan_plan(B, T, D, chunk)
    h0 = (torch.zeros((B, D), dtype=torch.float32, device=dev) if h0 is None
          else h0.to(torch.float32).contiguous())
    ph0 = tensor_ptr(h0, "h0", torch.float32, (B, D), dev)
    h = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=x.dtype, device=dev)
    status = torch.empty(plan.status_pairs, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library(chunk).rglru_scan_fwd(
            px, pa, ph0, h.data_ptr(), h_last.data_ptr(), status.data_ptr(),
            _DTYPES[x.dtype], B, T, D, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    REGISTRY.inc("rglru_scan.launches")
    return h, h_last


def rglru_scan_cuda(x, a, h0=None):
    """Launch ``csrc/rglru_scan.cu`` on the current stream.  x and a:
    contiguous (B, T, D) of one dtype, f32 or bf16; h0 (B, D) of any float
    dtype (taken as f32), zeros when absent.  The look-back's status pairs
    are allocated here and cleared by the library's own launch before the
    kernel's.  Raises for anything the kernel does not take."""
    return _scan(None, x, a, h0)


def chunk_variant(chunk: int):
    """:func:`rglru_scan_cuda` built with chunks of ``chunk`` steps (a
    multiple of 32, at most 1024) in place of the source's, for a sweep of
    the chunk size; it counts its launches as the kernel's."""
    return functools.partial(_scan, chunk)


__all__ = ["CHUNK_SWEEP", "ScanPlan", "chunk_variant", "launches", "rglru_scan",
           "rglru_scan_cuda", "rglru_scan_ref", "scan_plan"]
