"""Blocked online-softmax attention, forward, as ``repro.kernels.
flash_attention`` (the Pallas kernel ``_fa_kernel``).

q (B, Hq, T, D) against k and v (B, Hkv, S, D): GQA through the KV head
``h // (Hq // Hkv)``, causal and sliding-window masks, whole KV blocks that
no query of a block can see are skipped.  f32 math over bf16 or f32 inputs;
returns ``o`` in q's dtype and, on request, ``lse`` (B, Hq, T) f32.  A row
with no visible key gives ``o = 0`` and ``lse = -1e30``.

:func:`flash_attention` dispatches by device:

  * CPU tensors go to :func:`flash_attention_ref`, the plain PyTorch
    version: the same blocked online softmax, block by block;
  * CUDA tensors go to :func:`flash_attention_cuda`, the hand-written
    Hopper kernel ``csrc/flash_attention.cu``, or raise.  Nothing falls
    back.  While an ``obs.op_counts`` counter is active, the launch reports
    its plain version's counts at the call (:func:`plain_counts`).

The kernel has two routes, chosen by dtype (:func:`route`), with no
fallback between them:

  * bf16 (the serving path): ``fa_fwd_tc``, on the tensor cores (``wgmma``
    on bf16 tiles that TMA loads into a two-stage ring, P applied as
    bf16 hi + lo parts); D a multiple of 16, at most 256;
  * f32: ``fa_fwd``, every product an f32 FMA on the CUDA cores; D a
    multiple of 4, at most 256.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..obs import op_counts
from ..obs.registry import REGISTRY
from ._build import tensor_ptr
from .ref import NEG_INF, attention_mask

#: Launches of the CUDA kernel (one per :func:`flash_attention_cuda`
#: call), over both routes.  A plain integer, so a run can show that its
#: main path went through the kernel; set it to 0 before the run.
launches = 0
#: The same launches by route (:data:`ROUTES`); set each to 0 with
#: ``launches``.
route_launches = {"tensor_cores": 0, "cuda_cores": 0}


def _visible(q_start: int, bq: int, k_start: int, bk: int, causal: bool,
             window: int | None) -> bool:
    """Block-level visibility of ``_fa_kernel``: may any (q, k) pair of the
    two blocks interact?"""
    ok = True
    if causal:
        ok &= k_start <= q_start + bq - 1
    if window is not None:
        ok &= k_start + bk - 1 > q_start - window
    return ok


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Hq, T, D) and k, v (B, Hkv, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, T, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")


# ------------------------------------------------------- the plain version
def flash_attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                        sm_scale: float | None = None, block_q: int = 128,
                        block_k: int = 128, return_lse: bool = False):
    """The blocked online softmax of ``_fa_kernel`` in plain PyTorch, every
    (batch, head) at once: for each query block, the visible KV blocks in
    order, with the running max ``m``, sum ``l`` and accumulator."""
    _check(q, k, v)
    B, Hq, T, D = q.shape
    S = k.shape[2]
    G = Hq // k.shape[1]
    bq, bk = min(block_q, T), min(block_k, S)
    if T % bq or S % bk:
        raise ValueError(f"T={T}, S={S} must divide block sizes ({bq}, {bk})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    for q_start in range(0, T, bq):
        qb = q[:, :, q_start:q_start + bq].float() * sm_scale
        acc = torch.zeros((B, Hq, bq, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, Hq, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        for k_start in range(0, S, bk):
            if not _visible(q_start, bq, k_start, bk, causal, window):
                continue
            s = qb @ kf[:, :, k_start:k_start + bk].transpose(-1, -2)
            mask = attention_mask(bq, bk, causal, window, q.device, q_start, k_start)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, k_start:k_start + bk]
            m = m_new
        lsafe = torch.where(l == 0.0, 1.0, l)
        o[:, :, q_start:q_start + bq] = (acc / lsafe[..., None]).to(q.dtype)
        lse[:, :, q_start:q_start + bq] = torch.where(l == 0.0, NEG_INF,
                                                      m + torch.log(lsafe))
    return (o, lse) if return_lse else o


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None, block_q: int = 128,
                    block_k: int = 128, return_lse: bool = False):
    """Attention on the inputs' device: the plain version on the CPU (with
    blocks ``block_q`` x ``block_k``), the Hopper kernel on CUDA (whose
    blocks are its own)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale, block_q=block_q,
                                   block_k=block_k, return_lse=return_lse)
    if q.device.type == "cuda":
        if op_counts.active is None:
            return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        sm_scale=sm_scale, return_lse=return_lse)
        run = functools.partial(flash_attention_cuda, q, k, v, causal=causal,
                                window=window, sm_scale=sm_scale, return_lse=return_lse)
        return op_counts.kernel("flash_attention", run, lambda: plain_counts(
            str(q.device), *map(op_counts.signature, (q, k, v)), causal, window,
            sm_scale, block_q, block_k, return_lse))
    raise ValueError(f"no flash_attention for device {q.device}")


@functools.lru_cache(maxsize=256)
def plain_counts(device: str, q_sig, k_sig, v_sig, causal, window, sm_scale, block_q,
                 block_k, return_lse) -> op_counts.Counts:
    """What :func:`flash_attention_ref` counts under ``obs.op_counts`` at a
    call on ``device`` of these signatures (``op_counts.signature``) and
    arguments: its runs there at up to 3 x 3 blocks, fitted in the KV
    blocks, the query blocks and the visible block pairs (each visible
    pair dispatches the same ops)."""
    (B, Hq, T, D), (S, Hkv) = q_sig[0], (k_sig[0][2], k_sig[0][1])
    bq, bk = min(block_q, T), min(block_k, S)

    def pairs(nq: int, nk: int) -> int:
        return sum(_visible(i * bq, bq, j * bk, bk, causal, window)
                   for i in range(nq) for j in range(nk))

    def measure(p):
        nk, nq, _ = p
        kv = (B, Hkv, nk * bk, D)
        return op_counts.run_counts(
            flash_attention_ref, op_counts.like(q_sig, device, (B, Hq, nq * bq, D)),
            op_counts.like(k_sig, device, kv), op_counts.like(v_sig, device, kv),
            causal=causal, window=window, sm_scale=sm_scale, block_q=bq, block_k=bk,
            return_lse=return_lse)

    nq, nk = T // bq, S // bk
    target = (nk, nq, pairs(nq, nk))
    if nq <= 2 and nk <= 2:
        return measure(target)
    return op_counts.linear_counts(
        measure, [(j, i, pairs(i, j)) for i in (1, 2, 3) for j in (1, 2, 3)], target)


# ------------------------------------------------------------- the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's route for each dtype it takes.
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
MAX_HEAD_DIM = 256
_CHUNK_BYTES = 64 * 128  # a 64 x 64 bf16 tile of the tensor-core route


def route(dtype: torch.dtype, D: int) -> str:
    """The route of ``csrc/flash_attention.cu`` that takes q, k, v of
    ``dtype`` with head dim ``D``; raises where none does."""
    if dtype not in ROUTES:
        raise ValueError(f"q, k, v must be bf16 or f32, got {dtype}")
    step = 16 if dtype == torch.bfloat16 else 4
    if not 1 <= D <= MAX_HEAD_DIM or D % step:
        raise ValueError(f"head dim {D}: the {dtype} route takes a multiple of "
                         f"{step} up to {MAX_HEAD_DIM}")
    return ROUTES[dtype]


def smem_bytes(dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of one CTA of the route for (dtype, D): the
    tensor-core route holds Q (64 rows) and two stages of K and V (64
    keys), each in whole 64-column chunks, plus 1 KB of alignment and its
    barriers; the f32 route two 32-key tiles (rows padded by 4 floats) and
    32 query rows.  The wrapper passes it to the launch, which refuses it
    unless the kernel's own count agrees."""
    if route(dtype, D) == "tensor_cores":
        nch = -(-D // 64)
        return (nch + 2 * 2 * nch) * _CHUNK_BYTES + 1024 + 64
    return 4 * (2 * 32 * (D + 4) + 32 * D)


def _library():
    from . import _build

    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_size_t, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int | None = None,
                         sm_scale: float | None = None, return_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on the current stream, on the
    route of q's dtype (:func:`route`).  q, k and v are made contiguous
    here (the model hands over transposed views) and must share one
    dtype; the tensor-core route also needs them 16-byte aligned.  Raises
    for anything the kernel does not take."""
    global launches
    _check(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    path = route(q.dtype, D)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if min(B, Hq, T, S) < 1:
        raise ValueError(f"an empty axis in q {tuple(q.shape)} or k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ptrs = [tensor_ptr(x, n, q.dtype, x.shape, dev)
            for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    o = torch.empty_like(q)
    if path == "tensor_cores" and any(p % 16 for p in ptrs):
        raise ValueError("the tensor-core route needs q, k and v 16-byte aligned")
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=dev)
           if return_lse else None)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_fwd(
            *ptrs, o.data_ptr(), 0 if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, T, S, D, int(causal),
            0 if window is None else int(window), float(sm_scale),
            smem_bytes(q.dtype, D), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    route_launches[path] += 1
    REGISTRY.inc("flash_attention.launches")
    return (o, lse) if return_lse else o


__all__ = ["ROUTES", "flash_attention", "flash_attention_cuda", "flash_attention_ref",
           "launches", "route", "route_launches", "smem_bytes"]
