"""The LM kernels as the model calls them, as ``repro.kernels.ops``
(forward only).

Each keeps the JAX package's shape rule for when the kernel runs: the
caller's ``use_kernel`` (the model sets it from ``cfg.use_kernels`` and
``T % 128`` for attention, ``T % 256 and D % 256`` for the RG-LRU), and
``T % min(block_t, T) == 0`` for the sLSTM.  The rule decides between the
kernel module (which runs its plain version on CPU tensors and its Hopper
kernel on CUDA tensors) and the oracles of ``ref``, exactly as the JAX
package decides between its Pallas kernel and ``ref``; it is not a
fallback.  The backward passes wait for the training slice.
"""
from __future__ import annotations

import math

from . import flash_attention as _fa
from . import ref
from . import rglru_scan as _rg
from . import slstm_scan as _sl


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None, block_q: int = 512,
                    block_k: int = 512, use_kernel: bool = True):
    """(B, Hq, T, D) x (B, Hkv, S, D)^2 -> (B, Hq, T, D).  ``use_kernel=False``
    takes the dense oracle (tiny shapes)."""
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 sm_scale=sm_scale)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    bq = min(128, block_q, q.shape[2])
    bk = min(128, block_k, k.shape[2])
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               sm_scale=scale, block_q=bq, block_k=bk)


def rglru(x, a, h0=None, *, block_t: int = 256, block_d: int = 256,
          use_kernel: bool = True):
    """Linear recurrence h_t = a_t h_{t-1} + x_t -> (h, h_last)."""
    if not use_kernel:
        return ref.rglru_ref(x, a, h0)
    return _rg.rglru_scan(x, a, h0, block_t=block_t, block_d=block_d)


def slstm_scan(r: dict, pre, carry0: tuple, *, block_t: int = 128):
    """The sLSTM recurrence -> (hs, (cs, ns, ms), final carry)."""
    T = pre.shape[1]
    if T % min(block_t, T) == 0:
        return _sl.slstm_scan(r, pre, carry0, block_t=block_t)
    return ref.slstm_scan_ref(r, pre, carry0)
