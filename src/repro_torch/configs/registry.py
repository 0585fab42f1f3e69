"""Architecture registry of the port, as ``repro.configs.registry``.

``get_config`` and ``ALIASES`` work as in the JAX package for every
assigned architecture and the manycore wafer; ``ShapeSpec``, ``SHAPES``,
``skip_reason`` and ``lm_cells`` are the reference's shape sets and its
skips of inapplicable (arch, shape) cells.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterable

ARCH_IDS = [
    "llama3_2_1b",
    "llama3_2_3b",
    "gemma_7b",
    "gemma_2b",
    "qwen2_vl_72b",
    "hubert_xlarge",
    "qwen3_moe_235b_a22b",
    "llama4_maverick_400b_a17b",
    "xlstm_125m",
    "recurrentgemma_2b",
    # the paper's own application (not part of the 40 LM cells)
    "manycore",
]

# canonical external names (with dots/dashes) -> module ids
ALIASES = {
    "llama3.2-1b": "llama3_2_1b",
    "llama3.2-3b": "llama3_2_3b",
    "gemma-7b": "gemma_7b",
    "gemma-2b": "gemma_2b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose sequence mixing is sub-quadratic end to end (recurrent state
# or a bounded-window KV cache): the only ones that run long_500k
SUBQUADRATIC = {"xlstm_125m", "recurrentgemma_2b"}
ENCODER_ONLY = {"hubert_xlarge"}


def skip_reason(arch: str, shape: str) -> str | None:
    """Why the (arch, shape) cell is skipped, or None when it runs."""
    arch = ALIASES.get(arch, arch)
    if arch == "manycore":
        return None if shape == "manycore" else "manycore uses its own shape"
    if arch in ENCODER_ONLY and SHAPES[shape].step == "decode":
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "pure full-attention arch: 500k dense KV cache infeasible (see DESIGN.md §5)"
    return None


def get_config(arch: str, smoke: bool = False):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def lm_cells() -> Iterable[tuple[str, str]]:
    """All 40 assigned (arch, shape) cells, including skipped ones."""
    for arch in ARCH_IDS:
        if arch == "manycore":
            continue
        for shape in SHAPES:
            yield arch, shape
