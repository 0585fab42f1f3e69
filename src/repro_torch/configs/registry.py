"""Architecture registry of the port, as ``repro.configs.registry``.

``get_config`` and ``ALIASES`` work as in the JAX package for every
assigned architecture and the manycore wafer.  The shape sets
(``ShapeSpec``, ``lm_cells``, ``skip_reason``) come with the training
slice.
"""
from __future__ import annotations

import importlib

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


def get_config(arch: str, smoke: bool = False):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
