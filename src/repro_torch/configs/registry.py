"""Architecture registry of the port, as ``repro.configs.registry``.

``get_config`` and ``ALIASES`` work as in the JAX package for the
architectures the port serves (the dense llama3.2-1b/3b and gemma-2b/7b,
recurrentgemma-2b, xlstm-125m, and the manycore wafer); every other
assigned architecture raises ``NotImplementedError`` naming the ROADMAP
item it waits for.
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

PORTED = ("llama3_2_1b", "llama3_2_3b", "gemma_7b", "gemma_2b",
          "recurrentgemma_2b", "xlstm_125m", "manycore")

#: What each architecture not yet ported waits for (ROADMAP Queue 1 item 11).
WAITS = {
    "qwen3_moe_235b_a22b": "models/moe.py",
    "llama4_maverick_400b_a17b": "models/moe.py",
    "qwen2_vl_72b": "M-RoPE and the embeddings input",
    "hubert_xlarge": "the non-causal encoder",
}


def get_config(arch: str, smoke: bool = False):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: it waits for {WAITS[arch]} "
            "(ROADMAP Queue 1 item 11)")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
