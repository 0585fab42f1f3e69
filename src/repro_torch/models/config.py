"""Model configuration dataclasses (a copy of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_norm_topk: bool = True   # normalize top-k probs (qwen3)
    shared_expert: bool = False     # llama4: shared expert alongside routed
    gate_fn: str = "softmax"        # 'softmax' | 'sigmoid' (llama4 top-1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # layer pattern, cycled to fill n_layers; remainder = prefix of pattern.
    # kinds: attn | attn_local | rglru | mlstm | slstm
    block_pattern: tuple[str, ...] = ("attn",)

    hidden_act: str = "silu"     # silu => SwiGLU, gelu => GeGLU
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma-style sqrt(d_model) embedding scale
    rope_theta: float = 500_000.0
    rope_type: str = "default"   # default | mrope
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    attn_window: int | None = None  # for attn_local layers
    causal: bool = True          # False: encoder-only (hubert)
    attn_logit_softcap: float | None = None

    moe: MoEConfig | None = None
    # recurrent-block hyperparams
    rnn_width: int | None = None   # RG-LRU lru_width (defaults d_model)
    conv_width: int = 4

    input_mode: str = "tokens"   # tokens | embeddings (vlm/audio stub frontend)

    dtype: Any = "bfloat16"
    remat: bool = True
    # smoke-test configs set this False so tiny shapes skip kernel blocking
    use_kernels: bool = True

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def n_stages(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder(self) -> tuple[str, ...]:
        return self.block_pattern[: self.n_layers % len(self.block_pattern)]

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    def param_count(self) -> int:
        """Total parameters (embedding + layers), for roofline MODEL_FLOPS."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        moe_mlp = 0
        if self.moe is not None:
            moe_mlp = d * self.moe.n_experts + self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            if self.moe.shared_expert:
                moe_mlp += 3 * d * self.moe.d_ff_expert
        counts = {}
        counts["attn"] = attn + mlp + 2 * d
        counts["attn_local"] = counts["attn"]
        counts["attn_moe"] = attn + moe_mlp + 2 * d
        dr = self.rnn_dim
        counts["rglru"] = d * dr * 2 + self.conv_width * dr + 2 * dr + dr * d + mlp + 2 * d
        # mlstm: up-proj x2 (factor 2), q/k/v over inner dim, out, gates
        di = 2 * d
        counts["mlstm"] = d * di * 2 + 3 * di * di // 1 + di * d + 2 * d
        hd_s = d // self.n_heads
        counts["slstm"] = (
            4 * d * d + 4 * self.n_heads * hd_s * hd_s  # input + block-diag R
            + 3 * d * (4 * d // 3) + 2 * d
        )
        n_full = self.n_stages
        total = 0
        for kind in self.block_pattern:
            total += counts[kind] * n_full
        for kind in self.remainder:
            total += counts[kind]
        total += self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        routed = self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        active = self.moe.top_k * 3 * self.d_model * self.moe.d_ff_expert
        n_moe_layers = sum(
            1 for k in self.block_pattern * self.n_stages + self.remainder
            if k == "attn_moe"
        )
        return full - n_moe_layers * (routed - active)
