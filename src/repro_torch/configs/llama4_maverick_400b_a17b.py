"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) v202048.

[hf:meta-llama/Llama-4-Maverick] 128 experts top-1 with a shared expert
(sigmoid gate), early-fusion multimodal (frontend out of scope — text
backbone modeled), expert ff 8192.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=202048, hidden_act="silu", rope_theta=500_000.0,
    block_pattern=("attn", "attn_moe"),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25, router_norm_topk=False,
                  shared_expert=True, gate_fn="sigmoid"),
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, hidden_act="silu",
    block_pattern=("attn", "attn_moe"),
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=64, capacity_factor=2.0,
                  router_norm_topk=False, shared_expert=True,
                  gate_fn="sigmoid"),
    use_kernels=False, dtype="float32",
)
