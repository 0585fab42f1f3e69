"""qwen3-moe-235b-a22b [moe]: 94L d4096 64H (GQA kv=4) v151936.

[hf:Qwen/Qwen3-235B-A22B] 128 experts, top-8, expert ff 1536,
normalized top-k router.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936, hidden_act="silu", rope_theta=1_000_000.0,
    block_pattern=("attn_moe",),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                  capacity_factor=1.25, router_norm_topk=True),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=0, vocab=512, hidden_act="silu",
    block_pattern=("attn_moe",),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                  capacity_factor=2.0, router_norm_topk=True),
    use_kernels=False, dtype="float32",
)
