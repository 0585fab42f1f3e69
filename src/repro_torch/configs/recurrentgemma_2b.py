"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680 v256000.

[arXiv:2402.19427 Griffin] Pattern (RG-LRU, RG-LRU, local-attn) — 2:1
recurrent:attention, window 2048, GeGLU MLP after every temporal block,
head_dim 256, sqrt(d) embed scale.  26 = 8 full patterns + (rglru, rglru).
Sub-quadratic (bounded window + recurrent state) => runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, hidden_act="gelu",
    block_pattern=("rglru", "rglru", "attn_local"), attn_window=2048,
    rnn_width=2560, conv_width=4, rope_theta=10_000.0,
    tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, hidden_act="gelu",
    block_pattern=("rglru", "rglru", "attn_local"), attn_window=16,
    rnn_width=64, conv_width=4, tie_embeddings=True, embed_scale=True,
    use_kernels=False, dtype="float32",
)
