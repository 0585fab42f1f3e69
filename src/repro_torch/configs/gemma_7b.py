"""gemma-7b [dense]: 28L d3072 16H (kv=16, MHA) ff24576 v256000.

[arXiv:2403.08295] GeGLU, head_dim=256, sqrt(d) embedding scale, tied
embeddings, RoPE theta 1e4.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, hidden_act="gelu", rope_theta=10_000.0,
    tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, hidden_act="gelu", tie_embeddings=True,
    embed_scale=True, use_kernels=False, dtype="float32",
)
