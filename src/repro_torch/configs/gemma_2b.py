"""gemma-2b [dense]: 18L d2048 8H (MQA kv=1) ff16384 v256000.

[arXiv:2403.08295] GeGLU, head_dim=256, MQA, sqrt(d) embed scale, tied.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, hidden_act="gelu", rope_theta=10_000.0,
    tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab=512, hidden_act="gelu", tie_embeddings=True,
    embed_scale=True, use_kernels=False, dtype="float32",
)
