"""llama3.2-3b [dense]: 28L d3072 24H (GQA kv=8) ff8192 v128256."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, hidden_act="silu", rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab=512, hidden_act="silu", tie_embeddings=True,
    use_kernels=False, dtype="float32",
)
