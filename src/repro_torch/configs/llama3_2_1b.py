"""llama3.2-1b [dense]: 16L d2048 32H (GQA kv=8) ff8192 v128256.

[hf:meta-llama/Llama-3.2-1B] Tied embeddings, SwiGLU, RoPE theta 5e5.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, hidden_act="silu", rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, hidden_act="silu", tie_embeddings=True,
    use_kernels=False, dtype="float32",
)
