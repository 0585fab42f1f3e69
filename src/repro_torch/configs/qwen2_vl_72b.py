"""qwen2-vl-72b [vlm]: 80L d8192 64H (GQA kv=8) ff29568 v152064.

[arXiv:2409.12191] M-RoPE (sections 16/24/24), dynamic-resolution vision
frontend is a STUB: input_specs() provides precomputed patch embeddings
(B, S, d_model); the transformer BACKBONE is modeled here.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, hidden_act="silu", rope_theta=1_000_000.0,
    rope_type="mrope", mrope_sections=(16, 24, 24), input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=512, hidden_act="silu", rope_type="mrope",
    mrope_sections=(2, 1, 1), input_mode="embeddings",
    use_kernels=False, dtype="float32",
)
