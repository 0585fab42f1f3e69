"""hubert-xlarge [audio]: 48L d1280 16H ff5120 v504 — encoder-only.

[arXiv:2106.07447] Same backbone as wav2vec2; the CNN feature extractor is
a STUB: input_specs() provides precomputed frame embeddings (B, S, d).
Masked-unit prediction over 504 cluster targets.  No decode shapes.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, hidden_act="gelu", causal=False,
    input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=32, hidden_act="gelu", causal=False,
    input_mode="embeddings", use_kernels=False, dtype="float32",
)
