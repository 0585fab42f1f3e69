"""xlstm-125m [ssm]: 12L d768 4H v50304 — alternating mLSTM/sLSTM blocks.

[arXiv:2405.04517] Pre-up-projection mLSTM (matrix memory, chunkwise
parallel) + post-FFN sLSTM (scalar memory, strictly sequential).  d_ff=0:
blocks are self-contained.  Sub-quadratic => runs long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304, block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=512, block_pattern=("mlstm", "slstm"),
    tie_embeddings=True, use_kernels=False, dtype="float32",
)
