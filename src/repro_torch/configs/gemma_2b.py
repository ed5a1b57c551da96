"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295].
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, vocab_size=256_000,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16_384,
    activation="gelu",
    tie_embeddings=True, scale_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
)

register(FULL, SMOKE)
