"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-0.6B].
28L d_model=1024 16H (kv=8) d_ff=3072 vocab=151936."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, vocab_size=151_936,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072,
    qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
)

register(FULL, SMOKE)
