"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118]. 42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, vocab_size=256_000,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14_336,
    activation="gelu",
    sliding_window=4096, local_global_period=2,
    attn_softcap=50.0, final_softcap=30.0,
    sandwich_norms=True,
    tie_embeddings=True, scale_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    sliding_window=8,
)

register(FULL, SMOKE)
