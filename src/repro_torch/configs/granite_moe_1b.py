"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].
24L d_model=1024 16H (GQA kv=8) moe_d_ff=512 vocab=49155."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, vocab_size=49_155,
    n_heads=16, n_kv_heads=8, head_dim=64,
    n_experts=32, moe_top_k=8, moe_d_ff=512,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=128,
    n_heads=4, n_kv_heads=2, head_dim=16,
    n_experts=4, moe_top_k=2, moe_d_ff=32, moe_group_size=64,
)

register(FULL, SMOKE)
