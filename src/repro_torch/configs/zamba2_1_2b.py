"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242]. 38L d_model=2048 32H d_ff=8192 vocab=32000 ssm_state=64."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, vocab_size=32_000,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, ssm_groups=1,
    attn_every=6,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=5, d_model=64, vocab_size=128,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    attn_every=2,
)

register(FULL, SMOKE)
