"""mamba2-130m [ssm] — SSD, attention-free [arXiv:2405.21060].
24L d_model=768 d_ff=0 vocab=50280 ssm_state=128."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, vocab_size=50_280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, ssm_groups=1,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=128,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
)

register(FULL, SMOKE)
