"""internvl2-2b [vlm] — InternViT (STUB frontend) + InternLM2 backbone
[arXiv:2404.16821]. 24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92553.
The model takes precomputed patch embeddings (dim 1024, 256 an image)."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, vocab_size=92_553,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192,
    frontend="vision_stub", frontend_dim=1024, n_frontend_tokens=256,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    frontend_dim=32, n_frontend_tokens=8,
)

register(FULL, SMOKE)
