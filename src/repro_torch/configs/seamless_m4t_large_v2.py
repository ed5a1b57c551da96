"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].
24L(enc)+24L(dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Speech frontend is a STUB: the model takes precomputed frame embeddings
(dim 1024); the dense decode cache holds mem_len = max_len / 8 memory
positions unless told otherwise."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, vocab_size=256_206,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192,
    is_encoder_decoder=True,
    frontend="audio_stub", frontend_dim=1024,
)

SMOKE = FULL.replace(
    n_layers=2, n_enc_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    frontend_dim=32,
)

register(FULL, SMOKE)
