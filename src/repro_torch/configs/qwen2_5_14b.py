"""qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-14B].
48L d_model=5120 40H (kv=8) d_ff=13824 vocab=152064."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, vocab_size=152_064,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=13_824,
    qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
)

register(FULL, SMOKE)
