"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]. 61L d_model=7168 128H moe_d_ff=2048 vocab=129280."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, vocab_size=129_280,
    n_heads=128, n_kv_heads=128, head_dim=192,     # qk dim = nope+rope
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    d_ff=18_432,                                   # first dense layers
    n_experts=256, n_shared_experts=1, moe_top_k=8, moe_d_ff=2048,
    first_dense_layers=3,
    mtp=True,
    rope_theta=10_000.0,
    shard_mode="fsdp_tp",
)

SMOKE = FULL.replace(
    n_layers=3, d_model=64, vocab_size=256,
    n_heads=4, n_kv_heads=4, head_dim=24,
    q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
    v_head_dim=16,
    d_ff=128, n_experts=4, moe_top_k=2, moe_d_ff=32,
    first_dense_layers=1, moe_group_size=64, shard_mode="tp",
)

register(FULL, SMOKE)
