"""Model configuration schema and the --arch registry.

``ModelConfig`` is a field-for-field copy of the JAX package's
``repro/configs/base.py`` (the port keeps its own copy, so it never imports
the JAX package); the tests hold the two field lists equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    # attention ------------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None   # window for local layers
    local_global_period: int = 0        # gemma2: 2 => alternate local/global
    sandwich_norms: bool = False        # gemma2 pre+post norms
    scale_embeddings: bool = False      # gemma: x *= sqrt(d_model)
    rope_theta: float = 10_000.0
    # mlp -------------------------------------------------------------------
    d_ff: int = 0
    activation: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    # MLA (deepseek) ---------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # MoE ---------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD) -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # hybrid (zamba2) ------------------------------------------------------------
    attn_every: int = 0                 # shared attn block period
    # enc-dec (seamless) ----------------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    # modality frontend stubs ------------------------------------------------------
    frontend: str | None = None         # vision_stub | audio_stub
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    # extras ---------------------------------------------------------------------
    tie_embeddings: bool = False
    mtp: bool = False                   # deepseek multi-token prediction head
    norm_eps: float = 1e-6
    # numerics / perf -------------------------------------------------------------
    policy: str = "tcec_bf16x6"         # GEMM precision policy (the paper knob)
    logits_policy: str | None = None    # override for the logit matmul
    attn_policy: str | None = None      # override for sequence-mixing dots
                                        # (scores/PV/SSD-chunk) — the
                                        # beyond-paper tcec_mixed knob
    remat: bool = True
    shard_mode: str = "tp"              # tp | fsdp_tp
    dp_over_model: bool = False         # small models: replicate params,
                                        # use the model axis as extra DP
    ep_mode: str = "1d"                 # 1d: experts on model | 2d: experts
                                        # on model x data (no FSDP gathers)
    moe_group_size: int = 0             # 0 = auto

    @property
    def mix_policy(self) -> str:
        return self.attn_policy or self.policy

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_rep(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 so the logit dim shards on any
        mesh (the standard MaxText/Megatron vocab-padding trick)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def moe_groups(self) -> int:
        if self.moe_group_size:
            return self.moe_group_size
        return min(512, max(64, self.moe_d_ff // 4))


@dataclass(frozen=True)
class ShapeConfig:
    """One (shape) cell of the JAX package's grid: sequence length, global
    batch and kind (``train`` | ``prefill`` | ``decode``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# the archs whose long_500k cell runs (sub-quadratic sequence mixing); the
# dry run records a documented skip for every other arch there
LONG_CONTEXT_ARCHS = {"mamba2-130m", "zamba2-1.2b"}


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from . import (deepseek_v3_671b, gemma2_9b, gemma_2b,  # noqa: F401
                   granite_moe_1b, internvl2_2b, mamba2_130m, qwen2_5_14b,
                   qwen3_0_6b, seamless_m4t_large_v2, zamba2_1_2b)
