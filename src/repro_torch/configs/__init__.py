"""Architecture registry of the port, every config of the JAX package:
the dense family qwen3-0.6b, gemma-2b, gemma2-9b and qwen2.5-14b; the MoE
family granite-moe-1b-a400m and deepseek-v3-671b (MLA attention, a shared
expert and the multi-token-prediction head); mamba2-130m (SSM),
zamba2-1.2b (hybrid), seamless-m4t-large-v2 (enc-dec, ``audio``) and
internvl2-2b (VLM)."""
from .base import (LONG_CONTEXT_ARCHS, SHAPES, ModelConfig, ShapeConfig,
                   get_config, get_smoke_config, list_archs, register)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "LONG_CONTEXT_ARCHS",
           "get_config", "get_smoke_config", "list_archs", "register"]
