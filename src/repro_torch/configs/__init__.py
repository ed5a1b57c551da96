"""Architecture registry of the port: qwen3-0.6b (dense),
granite-moe-1b-a400m (MoE), mamba2-130m (SSM), zamba2-1.2b (hybrid),
seamless-m4t-large-v2 (enc-dec, ``audio``) and internvl2-2b (VLM): one
config of each family of the JAX package."""
from .base import (ModelConfig, get_config, get_smoke_config, list_archs,
                   register)

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register"]
