"""Architecture registry of the port: qwen3-0.6b (dense),
granite-moe-1b-a400m (MoE), mamba2-130m (SSM) and zamba2-1.2b (hybrid)
so far."""
from .base import (ModelConfig, get_config, get_smoke_config, list_archs,
                   register)

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register"]
