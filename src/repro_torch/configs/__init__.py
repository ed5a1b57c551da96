"""Architecture registry of the port: qwen3-0.6b (dense) and
granite-moe-1b-a400m (MoE) so far."""
from .base import (ModelConfig, get_config, get_smoke_config, list_archs,
                   register)

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "register"]
