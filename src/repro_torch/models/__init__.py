"""Model zoo of the port: the dense, MoE, SSM, hybrid, enc-dec (audio)
and VLM families."""
from .api import get_model

__all__ = ["get_model"]
