"""Model zoo of the port (the dense and MoE families so far)."""
from .api import get_model

__all__ = ["get_model"]
