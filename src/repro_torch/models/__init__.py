"""Model zoo of the port (dense family so far)."""
from .api import get_model

__all__ = ["get_model"]
