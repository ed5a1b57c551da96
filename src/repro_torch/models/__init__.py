"""Model zoo of the port: the dense, MoE, SSM and hybrid families."""
from .api import get_model

__all__ = ["get_model"]
