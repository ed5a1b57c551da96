"""Core numerics: precision splitting and the policy-routed GEMM."""
from .policy import (POLICIES, EinsumParseError, PrecisionPolicy, full_keep,
                     get_policy, pdot, policy_bmm, policy_mm,
                     triangular_keep)
from .split import MANTISSA_BITS, reconstruct, split

__all__ = ["POLICIES", "EinsumParseError", "PrecisionPolicy", "full_keep",
           "get_policy", "pdot", "policy_bmm", "policy_mm", "triangular_keep",
           "MANTISSA_BITS", "reconstruct", "split"]
