"""Plain-PyTorch oracle for the TCEC GEMM.

An independent, loop-free restatement of the paper's corrected GEMM
(Eqs. 19-24 generalized to k-way splits): split both operands with RN casts
and residual scaling, run one low-precision-in / f32-out product per kept
term pair, sum same-scale products in f32, fold the scaled epilogue
smallest-first.  Also the f64 ground truth used by Eq. (7) residuals.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy import get_policy
from repro_torch.core.split import _cast_rn


def tcec_matmul_ref(a, b, policy_name: str):
    """(M, K) @ (K, N) -> (M, N) f32 — the kernel's correctness oracle."""
    policy = get_policy(policy_name)
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    scale = 2.0 ** policy.scale_bits

    def splits(x):
        parts, r = [], x
        for i in range(policy.n_splits):
            p = _cast_rn(r, policy.tdtype)
            parts.append(p)
            if i + 1 < policy.n_splits:
                r = (r - p.float()) * scale
        return parts

    sa, sb = splits(a), splits(b)
    groups: dict[int, torch.Tensor] = {}
    for (i, j) in policy.keep:
        t = sa[i].float() @ sb[j].float()
        g = i + j
        groups[g] = t if g not in groups else groups[g] + t
    keys = sorted(groups)
    out = groups[keys[-1]]
    inv = 2.0 ** (-policy.scale_bits)
    for g in reversed(keys[:-1]):
        out = groups[g] + out * inv
    return out


def tcec_bmm_ref(a, b, policy_name: str):
    """Batched oracle: (B, M, K) @ (B, K, N) -> (B, M, N) f32."""
    return torch.stack([tcec_matmul_ref(a[i], b[i], policy_name)
                        for i in range(a.shape[0])])


def epilogue_ref(out, bias=None, activation: str | None = None,
                 out_scale: float = 1.0):
    """The fused kernel's scaled epilogue, restated with the ops the
    unfused model path uses: ``act(out * out_scale + bias)``."""
    from .tcec_matmul import EPILOGUE_ACTIVATIONS
    out = torch.as_tensor(out, dtype=torch.float32)
    if out_scale != 1.0:
        out = out * out_scale
    if bias is not None:
        out = out + torch.as_tensor(bias, dtype=torch.float32).reshape(1, -1)
    return EPILOGUE_ACTIVATIONS[activation](out)


def matmul_f64(a, b) -> np.ndarray:
    """Ground truth for Eq. (7) relative residuals."""
    def host(x):
        return x.double().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, dtype=np.float64)
    return host(a) @ host(b)
