"""Precision splitting — the paper's Eqs. (2)-(5) / (19)-(22), generalized.

An FP32 value ``v`` is decomposed into ``n`` low-precision terms

    v  ~=  a_0  +  a_1 * 2**-s  +  a_2 * 2**-2s  + ...

where each ``a_i`` is stored in a narrow dtype and ``s`` is the scale shift
applied to each residual before the narrowing cast (the paper's ``x 2**11``
of Eq. (18); ``s = mantissa bits + 1`` of the target dtype in the policies).

All casts use round-to-nearest-even (RN); the RZ variant reproduces the
paper's Table 2 analysis.
"""
from __future__ import annotations

import torch

# Mantissa bits (explicit, excluding the implicit leading 1) per storage dtype.
MANTISSA_BITS = {
    torch.bfloat16: 7,
    torch.float16: 10,
    torch.float32: 23,
    torch.float8_e4m3fn: 3,
    torch.float8_e5m2: 2,
}

_BF16_RZ_MASK = -65536          # 0xFFFF0000 as a signed 32-bit integer
# e4m3fn has no infinity: a value that rounds past its largest finite 448
# (anything beyond the 464 tie) becomes NaN in ml_dtypes, and so in JAX,
# where torch's cast saturates to 448
_E4M3FN_TIE = 464.0


def _cast_rn(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round-to-nearest-even cast with the JAX package's overflow rules."""
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > _E4M3FN_TIE, float("nan"), x)
    return x.to(dtype)


def _cast_rz(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round-toward-zero cast of f32 -> {bf16, f16} (Table-2 analysis).

    bf16 is the upper 16 bits of f32, so RZ is a plain mask.  f16 RZ clears
    the low mantissa bits after aligning to the f16 quantum via
    frexp/ldexp, which is exact for normal numbers.
    """
    if dtype == torch.bfloat16:
        bits = x.float().contiguous().view(torch.int32) & _BF16_RZ_MASK
        return bits.view(torch.float32).to(torch.bfloat16)
    if dtype == torch.float16:
        m, e = torch.frexp(x.float())
        p = 11  # implicit + 10 explicit
        t = torch.trunc(m * (2.0 ** p))
        return torch.ldexp(t, (e - p).float()).to(torch.float16)
    raise ValueError(f"unsupported RZ cast target {dtype}")


def split(x: torch.Tensor, dtype, n_splits: int, scale_bits: int,
          rounding: str = "rn") -> list[torch.Tensor]:
    """Split f32 ``x`` into ``n_splits`` terms of ``dtype``.

    Returns ``[a_0, ..., a_{n-1}]`` with
    ``x ~= sum_i f32(a_i) * 2**(-i*scale_bits)``.  The scale is applied to
    each residual before the cast (exponent-only, exact).
    """
    x = x.float()
    if rounding == "rn":
        def cast(v):
            return _cast_rn(v, dtype)
    else:
        def cast(v):
            return _cast_rz(v, dtype)
    scale = 2.0 ** scale_bits
    out = []
    r = x
    for i in range(n_splits):
        a = cast(r)
        out.append(a)
        if i + 1 < n_splits:
            r = (r - a.float()) * scale
    return out


def reconstruct(parts: list[torch.Tensor], scale_bits: int) -> torch.Tensor:
    """Inverse of :func:`split` (up to representation error) in f32,
    folded smallest term first."""
    acc = torch.zeros_like(parts[-1], dtype=torch.float32)
    for i, a in reversed(list(enumerate(parts))):
        acc = acc + a.float() * (2.0 ** (-i * scale_bits))
    return acc
