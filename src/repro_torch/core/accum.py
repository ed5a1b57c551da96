"""Tensor-Core accumulator rounding simulators (paper Fig. 5 / Eq. 11).

The paper isolates the cause of Markidis-method error with two software
matrix-multiply-accumulate models: products in full precision, a 25-bit
accumulator (f32 + >=2 guard bits, per Fasi et al.), and the post-addition
rounding performed with RN (``mma_rn``) or RZ (``mma_rz``, what real Tensor
Cores do).  ``mma_rn`` reproduces SGEMM accuracy under Markidis' split while
``mma_rz`` reproduces Markidis' degraded accuracy — the smoking gun that moved
the paper to accumulate *outside* the matrix unit.

Implemented in numpy float64 with explicit mantissa re-quantization after
every accumulate; the k-loop is a host loop (analysis tool, small sizes).
A copy of the JAX package's ``core/accum.py`` (numpy only): the same
inputs give bitwise the same results.
"""
from __future__ import annotations

import numpy as np

ACC_BITS = 25  # f32 mantissa (24 incl. implicit) + guard bit, per the paper


def _round_to_bits(x: np.ndarray, p: int, mode: str) -> np.ndarray:
    """Requantize f64 mantissas to ``p`` bits with RN (ties-even) or RZ."""
    m, e = np.frexp(x)          # x = m * 2**e, |m| in [0.5, 1)
    s = m * (2.0 ** p)
    if mode == "rn":
        t = np.rint(s)          # ties-to-even
    elif mode == "rz":
        t = np.trunc(s)
    else:
        raise ValueError(mode)
    return np.ldexp(t, e - p)


def mma_sim(a_lp: np.ndarray, b_lp: np.ndarray, c: np.ndarray,
            mode: str, acc_bits: int = ACC_BITS) -> np.ndarray:
    """D <- A_lp x B_lp + C with per-element-accumulate rounding (Eq. 11).

    ``a_lp``/``b_lp`` are already low-precision-valued (any float dtype);
    products are exact (f64), the accumulator is requantized to ``acc_bits``
    after *every* element addition, starting from the addition of C —
    matching the paper's description of the TC pipeline.
    """
    a = np.asarray(a_lp, dtype=np.float64)
    b = np.asarray(b_lp, dtype=np.float64)
    acc = _round_to_bits(np.asarray(c, dtype=np.float64), acc_bits, mode)
    for k in range(a.shape[-1]):
        prod = a[..., :, k, None] * b[..., None, k, :]
        acc = _round_to_bits(acc + prod, acc_bits, mode)
    return acc


def markidis_gemm_sim(a32: np.ndarray, b32: np.ndarray, mode: str,
                      chain: bool = True) -> np.ndarray:
    """Markidis' 4-term corrected GEMM on the simulated accumulator.

    ``chain=True`` chains all four mma calls through one accumulator
    (paper Code 2 — rounding mode applies between terms too); this is the
    configuration of Fig. 5.
    """
    a_hi = a32.astype(np.float16)
    da = (a32 - a_hi.astype(np.float32)).astype(np.float16)
    b_hi = b32.astype(np.float16)
    db = (b32 - b_hi.astype(np.float32)).astype(np.float16)
    c = np.zeros(a32.shape[:-1] + (b32.shape[-1],), dtype=np.float64)
    terms = [(da, db), (da, b_hi), (a_hi, db), (a_hi, b_hi)]
    if not chain:
        return sum(mma_sim(x, y, np.zeros_like(c), mode) for x, y in terms)
    for x, y in terms:
        c = mma_sim(x, y, c, mode)
    return c
