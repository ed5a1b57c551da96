"""Input-matrix generators for the paper's accuracy experiments.

``exp_rand`` implements Eq. (25); ``randtlr`` / ``spatial`` / ``cauchy``
reproduce the STARS-H exponent patterns of Figs. 12-13 (tile-low-rank random,
exponential spatial-statistics kernel, Cauchy matrix).  A copy of the JAX
package's ``core/matgen.py`` (numpy only): the same seeds give bitwise the
same arrays.
"""
from __future__ import annotations

import numpy as np


def urand(shape, lo=-1.0, hi=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def exp_rand(shape, a: int, b: int, seed=0):
    """Eq. (25): exponent ~ U[a, b], mantissa ~ U[1, 2), random sign."""
    rng = np.random.default_rng(seed)
    e = rng.integers(a, b + 1, size=shape)
    m = rng.uniform(1.0, 2.0, size=shape)
    s = rng.integers(0, 2, size=shape) * 2 - 1
    return (s * np.exp2(e.astype(np.float64)) * m).astype(np.float32)


def randtlr(n: int, rank: int = 8, tile: int = 64, decay: float = 0.5, seed=0):
    """Random synthetic tile-low-rank matrix (STARS-H ``randtlr``)."""
    rng = np.random.default_rng(seed)
    nt = (n + tile - 1) // tile
    out = np.zeros((nt * tile, nt * tile), dtype=np.float64)
    for i in range(nt):
        for j in range(nt):
            u = rng.standard_normal((tile, rank))
            v = rng.standard_normal((rank, tile))
            mag = decay ** abs(i - j)
            out[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = mag * (u @ v) / rank
    return out[:n, :n].astype(np.float32)


def spatial(n: int, corr_len: float = 0.1, seed=0):
    """Exponential covariance kernel over random 2-D points (STARS-H ``spatial``)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, size=(n, 2))
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    return np.exp(-d / corr_len).astype(np.float32)


def cauchy(n: int, seed=0):
    """Cauchy matrix 1 / (x_i - y_j) with separated generators."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, size=n))
    y = np.sort(rng.uniform(1.5, 2.5, size=n))
    return (1.0 / (x[:, None] - y[None, :])).astype(np.float32)


def relative_residual(c_test: np.ndarray, a32: np.ndarray, b32: np.ndarray) -> float:
    """Paper Eq. (7): ||C_f64 - C_test||_F / ||C_f64||_F."""
    ref = a32.astype(np.float64) @ b32.astype(np.float64)
    num = np.linalg.norm(ref - np.asarray(c_test, dtype=np.float64))
    return float(num / np.linalg.norm(ref))
