"""Carry parameters and arrays between numpy (and so JAX) and the port.

``torch`` cannot reproduce ``jax.random``, so the parity tests build a
model (and its optimizer state) with the JAX package, turn its leaves into
numpy arrays and hand them here.  numpy has no native bf16 or fp8: those
dtypes (from
``ml_dtypes``, as JAX makes them) are moved bit for bit through uint16 /
uint8 views, so the round trip is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# numpy dtype name -> (same-width integer view, torch dtype)
_NARROW = {
    "bfloat16": (np.int16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.uint8, torch.float8_e5m2),
}
_TORCH_NARROW = {tdt: (ti, ni) for ni, ti, tdt in _NARROW.values()}


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """An exact torch copy of ``arr`` (bf16 and fp8 included)."""
    arr = np.asarray(arr, order="C")      # keeps 0-d arrays 0-d
    narrow = _NARROW.get(arr.dtype.name)
    if narrow is None:
        return torch.from_numpy(arr.copy()).to(device)
    np_int, _, tdt = narrow
    return torch.from_numpy(arr.view(np_int).copy()).view(tdt).to(device)


def numpy_from_tensor(t: torch.Tensor, np_dtype=None) -> np.ndarray:
    """An exact numpy copy of ``t``.  bf16 / fp8 tensors come back as their
    raw bits (int16 / uint8) unless ``np_dtype`` (e.g. ``ml_dtypes.bfloat16``)
    is given to view them as."""
    t = t.detach().cpu().contiguous()
    narrow = _TORCH_NARROW.get(t.dtype)
    if narrow is None:
        return t.numpy().copy()
    t_int, np_int = narrow
    bits = t.view(t_int).numpy().view(np_int).copy()
    return bits.view(np_dtype) if np_dtype is not None else bits


def params_from_jax(tree, device=None):
    """Map a JAX tree of nested dicts whose leaves are numpy or JAX arrays
    onto the port's tree, key for key and bit for bit: an ``lm.init``
    parameter tree, or a whole train state ``{"params", "opt"}`` whose
    AdamW state ``{"m", "v", "step"}`` keeps its dtypes (the int32 step,
    bf16 moments, factored ``{"row", "col"}`` second moments)."""
    dev = resolve_device(device)

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return go(tree)

