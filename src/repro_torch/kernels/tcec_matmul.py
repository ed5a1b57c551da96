"""Kernel 1: the TCEC GEMM — an f32-accurate product from bf16 tensor cores.

Counterpart of ``repro/kernels/tcec_matmul.py::_kernel``.  The CUDA kernel
(``csrc/tcec_matmul.cu``) has two paths under one entry, chosen by M: for
M above :func:`skinny_max` (prefill) a warp-specialised wgmma kernel, for
smaller M (decode, M = slots; short prefills) a kernel that streams the
weight once.  Both split the f32 operands into bf16 terms on chip, run
every kept term product on the tensor cores into a zeroed fragment, add it
in f32 into the accumulator of its scale group, fold the groups
smallest-first and apply ``out_scale`` -> bias -> activation before their
one store.

:func:`tcec_matmul_plain` is the same function in plain PyTorch: split,
each kept pass as an f32 ``torch.matmul`` of the upcast terms (exact
products), per-group sums, smallest-first fold, epilogue.  The CPU tests run
it; on the card ``chip_smoke.py`` holds the kernel against it.

``launches`` counts kernel launches (one per :func:`launch`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.policy import (PrecisionPolicy, get_policy,
                                     triangular_keep)
from . import _build

# Activations the fused epilogue supports — the same callables the unfused
# model path uses.  gelu is the tanh approximation, as jax.nn.gelu is.
EPILOGUE_ACTIVATIONS = {
    None: lambda x: x,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}
# the ids csrc/tcec_common.cuh::activate switches on
ACTIVATION_IDS = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}

launches = 0
# (n_splits, scale_bits) of each policy name the kernel took
_SPLITS: dict[str, tuple[int, int]] = {}


@functools.lru_cache(maxsize=None)
def takes_policy(policy: PrecisionPolicy) -> bool:
    """The kernels take bf16 split policies on the triangular schedule with
    2 to 4 terms (x3, x6, x10); dispatch routes exactly these."""
    return (not policy.is_plain() and policy.dtype == "bfloat16"
            and not policy.upcast_products and not policy.compensated
            and set(policy.keep) == set(triangular_keep(policy.n_splits))
            and 2 <= policy.n_splits <= 4)


def check_policy(policy: PrecisionPolicy) -> None:
    if not takes_policy(policy):
        raise ValueError(f"policy {policy.name!r} is not a bf16 triangular "
                         "split policy; the TCEC kernels do not take it")


def split_tile(x: torch.Tensor, n_splits: int, scale_bits: int):
    """Split an f32 tensor into ``n_splits`` bf16 terms (Eqs. 19-22)."""
    scale = 2.0 ** scale_bits
    parts = []
    r = x
    for i in range(n_splits):
        a = r.to(torch.bfloat16)
        parts.append(a)
        if i + 1 < n_splits:
            r = (r - a.float()) * scale
    return parts


def fold(parts: list, scale_bits: int):
    """Fold per-group sums smallest-first: ``out = part_g + out * 2^-s``."""
    inv = 2.0 ** (-scale_bits)
    out = parts[-1]
    for part in parts[-2::-1]:
        out = part + out * inv
    return out


def epilogue(out, bias=None, activation=None, out_scale: float = 1.0):
    """``act(out * out_scale + bias)`` — the kernel's scaled epilogue."""
    if out_scale != 1.0:
        out = out * out_scale
    if bias is not None:
        out = out + bias
    return EPILOGUE_ACTIVATIONS[activation](out)


def tcec_matmul_plain(a, b, policy="tcec_bf16x6", bias=None, activation=None,
                      out_scale: float = 1.0):
    """Kernel 1's function in plain PyTorch: ``(M, K) @ (K, N)`` or batched
    ``(B, M, K) @ (B, K, N)`` -> f32, with the fused epilogue."""
    pol = get_policy(policy)
    check_policy(pol)
    sa = [t.float() for t in split_tile(a.float(), pol.n_splits,
                                        pol.scale_bits)]
    sb = [t.float() for t in split_tile(b.float(), pol.n_splits,
                                        pol.scale_bits)]
    parts: dict[int, torch.Tensor] = {}
    for (i, j) in pol.keep:
        t = torch.matmul(sa[i], sb[j])
        g = i + j
        parts[g] = t if g not in parts else parts[g] + t
    out = fold([parts[g] for g in pol.groups], pol.scale_bits)
    return epilogue(out, bias, activation, out_scale)


# a, b, bias, c; batch, M, N, K, trans_b, n_splits, scale_bits; out_scale;
# activation; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def launch(a, b, policy="tcec_bf16x6", bias=None, activation=None,
           out_scale: float = 1.0):
    """Launch the CUDA kernel on contiguous f32 CUDA operands.

    ``b`` may also be the transpose of a contiguous ``(.., N, K)`` tensor
    (the tied unembedding reads the embedding table in place)."""
    global launches
    # this runs ~200 times a decode step: few Python objects on its path
    splits = _SPLITS.get(policy) if isinstance(policy, str) else None
    if splits is None:
        pol = get_policy(policy)
        check_policy(pol)
        splits = (pol.n_splits, pol.scale_bits)
        if isinstance(policy, str):
            _SPLITS[policy] = splits
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    f32 = torch.float32
    if a.dtype is not f32 or b.dtype is not f32 or (
            bias is not None and bias.dtype is not f32):
        raise TypeError("a, b and bias must be float32, got "
                        f"{a.dtype}, {b.dtype}, "
                        f"{None if bias is None else bias.dtype}")
    dev = a.get_device()
    if dev < 0 or b.get_device() != dev or (bias is not None
                                            and bias.get_device() != dev):
        raise ValueError("a, b and bias must lie on one CUDA device")
    ash, bsh = a.shape, b.shape
    if not 2 <= len(ash) <= 3 or len(bsh) != len(ash):
        raise ValueError(f"expected 2-D or batched 3-D operands, got "
                         f"{tuple(ash)} @ {tuple(bsh)}")
    *bdims, M, K = ash
    *bdims2, K2, N = bsh
    batch = bdims[0] if bdims else 1
    if K != K2 or bdims != bdims2:
        raise ValueError(f"shape mismatch {tuple(ash)} @ {tuple(bsh)}")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    if b.is_contiguous():
        trans_b = 0
    elif b.stride()[-2:] == (1, K) and (not bdims or b.stride(0) == N * K) \
            or b.transpose(-1, -2).is_contiguous():
        trans_b = 1
    else:
        raise ValueError("b must be contiguous or the transpose of a "
                         "contiguous tensor")
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({N},) vector")
    out = a.new_empty((*bdims, M, N))
    if out.numel() == 0:
        return out
    status = _build.entry("tcec_matmul", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), batch, M, N, K, trans_b, *splits, out_scale,
        ACTIVATION_IDS[activation],
        _build.stream(a))
    _build.check("tcec_matmul", status)
    launches += 1
    return out


def skinny_max() -> int:
    """The largest M that the kernel runs on its decode path (read from the
    CUDA source, where the threshold lives)."""
    fn = _build.library("tcec_matmul").tcec_matmul_skinny_max
    fn.restype = ctypes.c_int
    return fn()


def path(M: int) -> str:
    """Which of the kernel's paths a product with M rows takes."""
    return "skinny" if M <= skinny_max() else "wgmma"


def grid(M: int, N: int, batch: int = 1, trans_b: bool = False,
         policy="tcec_bf16x6"):
    """``(blocks, blocks resident per SM)`` of a launch at these shapes."""
    pol = get_policy(policy)
    check_policy(pol)
    fn = _build.library("tcec_matmul").tcec_matmul_grid
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    _build.check("tcec_matmul", fn(M, N, batch, int(trans_b), pol.n_splits,
                                   out))
    return out[0], out[1]
