"""Kernel 1: the TCEC GEMM — an f32-accurate product from bf16 tensor cores.

Counterpart of ``repro/kernels/tcec_matmul.py::_kernel``.  The CUDA kernel
(``csrc/tcec_matmul.cu``) has two paths under one entry: path W, a
warp-specialised wgmma kernel (prefill), and path S, a kernel that streams
the weight once (decode, M = slots; short prefills).  A launch names its
path (``path=``, or a tile of :func:`tiles` through ``ops.tcec_matmul``'s
``block=``: the autotuner's choice, ``kernels/tuning.py``) or takes the
rule by M (path S up to :func:`skinny_max`).  Both split the f32 operands
into bf16 terms on chip, run
every kept term product on the tensor cores into a zeroed fragment, add it
in f32 into the accumulator of its scale group, fold the groups
smallest-first and apply ``out_scale`` -> bias -> activation before their
one store.

:func:`tcec_matmul_plain` is the same function in plain PyTorch: split,
each kept pass as an f32 ``torch.matmul`` of the upcast terms (exact
products), per-group sums, smallest-first fold, epilogue.  The CPU tests run
it; on the card ``chip_smoke.py`` holds the kernel against it.

``launches`` counts kernel launches (one per :func:`launch`),
``epilogue_launches`` those of them that fused an activation, by its name,
and ``folded_launches`` those on path S whose blocks each hold more than
one group of 8 slots (:func:`groups_per_block`).  The autotuner's
measurement launches go through :func:`enqueue`, which counts nothing here
(``tuning.measure_launches`` counts them).
"""
from __future__ import annotations

import ctypes
import functools
import math
import re

import torch
import torch.nn.functional as F

from repro_torch.core.policy import (PrecisionPolicy, get_policy,
                                     triangular_keep)
from . import _build, meta

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
folded_launches = 0
epilogue_launches = {name: 0 for name in ACTIVATION_IDS if name}
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
    """Split an f32 tensor into ``n_splits`` bf16 terms (Eqs. 19-22).  The
    residual is one f32 tensor beside ``x``, updated in place (a bf16 term
    is subtracted exactly, upcast by type promotion)."""
    scale = 2.0 ** scale_bits
    parts = []
    r = x
    for i in range(n_splits):
        a = r.to(torch.bfloat16)
        parts.append(a)
        if i + 1 < n_splits:
            r = (r - a) if r is x else r.sub_(a)
            r.mul_(scale)
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


# The most bytes of f32 term copies of B that the plain version holds at
# once: a larger batched B is taken a slice of its batch at a time (a
# deepseek-v3-671b expert stack is 15 GB, its three copies 45 GB).
PLAIN_CHUNK_BYTES = 2 * 2 ** 30


def tcec_matmul_plain(a, b, policy="tcec_bf16x6", bias=None, activation=None,
                      out_scale: float = 1.0):
    """Kernel 1's function in plain PyTorch: ``(M, K) @ (K, N)`` or batched
    ``(B, M, K) @ (B, K, N)`` -> f32, with the fused epilogue.  A batched
    product whose B terms would pass ``PLAIN_CHUNK_BYTES`` is taken in
    slices of the batch, bit for bit the same products."""
    if meta.is_meta(a):
        return tcec_matmul_meta(a, b, policy, bias)
    pol = get_policy(policy)
    check_policy(pol)
    step = b.shape[0]
    if a.ndim == 3 and b.ndim == 3 and b.numel():
        step = max(1, PLAIN_CHUNK_BYTES // (pol.n_splits * 4 * b[0].numel()))
    if step >= b.shape[0]:
        out = _plain(a, b, pol)
    else:
        out = torch.empty((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                          device=a.device)
        for i in range(0, b.shape[0], step):
            out[i:i + step] = _plain(a[i:i + step], b[i:i + step], pol)
    # the epilogue once over the whole: its activations are not bitwise
    # the same on slices of another length
    return epilogue(out, bias, activation, out_scale)


def tcec_matmul_meta(a, b, policy="tcec_bf16x6", bias=None):
    """The ``meta`` route (``kernels/meta.py``): an empty f32 result and
    one record, kept terms x 2 batch M N K FLOPs; nothing launches and no
    plain version runs."""
    pol = get_policy(policy)
    check_policy(pol)
    *bdims, M, K = a.shape
    N = b.shape[-1]
    out = a.new_empty((*bdims, M, N), dtype=torch.float32)
    terms = len(pol.keep)
    meta.record(meta.KernelRecord(
        "tcec_matmul", (tuple(a.shape), tuple(b.shape)), pol.name, terms,
        float(terms) * 2 * math.prod(bdims) * M * N * K,
        float(meta.nbytes(a, b, bias, out))))
    return out


def _plain(a, b, pol):
    """The folded product: each kept term product as an f32 ``matmul`` of
    the upcast terms, summed per group in ``keep`` order.  B's terms are
    kept in bf16 and upcast one at a time."""
    sa = [t.float() for t in split_tile(a.float(), pol.n_splits,
                                        pol.scale_bits)]
    tb = split_tile(b.float(), pol.n_splits, pol.scale_bits)
    prods = {}
    for j in range(pol.n_splits):
        bj = tb[j].float()
        for (i, jj) in pol.keep:
            if jj == j:
                prods[i, j] = torch.matmul(sa[i], bj)
        del bj
    parts: dict[int, torch.Tensor] = {}
    for (i, j) in pol.keep:
        t = prods.pop((i, j))
        g = i + j
        parts[g] = t if g not in parts else parts[g] + t
    return fold([parts[g] for g in pol.groups], pol.scale_bits)


# a, b, bias, c; batch, M, N, K, trans_b; B's batch stride; B's row stride,
# n_splits, scale_bits; out_scale; activation; path; stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

# The kernel's paths, by the index the C entry takes (-1: by M).
PATHS = ("skinny", "wgmma")


def b_layout(b) -> tuple[int, int, int] | None:
    """``(trans_b, batch stride, row stride)`` in which the kernel reads
    ``b`` (``(K, N)`` or ``(batch, K, N)``) where it lies, or None when it
    cannot.  Its rows of N contiguous: ``trans_b`` 0 (a contiguous B); its
    columns of K contiguous: ``trans_b`` 1 (the transpose of a contiguous
    ``(N, K)``, as the tied unembedding reads the embedding table).  Any
    batch and row strides: MLA's per-head view of ``w_uv`` stored ``(K, H,
    N)`` has batch stride N and rows H N apart, that of ``w_uk`` stored
    ``(N, H, K)`` batch stride K and columns H K apart."""
    *bdims, K, N = b.shape
    st = b.stride()
    sb = st[0] if bdims else 0
    if N == 1 or st[-1] == 1:
        return 0, sb, N if K == 1 else st[-2]
    if K == 1 or st[-2] == 1:
        return 1, sb, st[-1]
    return None


def launch(a, b, policy="tcec_bf16x6", bias=None, activation=None,
           out_scale: float = 1.0, path: int | None = None):
    """Launch the CUDA kernel on f32 CUDA operands: ``a`` contiguous,
    ``b`` any tensor whose rows or columns are contiguous, read in place
    (:func:`b_layout`).  ``path``: 0 path S, 1 path W, None the rule by M.
    Counted in ``launches`` (and ``epilogue_launches``,
    ``folded_launches``)."""
    global launches, folded_launches
    out = enqueue(a, b, policy, bias, activation, out_scale, path)
    launches += 1
    if activation is not None:
        epilogue_launches[activation] += 1
    M = a.shape[-2]
    if M > tiles()["skinny"][0] and out.numel() and (
            M <= skinny_max() if path is None else path == 0):
        batch = a.shape[0] if a.ndim == 3 else 1
        if groups_per_block(M, b.shape[-1], batch, b_layout(b)[0], policy,
                            path) > 1:
            folded_launches += 1
    return out


def enqueue(a, b, policy="tcec_bf16x6", bias=None, activation=None,
            out_scale: float = 1.0, path: int | None = None, out=None):
    """:func:`launch` without its count, into ``out`` when given (the
    autotuner's measurements)."""
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
    layout = b_layout(b)
    if layout is None:
        raise ValueError(f"b of shape {tuple(bsh)} and strides {b.stride()}:"
                         " neither its rows nor its columns are contiguous")
    trans_b, sb, ldb = layout
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({N},) vector")
    if path not in (None, 0, 1):
        raise ValueError(f"path must be 0 (path S), 1 (path W) or None, "
                         f"got {path!r}")
    if out is None:
        out = a.new_empty((*bdims, M, N))
    elif out.shape != (*bdims, M, N) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {(*bdims, M, N)}")
    if out.numel() == 0:
        return out
    status = _build.entry("tcec_matmul", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), batch, M, N, K, trans_b, sb, ldb, *splits,
        out_scale,
        ACTIVATION_IDS[activation], -1 if path is None else path,
        _build.stream(a))
    _build.check("tcec_matmul", status)
    return out


def _int_constants(block: str) -> dict[str, int]:
    """The ``constexpr int`` declarations of a piece of C++ that are a
    product of literals and earlier names (``BKS = 16 * WARPS``)."""
    vals: dict[str, int] = {}
    for decl in re.findall(r"constexpr int ([^;(]+);", block):
        for part in decl.split(","):
            name, _, expr = part.partition("=")
            factors = [f.strip() for f in expr.split("*")]
            if all(f.isdigit() or f in vals for f in factors):
                vals[name.strip()] = math.prod(
                    int(f) if f.isdigit() else vals[f] for f in factors)
    return vals


@functools.lru_cache(maxsize=None)
def _source_constants() -> dict:
    """The threshold and the two paths' tiles, read from the CUDA source
    (pure Python, so the CPU has them too)."""
    text = (_build.CSRC / "tcec_matmul.cu").read_text()

    def namespace(name):
        m = re.search(rf"namespace {name} {{(.*?)}}  // namespace {name}",
                      text, re.S)
        return _int_constants(m.group(1))

    w, sk = namespace("wide"), namespace("skinny")
    return {"skinny_max": _int_constants(text)["SKINNY_MAX_M"],
            "tiles": {"skinny": (sk["SLOTS"], sk["BN"], sk["BKS"]),
                      "wgmma": (w["BM"], w["BN"], w["BK"])}}


def skinny_max() -> int:
    """The largest M that the rule by M runs on path S (read from the CUDA
    source, where the threshold lives)."""
    return _source_constants()["skinny_max"]


def tiles() -> dict[str, tuple[int, int, int]]:
    """Each path's tile ``(rows of A, columns of B, depth of a stage)``, as
    the CUDA source compiles them: path W ``(128, 64, 64)``, path S ``(8,
    16, 128)`` (8 slots, 16 weight rows, 128-deep stages).  These are the
    values of the numerics config's ``block``."""
    return _source_constants()["tiles"]


def block_path(block) -> int:
    """The C entry's path index of a tile of :func:`tiles`; any other
    triple raises ``ValueError``."""
    block = tuple(block)
    for i, name in enumerate(PATHS):
        if tiles()[name] == block:
            return i
    raise ValueError(f"kernel 1 has two tiles, {tiles()['wgmma']} (path W) "
                     f"and {tiles()['skinny']} (path S); got {block}")


def path(M: int) -> str:
    """Which of the kernel's paths the rule by M gives a product with M
    rows."""
    return "skinny" if M <= skinny_max() else "wgmma"


@functools.lru_cache(maxsize=None)
def _plan(M, N, batch, trans_b, n_splits, path):
    """The C entry's plan of a launch: blocks, blocks resident an SM, and
    path S's groups of 8 slots a block (0 on path W)."""
    fn = _build.library("tcec_matmul").tcec_matmul_grid
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    _build.check("tcec_matmul", fn(M, N, batch, int(trans_b), n_splits,
                                   -1 if path is None else path, out))
    return tuple(out)


def grid(M: int, N: int, batch: int = 1, trans_b: bool = False,
         policy="tcec_bf16x6", path: int | None = None):
    """``(blocks, blocks resident per SM)`` of a launch at these shapes, on
    ``path`` (0 path S, 1 path W, None the rule by M)."""
    pol = get_policy(policy)
    check_policy(pol)
    return _plan(M, N, batch, bool(trans_b), pol.n_splits, path)[:2]


def groups_per_block(M: int, N: int, batch: int = 1, trans_b: bool = False,
                     policy="tcec_bf16x6", path: int | None = None) -> int:
    """Path S's groups of 8 slots a block at these shapes, as the C entry
    plans them from M, N, the batch and the layout (0 on path W): more
    than one where a block splits each weight fragment once for several
    groups."""
    pol = get_policy(policy)
    check_policy(pol)
    return _plan(M, N, batch, bool(trans_b), pol.n_splits, path)[2]
