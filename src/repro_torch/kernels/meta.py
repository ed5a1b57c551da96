"""The kernels' ``meta`` route: a shape-only stand-in for a launch.

The dry run (``launch/dryrun.py``) traces a whole step on ``meta`` tensors,
which have shapes and dtypes and no storage.  A kernel wrapper given
``meta`` operands launches nothing and runs no plain version: it returns an
empty result of the kernel's output shape and dtype and hands one record
of the call to every sink installed by :func:`recording` (the dry run's
counter, ``launch/hlo_cost.py``).  Nothing is computed anywhere, so this
is no fallback: a ``cuda`` operand still launches the kernel or raises,
and a ``cpu`` operand still runs the plain version.

A record counts the call once: its local shapes, its policy and kept term
products, the FLOPs of the kernel's products and the bytes it reads and
writes (each operand read once, the result written once).  The FLOPs are
those of the JAX package's composition of the same call, term product by
term product, since that is what its dry run lowers in place of the Pallas
kernels; the products are bf16 term products, so they count at the
tensor-core bf16 rate.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

_SINKS: list = []


@dataclass(frozen=True)
class KernelRecord:
    """One kernel call on ``meta`` operands."""
    kernel: str            # tcec_matmul | tcec_attention | tcec_paged_attention
    shapes: tuple          # the operands' local shapes
    policy: str
    terms: int             # kept term products of each product
    flops: float           # terms x the products' 2 M N K, in bf16
    bytes: float           # operands read once + result written once


@contextlib.contextmanager
def recording(sink):
    """Hand every kernel record of the scope to ``sink(record)``."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def is_meta(t) -> bool:
    return getattr(t, "device", None) is not None and t.device.type == "meta"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def record(rec: KernelRecord) -> None:
    for sink in list(_SINKS):
        sink(rec)
