"""PyTorch/CUDA port of ``repro``: the error-corrected bf16 GEMM
(Ootomo & Yokota 2022) as a precision-policy framework for NVIDIA Hopper.

The package mirrors the JAX package's module names (``core.split``,
``core.policy``, ``kernels.*``, ``models.*``, ``serving.*``) so each part
can be read beside its counterpart.  Every TPU kernel of the JAX package is
a hand-written CUDA C++ kernel here (``csrc/*.cu``), built for ``sm_90a`` on
first use and bound with ``ctypes``; each has a plain PyTorch version beside
it, which runs when the tensors lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

The public surface, as the JAX package's: the verbs
:func:`repro_torch.matmul`, :func:`repro_torch.einsum` and
:func:`repro_torch.attention`; :mod:`repro_torch.numerics` with
:class:`NumericsConfig` (``with repro_torch.numerics.use(...)``: policy,
kernel dispatch, tuning; the ``REPRO_*`` registry); the autotuner
:mod:`repro_torch.tuning` (loaded on first use); fault injection
(:mod:`repro_torch.faults`) and telemetry (:mod:`repro_torch.obs`:
metrics, traces, the dispatch explain table, numerics-health probes).

TF32 stays off for every f32 product: otherwise the ``fp32`` policy and
the f32-upcast term products would quietly round their operands to TF32.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import numerics  # noqa: E402
from .numerics import NumericsConfig, attention, einsum, matmul  # noqa: E402

__version__ = "0.1.0"
__all__ = ["numerics", "NumericsConfig", "matmul", "einsum", "attention",
           "tuning", "resolve_device"]


def __getattr__(name):
    # the autotuner imports the kernels' wrappers: loaded on first use
    if name == "tuning":
        import importlib
        mod = importlib.import_module("repro_torch.kernels.tuning")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and the
    machine has none — a CPU run must be asked for with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the port's plain PyTorch versions on the CPU")
    return dev
