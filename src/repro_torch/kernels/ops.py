"""Public entry point of the TCEC GEMM kernel.

``(M, K) @ (K, N)`` or batched ``(B, M, K) @ (B, K, N)`` f32, any shapes:
the CUDA kernel masks ragged M, N and K itself, so nothing is padded.  A
CUDA operand launches the kernel (or raises); a CPU operand runs the plain
PyTorch version.  Callers that want the technique without caring about
kernels use :func:`repro_torch.core.pdot`, which routes here through
``kernels/dispatch.py`` (with the autotuner's tile).
"""
from __future__ import annotations

from . import tcec_matmul as _tm


def tcec_matmul(a, b, policy: str = "tcec_bf16x6", bias=None,
                activation: str | None = None, out_scale: float = 1.0,
                block=None):
    """FP32-accurate GEMM from bf16 tensor-core products, with the fused
    epilogue ``act(out * out_scale + bias)`` (``bias`` shaped ``(N,)``).

    ``block`` is one of the kernel's two tiles (``tcec_matmul.tiles()``),
    which names its path; None takes the rule by M.  The plain version on
    the CPU has no tiles, but a tile that is neither raises there too."""
    path = None if block is None else _tm.block_path(block)
    if a.is_cuda:     # the wrapper checks shapes and devices itself
        return _tm.launch(a, b, policy, bias, activation, out_scale, path)
    if a.ndim not in (2, 3) or b.ndim != a.ndim:
        raise ValueError(f"expected 2-D or batched 3-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return _tm.tcec_matmul_plain(a, b, policy, bias, activation,
                                     out_scale)
    raise ValueError(f"no TCEC matmul for device {a.device}")
