"""The card the yardstick is held to, and what the run reads of it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W), frozen here so that no change to the program moves
them.  They are the values of ``repro_torch/launch/dryrun.py::HW``.  The
f32 peak (67 TFLOP/s) is no roof: the port's products exceed it by design.
"""
from __future__ import annotations

import shutil
import subprocess

PEAK_FLOPS = 989e12        # FLOP/s, dense bf16 tensor cores: every roof
HBM_BYTES_PER_S = 3.35e12  # bytes/s


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the compute peak and the bytes over the memory peak."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def nvidia_smi(index: int = 0) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (empty
    where the tool is missing or fails)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        out = subprocess.run(
            [exe, f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    parts = [p.strip() for p in out.split(",")]
    if len(parts) != 2:
        return {}
    return {"smi_name": parts[0], "power_limit": parts[1]}
