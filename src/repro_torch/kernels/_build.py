"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  The libraries land in
``build/repro_torch_kernels/<hash of the sources and flags>/`` at the root
of the checkout, the first time a kernel is used; an edit to any source
gives a new hash and so a fresh build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero status into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("tcec_matmul", "tcec_attention", "tcec_paged_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}
# ptxas report (registers, shared memory, spills) of each build, by kernel
build_logs: dict[str, str] = {}


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels" / h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return nvcc


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names=KERNELS) -> float:
    """Compile every kernel of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds taken;
    raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    d = _build_dir()
    d.mkdir(parents=True, exist_ok=True)
    with _lock:
        procs = {}
        for name in names:
            out = d / f"lib{name}.so"
            if not out.exists():
                procs[name] = (_start(name, out), out)
        errors = []
        for name, (proc, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
                err = getattr(lib, f"{name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def entry(name: str, argtypes: list):
    """The C entry point ``<name>_launch`` with its argument types set."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def check(name: str, status: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = getattr(library(name), f"{name}_error_string")(status)
        raise RuntimeError(f"{name} launch failed: CUDA error {status} "
                           f"({msg.decode() if msg else '?'})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle
    (PyTorch's raw-stream query: a fraction of the cost of building a
    ``torch.cuda.Stream`` object)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())
