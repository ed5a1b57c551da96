#!/usr/bin/env python3
"""Kernel 1 on one H100, timed through variants of its source.

    python3 scripts/kernel1_ablation.py

Where path W (prefill) spends its time: variants of
``src/repro_torch/csrc/tcec_matmul.cu`` in which one part of it is switched
off (the copies, the producer's B split, the consumers' A split, the
wgmmas, the f32 adds), each timed at main-path shapes beside f32
``torch.matmul``.  Such a variant computes garbage; only its time means
anything.  (Without the epilogue the compiler would drop the adds that feed
nothing, so there is no variant without it.)  A switch point that no
longer matches the source raises.

Where the paths cross: the source with its path threshold set so that
every M takes path S, and so that every M takes path W, each timed on the
device alone (``chip_smoke.device_only_ms``, weights read cold) at the
products of one qwen3-0.6b forward for M from 4 to 256, with the forward's
sum of kernel-1 time on each path.

Also times the host side of the public entry at the decode gate against
``torch.matmul``'s.

Output: JSON lines on stdout, the first one the card's name and power
limit; builds go to ``build/kernel1_ablation/``.
"""
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import repro_torch  # noqa: E402,F401  (sets TF32 off)
from chip_smoke import device_only_ms, time_ms  # noqa: E402
from repro_torch.kernels import _build, ops, tcec_matmul as tm  # noqa: E402

OUT = ROOT / "build" / "kernel1_ablation"
# each switch: the source text it wraps, and the text with the switch
SWITCHES = [
    ("    if (s < nst) {\n      float* fa",
     "    if (!ABL_NO_COPY && s < nst) {\n      float* fa"),
    ("    if (TB)\n      split_tile<NS, BK / 8, BN>",
     "    if (ABL_NO_SPLIT) {} else if (TB)\n      split_tile<NS, BK / 8, BN>"),
    ("          split2<NS>(v.x, v.y, scale, t);",
     "          if (ABL_NO_ASPLIT) { for (int i = 0; i < NS; ++i) "
     "t[i] = __float_as_uint(v.x) ^ i; } else\n"
     "          split2<NS>(v.x, v.y, scale, t);"),
    ("            wgmma_rs64<TB ? 0 : 1>(",
     "            if (!ABL_NO_WGMMA) wgmma_rs64<TB ? 0 : 1>("),
    ("            for (int e = 0; e < 32; ++e) acc[g][e] += f[e];",
     "            for (int e = 0; e < 32; ++e) "
     "if (!ABL_NO_ADD) acc[g][e] += f[e];"),
]
FLAGS = ("ABL_NO_COPY", "ABL_NO_SPLIT", "ABL_NO_ASPLIT", "ABL_NO_WGMMA",
         "ABL_NO_ADD")
VARIANTS = {
    "full": [],
    "no_copy": ["ABL_NO_COPY"],
    "no_b_split": ["ABL_NO_SPLIT"],
    "no_a_split": ["ABL_NO_ASPLIT"],
    "no_wgmma": ["ABL_NO_WGMMA"],
    "no_add": ["ABL_NO_ADD"],
    "producer_only": ["ABL_NO_ASPLIT", "ABL_NO_WGMMA", "ABL_NO_ADD"],
    "copy_only": ["ABL_NO_SPLIT", "ABL_NO_ASPLIT", "ABL_NO_WGMMA",
                  "ABL_NO_ADD"],
    "consumers_only": ["ABL_NO_COPY", "ABL_NO_SPLIT"],
    "wgmma_only": ["ABL_NO_COPY", "ABL_NO_SPLIT", "ABL_NO_ASPLIT",
                   "ABL_NO_ADD"],
    "adds_only": ["ABL_NO_COPY", "ABL_NO_SPLIT", "ABL_NO_ASPLIT",
                  "ABL_NO_WGMMA"],
}
SHAPES = [("unembed at prefill", 1024, 151936, 1024, True, 3),
          ("mlp gate at prefill", 1024, 3072, 1024, False, 20),
          ("ragged 1000^3", 1000, 1000, 1000, False, 20)]
THRESHOLD = re.compile(r"constexpr int SKINNY_MAX_M = \d+;")
PATHS = {"skinny": 1 << 30, "wgmma": 0}      # the threshold of each variant
# the products of a qwen3-0.6b forward: (N, K, trans_b), launches a forward
FORWARD = {"q": (2048, 1024, False, 28), "k, v": (1024, 1024, False, 56),
           "o": (1024, 2048, False, 28), "gate, up": (3072, 1024, False, 56),
           "down": (1024, 3072, False, 28), "unembed": (151936, 1024, True, 1)}
CROSS_M = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def sources() -> None:
    s = (ROOT / "src/repro_torch/csrc/tcec_matmul.cu").read_text()
    if not THRESHOLD.search(s):
        raise RuntimeError("path threshold not found")
    for path, m in PATHS.items():
        (OUT / f"{path}.cu").write_text(
            THRESHOLD.sub(f"constexpr int SKINNY_MAX_M = {m};", s))
    for old, new in SWITCHES:
        if old not in s:
            raise RuntimeError(f"switch point not found: {old!r}")
        s = s.replace(old, new)
    (OUT / "ablation.cu").write_text(s)


def build(name: str) -> Path:
    lib = OUT / f"lib_{name}.so"
    src, defs = OUT / f"{name}.cu", []
    if name in VARIANTS:
        src = OUT / "ablation.cu"
        defs = [f"-D{f}={int(f in VARIANTS[name])}" for f in FLAGS]
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    r = subprocess.run([_build._nvcc(), *flags, "-I", str(_build.CSRC),
                        *defs, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: {r.stdout}{r.stderr}")
    return lib


def crossing(libs, dev, stream):
    """Both paths at each M of CROSS_M, at the products of one forward."""
    fns = {}
    for path in PATHS:
        fns[path] = ctypes.CDLL(str(libs[path])).tcec_matmul_launch
        fns[path].argtypes = tm._ARGTYPES
    for M in CROSS_M:
        row = {"M": M, "policy": "tcec_bf16x6"}
        total = dict.fromkeys(PATHS, 0.0)
        for name, (N, K, tb, per_forward) in FORWARD.items():
            # enough weight copies to exceed the 50 MB L2
            copies = max(1, -(-120 * 2 ** 20 // (4 * N * K)))
            a = torch.randn(M, K, device=dev)
            ws = [torch.randn((N, K) if tb else (K, N), device=dev)
                  for _ in range(copies)]
            c = torch.empty(M, N, device=dev)
            for path, fn in fns.items():
                ms = device_only_ms(lambda i: fn(
                    a.data_ptr(), ws[i % copies].data_ptr(), None,
                    c.data_ptr(), 1, M, N, K, int(tb), 0, K if tb else N,
                    3, 8, 1.0, 0, stream),
                    max(10, 2 * copies))
                row[f"{name} {path}_ms"] = ms
                total[path] += per_forward * ms
            del a, ws, c
        torch.cuda.empty_cache()
        for path, ms in total.items():
            row[f"forward {path}_ms"] = ms
        print(json.dumps(row), flush=True)


def host_us(fn, n=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def main():
    if not torch.cuda.is_available():
        print("kernel1_ablation: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    sources()
    names = [*PATHS, *VARIANTS]
    with ThreadPoolExecutor(8) as ex:
        libs = dict(zip(names, ex.map(build, names)))
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    crossing(libs, dev, stream)
    for name, M, N, K, tb, reps in SHAPES:
        a = torch.randn(M, K, device=dev)
        w = torch.randn((N, K) if tb else (K, N), device=dev)
        c = torch.empty(M, N, device=dev)
        args = (a.data_ptr(), w.data_ptr(), None, c.data_ptr(), 1, M, N, K,
                int(tb), 0, K if tb else N, 3, 8, 1.0, 0, stream)
        row = {"shape": name, "M": M, "N": N, "K": K, "policy": "tcec_bf16x6"}
        for v in VARIANTS:
            fn = ctypes.CDLL(str(libs[v])).tcec_matmul_launch
            fn.argtypes = tm._ARGTYPES
            row[f"{v}_ms"] = time_ms(lambda i=0: fn(*args), reps)
        b = w.T if tb else w
        row["torch_matmul_ms"] = time_ms(lambda i=0: torch.matmul(a, b), reps)
        print(json.dumps(row), flush=True)
        del a, w, c
        torch.cuda.empty_cache()
    # the host side of one call at the decode gate, 2000 calls enqueued
    a = torch.randn(4, 1024, device=dev)
    w = torch.randn(1024, 3072, device=dev)
    print(json.dumps({"host_us_per_call": "decode gate, M 4, N 3072, K 1024",
                      "ops.tcec_matmul": host_us(lambda: ops.tcec_matmul(a, w)),
                      "tcec_matmul.launch": host_us(lambda: tm.launch(a, w)),
                      "torch.matmul": host_us(lambda: torch.matmul(a, w)),
                      "torch.empty": host_us(lambda: torch.empty(4, 3072,
                                                                 device=dev))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
