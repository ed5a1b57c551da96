#!/usr/bin/env python3
"""Kernel 1 on one H100, timed through variants of its source.

    python3 scripts/kernel1_ablation.py [--parent DIR] [--parts ...]

Where path W (prefill) spends its time: variants of
``src/repro_torch/csrc/tcec_matmul.cu`` in which one part of it is switched
off (the copies, the producer's B split, the consumers' A split, the
wgmmas, the f32 adds), each timed at main-path shapes beside f32
``torch.matmul``.  Such a variant computes garbage; only its time means
anything.  (Without the epilogue the compiler would drop the adds that feed
nothing, so there is no variant without it.)  A switch point that no
longer matches the source raises.

Where the paths cross: the kernel as built, each product launched on path
S and on path W (the C entry's ``path`` argument), timed on the device
alone (``chip_smoke.device_only_ms``, weights read cold) at the products
of one qwen3-0.6b forward for M from 4 to 256, with the forward's sum of
kernel-1 time on each path.

Path S at decode (part ``decode``): qwen2.5-14b's decode products (q / o,
k / v, gate / up, down, the unembedding; weights stored (K, N)) at M 8, 16,
32 and 64, timed on the device alone with the weights cold, beside their
byte bound and f32 ``torch.matmul``, with each variant's sum over one
decode step's products.  The variants are the source as it is, the source
of another checkout (``--parent``: its ``src/repro_torch/csrc``, so that
parent and change are timed in one process), and rewrites of path S's
choices: the most groups a block (``FOLD``), the fold without the rule
that gives every SM a block, and a ring of four stages at every fold.

Also times the host side of the public entry at the decode gate against
``torch.matmul``'s.

Output: JSON lines on stdout, the first one the card's name and power
limit; builds go to ``build/kernel1_ablation/`` (with ptxas's report of
the source as it is, ``ptxas_skinny_change.txt``, when part ``decode``
runs).
"""
import argparse
import ctypes
import json
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
PATHS = {"skinny": 0, "wgmma": 1}      # the C entry's path argument
# the products of a qwen3-0.6b forward: (N, K, trans_b), launches a forward
FORWARD = {"q": (2048, 1024, False, 28), "k, v": (1024, 1024, False, 56),
           "o": (1024, 2048, False, 28), "gate, up": (3072, 1024, False, 56),
           "down": (1024, 3072, False, 28), "unembed": (151936, 1024, True, 1)}
CROSS_M = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
# qwen2.5-14b's decode products: (N, K), launches a decode step (48 layers)
DECODE_14B = {"q, o": (5120, 5120, 96), "k, v": (1024, 5120, 96),
              "gate, up": (13824, 5120, 96), "down": (5120, 13824, 48),
              "unembed": (152064, 5120, 1)}
DECODE_M = (8, 16, 32, 64)
H100_BYTES_PER_S = 3.35e12
# path S's variants: rewrites of the source, each (text, replacement)
SKINNY_VARIANTS = {
    "change": [],
    "fold1": [("constexpr int FOLD = 4;", "constexpr int FOLD = 1;")],
    "fold2": [("constexpr int FOLD = 4;", "constexpr int FOLD = 2;")],
    "no_fill_rule": [("while (G > 1 && bands", "while (false && bands")],
    "depth4": [("return G == 1 ? 4 : 3;", "return 4;"),
               ("return G > 1 ? 2 : tb ? 4 : 2;",
                "return G > 3 && !tb ? 1 : G > 1 ? 2 : tb ? 4 : 2;")],
}


def sources() -> None:
    s = (ROOT / "src/repro_torch/csrc/tcec_matmul.cu").read_text()
    for old, new in SWITCHES:
        if old not in s:
            raise RuntimeError(f"switch point not found: {old!r}")
        s = s.replace(old, new)
    (OUT / "ablation.cu").write_text(s)


def skinny_sources(parent: Path | None) -> dict[str, Path]:
    """Path S's variants as sources, by name (``parent``: another
    checkout's source as it is)."""
    s = (ROOT / "src/repro_torch/csrc/tcec_matmul.cu").read_text()
    out = {}
    for name, edits in SKINNY_VARIANTS.items():
        v = s
        for old, new in edits:
            if old not in v:
                raise RuntimeError(f"{name}: switch point not found: {old!r}")
            v = v.replace(old, new)
        out[name] = OUT / f"skinny_{name}.cu"
        out[name].write_text(v)
    if parent is not None:
        out["parent"] = parent / "src/repro_torch/csrc/tcec_matmul.cu"
    return out


def build(name: str, src: Path | None = None, include: Path | None = None,
          ptxas: bool = False) -> Path:
    """One variant's library: a path W variant by name, or ``src``."""
    lib = OUT / f"lib_{name}.so"
    defs = [] if src else [f"-D{f}={int(f in VARIANTS[name])}" for f in FLAGS]
    flags = [f for f in _build.NVCC_FLAGS
             if ptxas or f not in ("-Xptxas", "-v")]
    r = subprocess.run([_build._nvcc(), *flags, "-I",
                        str(include or _build.CSRC), *defs, "-o", str(lib),
                        str(src or OUT / "ablation.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: {r.stdout}{r.stderr}")
    if ptxas:
        (OUT / f"ptxas_{name}.txt").write_text(r.stdout + r.stderr)
    return lib


def crossing(dev, stream):
    """Both paths at each M of CROSS_M, at the products of one forward."""
    fn = _build.entry("tcec_matmul", tm._ARGTYPES)
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
            for path, p in PATHS.items():
                ms = device_only_ms(lambda i: fn(
                    a.data_ptr(), ws[i % copies].data_ptr(), None,
                    c.data_ptr(), 1, M, N, K, int(tb), 0, K if tb else N,
                    3, 8, 1.0, 0, p, stream),
                    max(10, 2 * copies))
                row[f"{name} {path}_ms"] = ms
                total[path] += per_forward * ms
            del a, ws, c
        torch.cuda.empty_cache()
        for path, ms in total.items():
            row[f"forward {path}_ms"] = ms
        print(json.dumps(row), flush=True)


def decode(dev, stream, libs):
    """Path S's variants (``libs``: name -> library) and f32
    ``torch.matmul`` at qwen2.5-14b's decode products, weights cold; each
    variant's sum over one decode step's products."""
    fns = {}
    for name, lib in libs.items():
        fns[name] = ctypes.CDLL(str(lib)).tcec_matmul_launch
        fns[name].argtypes = tm._ARGTYPES
    for M in DECODE_M:
        step = dict.fromkeys([*fns, "torch_matmul"], 0.0)
        for prod, (N, K, per_step) in DECODE_14B.items():
            # enough weight copies to exceed the 50 MB L2
            copies = max(1, -(-120 * 2 ** 20 // (4 * N * K)))
            reps = max(10, 2 * copies)
            a = torch.randn(M, K, device=dev)
            ws = [torch.randn(K, N, device=dev) for _ in range(copies)]
            c = torch.empty(M, N, device=dev)
            row = {"decode": "qwen2.5-14b", "product": prod, "M": M, "N": N,
                   "K": K, "policy": "tcec_bf16x6", "path": "skinny",
                   "bound_ms": 4 * (N * K + M * K + M * N)
                   / H100_BYTES_PER_S * 1e3}
            for name, fn in fns.items():
                ms = device_only_ms(lambda i, fn=fn: fn(
                    a.data_ptr(), ws[i % copies].data_ptr(), None,
                    c.data_ptr(), 1, M, N, K, 0, 0, N, 3, 8, 1.0, 0, 0,
                    stream), reps)
                row[f"{name}_ms"] = ms
                step[name] += per_step * ms
            ms = device_only_ms(lambda i: torch.matmul(
                a, ws[i % copies], out=c), reps)
            row["torch_matmul_ms"] = ms
            step["torch_matmul"] += per_step * ms
            row["groups_per_block"] = tm.groups_per_block(M, N)
            print(json.dumps(row), flush=True)
            del a, ws, c
            torch.cuda.empty_cache()
        print(json.dumps({"decode": "qwen2.5-14b", "M": M,
                          "step_ms": step}), flush=True)


def host_us(fn, n=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout, whose path S is timed beside")
    ap.add_argument("--parts", nargs="+",
                    default=["crossing", "wide", "decode", "host"],
                    choices=["crossing", "wide", "decode", "host"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel1_ablation: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    _build.build()
    jobs = {}
    if "wide" in args.parts:
        sources()
        jobs.update({v: (v, None, None, False) for v in VARIANTS})
    if "decode" in args.parts:
        for name, src in skinny_sources(args.parent).items():
            include = src.parent if name == "parent" else _build.CSRC
            jobs[f"skinny_{name}"] = (f"skinny_{name}", src, include,
                                      name == "change")
    with ThreadPoolExecutor(8) as ex:
        libs = dict(zip(jobs, ex.map(lambda j: build(*j), jobs.values())))
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if "decode" in args.parts:
        decode(dev, stream, {k[len("skinny_"):]: v for k, v in libs.items()
                             if k.startswith("skinny_")})
    if "crossing" in args.parts:
        crossing(dev, stream)
    for name, M, N, K, tb, reps in SHAPES if "wide" in args.parts else ():
        a = torch.randn(M, K, device=dev)
        w = torch.randn((N, K) if tb else (K, N), device=dev)
        c = torch.empty(M, N, device=dev)
        args_ = (a.data_ptr(), w.data_ptr(), None, c.data_ptr(), 1, M, N, K,
                 int(tb), 0, K if tb else N, 3, 8, 1.0, 0, PATHS["wgmma"],
                 stream)
        row = {"shape": name, "M": M, "N": N, "K": K, "policy": "tcec_bf16x6"}
        for v in VARIANTS:
            fn = ctypes.CDLL(str(libs[v])).tcec_matmul_launch
            fn.argtypes = tm._ARGTYPES
            row[f"{v}_ms"] = time_ms(lambda i=0: fn(*args_), reps)
        b = w.T if tb else w
        row["torch_matmul_ms"] = time_ms(lambda i=0: torch.matmul(a, b), reps)
        print(json.dumps(row), flush=True)
        del a, w, c
        torch.cuda.empty_cache()
    if "host" not in args.parts:
        return 0
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
