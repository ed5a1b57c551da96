#!/usr/bin/env python3
"""Kernel 1's phase-2 rows of ``chip_smoke.py`` (``KERNEL1_CASES``) timed
on one card, for one checkout of the port.

    python3 scripts/kernel1_rows.py [--tree DIR] [--path skinny|wgmma]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one); the shapes are this checkout's list, so that two
commits are timed on the same products, each in a process of its own:
parent, change, change, parent.  ``--path`` launches every row on that
path (the entry's ``block=``, a tile of ``tcec_matmul.tiles()``; a tree
whose entry has no ``block`` refuses it); without it each row takes the
rule by M, as every tree's entry does.  Each row: the public entry's time
(``ms``, CUDA events around ``reps`` calls after one warm-up, weight
copies rotated as in ``chip_smoke.py``) and the same launches with the host
taken out (``device_only_ms``).  No plain version or library call is timed.

Output: JSON lines on stdout, the first one the card's name and power
limit as ``nvidia-smi`` gives them.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (KERNEL1_CASES, device_only_ms, emit,  # noqa: E402
                        rotating, time_ms)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--path", choices=("skinny", "wgmma"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel1_rows: no CUDA card", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.kernels import _build, ops, tcec_matmul as tm
    kw = {} if args.path is None else {"block": tm.tiles()[args.path]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi, "tree": str(tree),
          "build_s": _build.build(("tcec_matmul",))})
    dev = torch.device("cuda")
    for case in KERNEL1_CASES:
        M, N, K = case["M"], case["N"], case["K"]
        batch, copies = case.get("batch"), case.get("copies", 1)
        reps = case.get("reps", 5)
        bsh = () if batch is None else (batch,)
        g = torch.Generator(device=dev).manual_seed(M + N + K)
        a = (torch.randn(*bsh, K, M, generator=g, device=dev).mT
             if case.get("trans_a") else
             torch.randn(*bsh, M, K, generator=g, device=dev))
        tb = case.get("trans_b", False)
        ws = [torch.randn(bsh + ((N, K) if tb else (K, N)), generator=g,
                          device=dev) * K ** -0.5 for _ in range(copies)]
        bs = [w.mT if tb else w for w in ws]

        def entry(i):
            return ops.tcec_matmul(a.contiguous(), bs[i % copies], **kw)

        emit({"shape": case["name"], "M": M, "N": N, "K": K,
              "path": args.path or tm.path(M),
              "ms": time_ms(rotating(entry), reps),
              "device_only_ms": device_only_ms(entry, reps)})
        del a, ws, bs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
