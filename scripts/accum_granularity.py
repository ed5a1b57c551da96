#!/usr/bin/env python3
"""How finely must x6's correction products leave the tensor core?  A CPU
simulation with ``repro_torch.core.accum.mma_sim`` (no card needed).

    PYTHONPATH=src python3 scripts/accum_granularity.py [--m 64] [--k 4096]
        [--out BENCH_torch_accum_granularity.json]

The x6 policy splits each f32 operand into three bf16 terms (scale 2^8)
and keeps six term products in three scale groups: the main product
(0, 0), and the corrections (0, 1) + (1, 0) and (1, 1) + (0, 2) + (2, 0).
A simulated tensor-core instruction is one k16 step: ``mma_sim`` adds its
16 exact products one by one into a 25-bit accumulator rounded toward zero
(RZ) after every add (the paper's model of the Tensor Core, Eq. 11), and
its result leaves the core rounded to f32, again RZ.  Outside the core an
f32 add rounds to nearest (RN).  Each group ends in an f32 accumulator;
the three are folded smallest first in f32 RN, as kernel 1 does.

The rules compared, each on the same inputs, against the f64 product
(the Eq. (7) residual) and beside f32 SGEMM (``policy_mm(..., "fp32")``):

  * ``every_fragment_rn``: every term product of every k16 step into a
    zeroed fragment, added to its group's accumulator in f32 RN (kernel
    1's path W today);
  * ``chain_1`` / ``chain_4`` / ``chain_8``: a correction group's products
    chained inside the core (each instruction takes the last one's result
    as its C) over 1, 4 (one 64-deep stage of path W) or 8 k16 steps,
    then added to the group's accumulator in f32 RN; the main product is
    added outside in f32 RN after every k16 step, as in the paper's Code 3;
  * ``chain_all``: Code 3 as written, each correction group chained over
    all of K.

Inputs: ``urand`` U[-1, 1) and ``exp_rand`` Types 1 (exponents -15..14)
and 3 (-35..-15) of Fig. 11, M = N = 64, K = 4096, fixed seeds.  Writes
one JSON object (the rows and the configuration) to ``--out`` and prints
the table.  This is the CPU half of the accumulation-granularity question
in ``ROADMAP.md``; the card half, a path-W variant held to the f32 gate,
is separate.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core import accum, matgen, policy, split  # noqa: E402

X6 = policy.get_policy("tcec_bf16x6")
K_STEP = 16                                   # the depth of one instruction
F32_BITS = 24                                 # incl. the implicit bit
CHAINS = {"chain_1": 1, "chain_4": 4, "chain_8": 8, "chain_all": None}


def inputs(kind, m, k, n):
    if kind == "urand":
        return matgen.urand((m, k), seed=11), matgen.urand((k, n), seed=12)
    lo, hi = {"type1": (-15, 14), "type3": (-35, -15)}[kind]
    return (matgen.exp_rand((m, k), lo, hi, seed=21),
            matgen.exp_rand((k, n), lo, hi, seed=22))


def terms(x):
    """x6's three bf16 terms of an f32 matrix, as f64 (exact)."""
    return [t.double().numpy() for t in split(
        torch.from_numpy(x), X6.tdtype, X6.n_splits, X6.scale_bits)]


def tc(a, b, c):
    """One simulated instruction (or a chain of them, if ``a`` is more than
    16 deep): RZ accumulation at 25 bits, the result rounded to f32 RZ."""
    out = accum.mma_sim(a, b, c, "rz")
    return accum._round_to_bits(out, F32_BITS, "rz")


def f32_add(acc, x):
    """acc + x in f32, rounded to nearest."""
    return np.float32(acc) + np.asarray(x, np.float32)


def simulate(a, b, rule):
    """x6 of ``a @ b`` under one accumulation rule (see the docstring)."""
    sa, sb = terms(a), terms(b)
    m, k, n = a.shape[0], a.shape[1], b.shape[1]
    steps = k // K_STEP
    groups = {}
    for (i, j) in X6.keep:
        groups.setdefault(i + j, []).append((i, j))
    acc = {g: np.zeros((m, n), np.float32) for g in groups}
    zero = np.zeros((m, n))
    chain = None if rule == "every_fragment_rn" else CHAINS[rule] or steps
    for g, pairs in groups.items():
        if chain is None or g == 0:
            # every product of every k16 step into a zeroed fragment
            for s in range(steps):
                ks = slice(s * K_STEP, (s + 1) * K_STEP)
                for (i, j) in pairs:
                    acc[g] = f32_add(acc[g], tc(sa[i][:, ks], sb[j][ks],
                                                zero))
            continue
        for s0 in range(0, steps, chain):
            frag = zero
            for s in range(s0, min(steps, s0 + chain)):
                ks = slice(s * K_STEP, (s + 1) * K_STEP)
                for (i, j) in pairs:
                    frag = tc(sa[i][:, ks], sb[j][ks], frag)
            acc[g] = f32_add(acc[g], frag)
    out = None
    for g in sorted(groups, reverse=True):      # smallest first, f32 RN
        term = acc[g] * np.float32(2.0 ** (-g * X6.scale_bits))
        out = term if out is None else f32_add(out, term)
    return out


def run(m=64, k=4096, kinds=("urand", "type1", "type3")):
    rules = ["every_fragment_rn", *CHAINS]
    rows = []
    for kind in kinds:
        a, b = inputs(kind, m, k, m)
        sgemm = policy.policy_mm(torch.from_numpy(a), torch.from_numpy(b),
                                 "fp32").numpy()
        r32 = matgen.relative_residual(sgemm, a, b)
        rows.append({"input": kind, "rule": "f32_sgemm", "residual": r32,
                     "ratio_to_sgemm": 1.0})
        for rule in rules:
            r = matgen.relative_residual(simulate(a, b, rule), a, b)
            rows.append({"input": kind, "rule": rule, "residual": r,
                         "ratio_to_sgemm": r / r32})
    return {"config": {"policy": X6.name, "M": m, "N": m, "K": k,
                       "k_step": K_STEP, "acc_bits": accum.ACC_BITS,
                       "inside_core": "RZ at 25 bits, out RZ to f32",
                       "outside_core": "f32 RN",
                       "sgemm": "torch f32 matmul on the CPU"},
            "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=64, help="M = N")
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--out", default=str(
        ROOT / "BENCH_torch_accum_granularity.json"))
    args = ap.parse_args(argv)
    if args.k % (8 * K_STEP):
        ap.error(f"--k must be a multiple of {8 * K_STEP}")
    result = run(args.m, args.k)
    Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(f"{'input':8s} {'rule':18s} {'residual':>12s} {'/ sgemm':>8s}")
    for r in result["rows"]:
        print(f"{r['input']:8s} {r['rule']:18s} {r['residual']:12.4e} "
              f"{r['ratio_to_sgemm']:8.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
