"""Roofline report generator (the JAX package's ``launch/roofline.py``,
the port's own copy: the same tables, snapshot metrics and report): reads
the dry run's records (``launch/dryrun.py``, ``experiments/torch_dryrun/
*.json``) and prints the §Roofline table (single pod) and the §Dry-run
summary (both meshes).

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      --dir experiments/torch_dryrun

The port's records give ``compile_s`` 0 (it traces and compiles nothing),
so the §Dry-run table's compile column reads 0s.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

IMPROVE_HINTS = {
    "compute": "drop correction passes where fidelity is not needed "
               "(tcec_mixed: x3/bf16 for attention probs, x6 for weights)",
    "memory": "fuse attention (flash-blocked everywhere) and cast scores "
              "traffic to bf16; shard the residual stream (Megatron-SP)",
    "collective": "overlap TP all-reduces with compute (async collectives); "
                  "bf16 grad/activation reduction; 2D-shard activations",
}


def load(dir_):
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    if b >= 1e12:
        return f"{b/1e12:.2f}T"
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    return f"{b/1e6:.1f}M"


def roofline_table(recs, mesh="16x16"):
    rows = []
    for arch in sorted({r["arch"] for r in recs}):
        for shape in SHAPE_ORDER:
            cell = [r for r in recs
                    if r["arch"] == arch and r["shape"] == shape
                    and r["mesh"] == mesh]
            if not cell:
                continue
            r = cell[0]
            if r["status"] == "skip":
                rows.append([arch, shape, "SKIP (full attention @500k)",
                             "", "", "", "", "", ""])
                continue
            if r["status"] != "ok":
                rows.append([arch, shape, "ERROR", "", "", "", "", "",
                             r.get("error", "")[:40]])
                continue
            t = r["roofline"]
            dom = r["bottleneck"]
            rows.append([
                arch, shape,
                f"{t['compute_s']:.3f}", f"{t['memory_s']:.3f}",
                f"{t['collective_s']:.3f}", dom,
                f"{r['roofline_fraction']:.2f}",
                f"{r['useful_flops_ratio']:.3f}",
                IMPROVE_HINTS.get(dom, "")[:58],
            ])
    return rows


def dryrun_table(recs):
    rows = []
    for r in recs:
        if r["status"] == "ok":
            mem = r.get("memory", {})
            args_gb = mem.get("argument_size_in_bytes", 0) / 2**30
            tmp_gb = mem.get("temp_size_in_bytes", 0) / 2**30
            cc = r["collectives"]["counts"]
            csum = ", ".join(f"{k}:{v}" for k, v in sorted(cc.items()) if v)
            rows.append([r["arch"], r["shape"], r["mesh"], r["kind"],
                         f"{r['compile_s']:.0f}s",
                         f"{args_gb:.2f}", f"{tmp_gb:.1f}",
                         fmt_bytes(r["collectives"]["per_device_bytes"]),
                         csum[:60]])
        else:
            rows.append([r["arch"], r["shape"], r["mesh"], r["status"],
                         "", "", "", "", r.get("reason", r.get("error",
                                                               ""))[:60]])
    return rows


def snapshot_metrics(recs):
    """Dry-run roofline fractions as snapshot metrics (the JAX package's
    ``benchmarks/compare.py`` schema): per ok cell, the effective-peak
    fraction of the dominant roofline term and the useful-FLOPs ratio;
    both analytic (from the traced step's counts, not wall clock), both
    higher-is-better."""
    out = {}
    for r in recs:
        if r.get("status") != "ok":
            continue
        key = f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}"
        out[key + "/fraction"] = {
            "value": float(r["roofline_fraction"]), "unit": "frac",
            "kind": "analytic", "higher_is_better": True, "noise": 0.0}
        out[key + "/useful_flops"] = {
            "value": float(r["useful_flops_ratio"]), "unit": "frac",
            "kind": "analytic", "higher_is_better": True, "noise": 0.0}
    return out


def md_table(headers, rows):
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/torch_dryrun")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    recs = load(args.dir)
    ok = sum(r["status"] == "ok" for r in recs)
    skip = sum(r["status"] == "skip" for r in recs)
    err = sum(r["status"] == "error" for r in recs)

    parts = [f"# Roofline + dry-run report ({ok} ok / {skip} skip / "
             f"{err} error of {len(recs)} cells)\n"]
    parts.append("## §Roofline — single-pod (16,16), per-step seconds\n")
    parts.append(md_table(
        ["arch", "shape", "compute_s", "memory_s", "collective_s",
         "bottleneck", "roofline-frac", "useful-flops", "what moves it"],
        roofline_table(recs, "16x16")))
    parts.append("\n## §Dry-run — all cells, both meshes\n")
    parts.append(md_table(
        ["arch", "shape", "mesh", "kind", "compile", "args GiB",
         "temp GiB", "coll bytes/dev", "collectives"],
        dryrun_table(recs)))
    txt = "\n".join(parts)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
