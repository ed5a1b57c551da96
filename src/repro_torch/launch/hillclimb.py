"""Hillclimbing (the JAX package's ``launch/hillclimb.py``): traces
one dry-run cell under config variants and prints the roofline-term
deltas (hypothesis -> change -> before -> after).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \
      --cell qwen2.5-14b:train_4k

The same ``PLANS`` as JAX's, run through ``launch/dryrun.py::run_cell``'s
``overrides``.  Unlike JAX's, importing this module sets no environment
variable: the port's dry run needs no device count before start-up.  The
hypotheses are JAX's own, written about its TPU cost model.
"""
import argparse
import json
import os

# (cell) -> list of (variant-name, hypothesis, overrides dict)
PLANS = {
    "qwen2.5-14b:train_4k": [
        ("baseline", "paper-faithful: tcec_bf16x6 on every contraction", {}),
        ("mixed_attn_bf16",
         "scores/PV are activation-activation dots; bf16+f32-accum there "
         "drops 6 passes->1 on ~40% of FLOPs and kills the f32 score "
         "traffic: compute -35%, memory -40%, collective ~0",
         {"attn_policy": "bf16"}),
        ("mixed_attn_x3",
         "middle ground: x3 on attention keeps ~16-bit mantissa on scores "
         "(safer for long-context logits) at half the x6 cost",
         {"attn_policy": "tcec_bf16x3"}),
        ("logits_x3",
         "the 152k-vocab logit GEMM is ~15% of compute at x6; x3 halves it "
         "while logit softmax tolerates 16-bit mantissa",
         {"attn_policy": "bf16", "logits_policy": "tcec_bf16x3"}),
    ],
    "deepseek-v3-671b:train_4k": [
        ("baseline", "paper-faithful x6 + 1D EP + ZeRO-3 FSDP", {}),
        ("ep2d",
         "FSDP all-gathers of expert weights dominate the collective term "
         "(531 AGs/step); sharding 256 experts over model*data = 1 expert "
         "per chip removes those gathers entirely, trading them for "
         "token all-to-alls ~50x smaller",
         {"ep_mode": "2d"}),
        ("mixed_attn",
         "(after ep2d was refuted: GSPMD replicates tokens across the "
         "conflicting data axis) — orthogonal lever: MLA decompress + "
         "score dots to bf16: memory and compute down, FSDP traffic "
         "untouched",
         {"attn_policy": "bf16"}),
        ("mixed_gs512",
         "bigger dispatch groups (gs 512, cf 1.0) cut one-hot dispatch "
         "traffic per token and slot count ~20%",
         {"attn_policy": "bf16", "capacity_factor": 1.0,
          "moe_group_size": 512}),
    ],
    "mamba2-130m:train_4k": [
        ("baseline", "paper-faithful x6, TP over model axis", {}),
        ("dp_over_model",
         "130M params replicate trivially (0.5 GB); using the model axis "
         "as extra DP removes ALL TP collectives and shrinks per-device "
         "activations 16x: memory -16x, collective -> grad-AR only",
         {"dp_over_model": True}),
        ("dp_mixed",
         "SSD chunk dots in bf16 on top: compute -5x (6 passes -> 1) on "
         "the sequence-mixing matmuls",
         {"dp_over_model": True, "attn_policy": "bf16"}),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(PLANS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/torch_perf")
    args = ap.parse_args(argv)
    from repro_torch.launch.dryrun import run_cell
    arch, shape = args.cell.split(":")
    os.makedirs(args.out, exist_ok=True)

    results = []
    for name, hypothesis, overrides in PLANS[args.cell]:
        rec = run_cell(arch, shape, args.multi_pod, overrides=overrides)
        rec["variant"] = name
        rec["hypothesis"] = hypothesis
        rec["overrides"] = overrides
        results.append(rec)
        t = rec["roofline"]
        print(f"[{name:16s}] compute={t['compute_s']:8.3f} "
              f"memory={t['memory_s']:8.3f} "
              f"collective={t['collective_s']:8.3f} "
              f"dom={rec['bottleneck']:10s} "
              f"frac={rec['roofline_fraction']:.3f}", flush=True)
    tag = args.cell.replace(":", "__").replace("/", "_")
    with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
        json.dump(results, f, indent=1)
    base = max(results[0]["roofline"].values())
    best = min(max(r["roofline"].values()) for r in results)
    print(f"\nstep-time bound: {base:.3f}s -> {best:.3f}s "
          f"({base/best:.2f}x)")


if __name__ == "__main__":
    main()
