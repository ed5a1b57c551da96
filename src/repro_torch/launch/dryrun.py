"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``): trace every
(arch x shape x mesh) cell and record its per-device FLOPs, bytes,
collective traffic and memory, with a roofline of the step on the H100.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--out experiments/torch_dryrun]

Without ``--arch`` it sweeps all 40 (arch x shape) cells, on both meshes
with ``--both-meshes``.  ``--smoke`` takes each arch's smoke config.

JAX lowers and compiles each cell on 512 placeholder XLA devices and reads
the HLO.  The port traces each cell's real step eagerly on ``meta``
tensors under a ``DeviceMesh`` over a fake process group of 256 or 512
ranks (``launch/mesh.py::make_production_mesh``; ``launch/step.py::
lower_cell``), and counts what rank 0 would run (``launch/hlo_cost.py``).
Nothing is stored and nothing launches; it sets no environment variable.
The records keep JAX's fields, so ``launch/roofline.py`` reads them as
JAX's reads its own, with these differences: ``lower_s`` is the trace's
seconds and ``compile_s`` is 0 (nothing is compiled); there is no
``xla_cost_flops_raw`` (XLA's own cost analysis); ``flops_by_dtype`` and
``kernels`` (each kernel's launches, FLOPs and bytes) are the port's own.
JAX's ``parse_collectives`` reads HLO text and is not ported: the counter
sees each collective as it is issued.

``HW`` holds the H100's figures, and ``roofline.compute_s`` divides each
operand type's FLOPs by its own rate: bf16 term products run on the tensor
cores, f32 products at the FP32 rate (TF32 stays off).  A collective whose
group lies inside one node of 8 GPUs (``hlo_cost.CostCounter``'s
``gpus_per_node``) runs at the NVLink rate, any other at one NIC's.  The meshes keep JAX's shapes and names (``16x16``,
``2x16x16``) so the records line up cell for cell with JAX's; a 16-wide
model axis spans two 8-GPU nodes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
import traceback

# NVIDIA H100 SXM5 80 GB datasheet figures (dense, no sparsity), the card
# that nvidia-smi names "NVIDIA H100 80GB HBM3" at its 700 W power limit
HW = {
    "name": "NVIDIA H100 80GB HBM3, 700.00 W",
    "peak_flops_bf16": 989e12,     # FLOP/s a GPU, bf16 tensor cores
    "peak_flops_f32": 67e12,       # FLOP/s a GPU, FP32 (TF32 off)
    "hbm_bw": 3.35e12,             # bytes/s a GPU
    "nvlink_bw": 450e9,            # bytes/s a GPU, one direction, in a node
    "net_bw": 50e9,                # bytes/s a GPU: one 400 Gb/s NIC
}

_TENSOR_CORE_TYPES = ("bf16", "f16")


def model_flops(cfg, shape) -> float:
    """6 N D (dense) or 6 N_active D (MoE) useful-FLOPs yardstick (JAX
    :88-113, the same sums in the same order)."""
    from repro_torch.launch.specs import abstract_params
    from repro_torch.parallel.sharding import tree_map_with_path
    params = abstract_params(cfg)
    leaves: list = []
    tree_map_with_path(lambda p, leaf: leaves.append((p, leaf)), params)
    n_total = sum(int(math.prod(leaf.shape)) for _, leaf in leaves)
    n_active = n_total
    if cfg.n_experts:
        expert = 0
        for p, leaf in leaves:
            if re.search(r"moe/w_(gate|up|down)", p):
                expert += int(math.prod(leaf.shape))
        active = expert * cfg.moe_top_k / cfg.n_experts
        n_active = n_total - expert + active
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def roofline(hc: dict, hw: dict = HW) -> dict:
    """The step's roofline terms in seconds from ``hlo_cost.analyze``'s
    per-device counts: compute (each type's FLOPs over its rate), memory
    (bytes over HBM) and collectives (in-node bytes over NVLink, the rest
    over the network)."""
    compute = sum(
        f / (hw["peak_flops_bf16"] if t in _TENSOR_CORE_TYPES
             else hw["peak_flops_f32"])
        for t, f in hc["dot_flops_by_dtype"].items())
    return {
        "compute_s": compute,
        "memory_s": hc["bytes"] / hw["hbm_bw"],
        "collective_s": (hc["intra_node_bytes"] / hw["nvlink_bw"]
                         + hc["inter_node_bytes"] / hw["net_bw"]),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             mesh_override=None, overrides: dict | None = None, *,
             smoke: bool = False) -> dict:
    """One cell's record (JAX's ``run_cell`` and ``_run_cell``, :116-196).
    JAX's ``run_cell`` only scopes its ``_run_cell`` under
    ``keep_bf16_dots``, so that its HLO keeps bf16 dots; the port's counter
    reads each product's real operand types, so it has one function."""
    from repro_torch.configs import (LONG_CONTEXT_ARCHS, SHAPES, get_config,
                                     get_smoke_config)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.step import lower_cell
    from repro_torch.parallel.ctx import axis_shape

    cfg = (get_smoke_config if smoke else get_config)(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "status": "ok"}
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        rec["status"] = "skip"
        rec["reason"] = ("full-attention arch: 500k decode cell skipped; "
                         "only configs.LONG_CONTEXT_ARCHS run it")
        return rec
    mesh = mesh_override or make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(axis_shape(mesh).values())
    t0 = time.time()
    hc, kind = lower_cell(cfg, shape_name, mesh)
    rec["kind"] = kind
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["compile_s"] = 0.0
    rec["memory"] = hc["memory"]
    rec["largest_allocation"] = hc["largest_allocation"]
    rec["hlo_flops_per_device"] = hc["dot_flops"]
    rec["flops_by_dtype"] = hc["dot_flops_by_dtype"]
    rec["hlo_bytes_per_device"] = hc["bytes"]
    rec["collectives"] = {"per_op_bytes": hc["per_op_bytes"],
                          "counts": hc["counts"],
                          "per_device_bytes": hc["per_device_bytes"],
                          "intra_node_bytes": hc["intra_node_bytes"],
                          "inter_node_bytes": hc["inter_node_bytes"],
                          "unknown_trip_counts": hc["unknown_trip_counts"]}
    rec["kernels"] = hc["kernels"]
    rec["chips"] = chips
    rec["model_flops"] = model_flops(cfg, shape)

    flops_total = rec["hlo_flops_per_device"] * chips
    rec["roofline"] = roofline(hc)
    dom = max(rec["roofline"], key=rec["roofline"].get)
    rec["bottleneck"] = dom.replace("_s", "")
    rec["useful_flops_ratio"] = (rec["model_flops"] / flops_total
                                 if flops_total else 0.0)
    # the paper's yardstick: effective-peak fraction of the dominant term
    step_time = max(rec["roofline"].values())
    rec["roofline_fraction"] = (rec["roofline"]["compute_s"] / step_time
                                if step_time else 0.0)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config (CPU checks)")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, list_archs
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, smoke=args.smoke)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                results.append(rec)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f"trace={rec['lower_s']}s "
                             f"bottleneck={rec['bottleneck']}")
                print(f"[{status:5s}] {tag} {extra}", flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} documented skips, "
          f"{n_err} errors ==")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
