#!/usr/bin/env python3
"""Kernel 3 on one H100: its time split between its two passes, and its
time at each chunk size.

    python3 scripts/kernel3_profile.py

For each decode shape (qwen3-0.6b's heads: 16 query, 8 kv, hd 128, x6,
pages of 16) and each chunk size C (``pages_per_chunk``, from one page to
the rule's pick and above it), the public entry is timed on the device
alone (``chip_smoke.device_only_ms``) over copies of the page pools large
enough that every call reads its K/V cold, and profiled with
``torch.profiler``: the device time of the first pass (``paged_chunk``)
and of the second (``paged_combine``) per call.  Each row holds the bound
(K/V bytes at 3.35 TB/s) and the kernel's agreement with the plain version
at the same C.

Output: JSON lines on stdout, the first one the card's name and power
limit.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import repro_torch  # noqa: E402,F401  (sets TF32 off)
from chip_smoke import H100_BYTES_PER_S, device_only_ms, device_us  # noqa: E402
from repro_torch.kernels import tcec_paged_attention as tp  # noqa: E402

H, HKV, HD, PS = 16, 8, 128, 16
SHAPES = [("decode 4 slots", [520, 520, 208, 208], 40),
          ("engine 4 slots", [520, 520, 208, 64], 40),
          ("decode 32 slots x 1024", [1024] * 32, 64)]
L2_BYTES = 50e6


def emit(obj):
    print(json.dumps(obj), flush=True)


def profile_passes(fn, calls):
    """Device ms a call of each kernel whose name holds 'paged_'."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for part in ("paged_chunk", "paged_combine"):
                if part in e.key:
                    out[part + "_ms"] = device_us(e) / 1e3 / calls
    return out


def run(name, lengths, maxp, dev, reps=20):
    B = len(lengths)
    NP = 1 + B * maxp
    kv_bytes = 2 * sum(lengths) * HKV * 2 * HD
    copies = max(2, min(reps, int(3 * L2_BYTES // kv_bytes) + 1))
    g = torch.Generator(device=dev).manual_seed(B + maxp)
    pools = [(torch.randn(NP, PS, HKV, HD, generator=g, device=dev).bfloat16(),
              torch.randn(NP, PS, HKV, HD, generator=g, device=dev).bfloat16())
             for _ in range(copies)]
    q = torch.randn(B, H, HD, generator=g, device=dev)
    bt = (torch.randperm(NP - 1, generator=g, device=dev) + 1).reshape(
        B, maxp).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    rule = tp.chunk_pages(B, HKV, maxp, PS, HD, HD)
    bound_ms = kv_bytes / H100_BYTES_PER_S * 1e3
    for C in sorted({1, 2, 4, 8, rule}):
        def call(i, C=C):
            k, v = pools[i % copies]
            return tp.tcec_paged_attention(q, k, v, bt, ln, pages_per_chunk=C)

        out = call(0)
        ref = tp.tcec_paged_attention_plain(q, *pools[0], bt, ln,
                                            pages_per_chunk=C)
        err = float((out - ref).abs().max()) / float(
            pools[0][1].float().abs().max())
        ms = device_only_ms(call, reps)
        live = tp.live_chunks(ln.cpu(), maxp, PS, C)
        row = {"shape": name, "chunk_pages": C, "rule": C == rule,
               "live_blocks": int(live.sum()) * HKV,
               "blocks": live.numel() * HKV, "copies": copies,
               "device_only_ms": ms, "bound_ms": bound_ms,
               "bound_share": bound_ms / ms, "err_over_max_v": err}
        row.update(profile_passes(call, reps))
        emit(row)
    del pools
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("kernel3_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"nvidia_smi": smi})
    dev = torch.device("cuda")
    for name, lengths, maxp in SHAPES:
        run(name, lengths, maxp, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
