"""Serving CLI and the batch ``generate`` API over the engine.

  python -m repro_torch.launch.serve --arch qwen3-0.6b [--smoke] \\
      --batch 4 --prompt-len 16 --gen 32 [--device cuda]

Parameters are random, from ``--seed``; prompts are random tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import get_model
from repro_torch.serving import (DEFAULT_PAGE_SIZE, Engine, SamplingParams)


def generate(cfg, params, prompts, gen_len: int, greedy=True, seed=0,
             device=None):
    """Batch API: prompts (B, P) -> (B, gen_len) tokens, through the
    continuous-batching engine (one slot per prompt, pages sized to fit)."""
    prompts = np.asarray(prompts)
    B, P = prompts.shape
    ps = DEFAULT_PAGE_SIZE
    pages_per_seq = -(-(P + gen_len + 1) // ps)
    engine = Engine(cfg, params, max_slots=B,
                    num_pages=1 + B * pages_per_seq, page_size=ps,
                    max_pages_per_slot=pages_per_seq, device=device)
    rids = [engine.add_request(prompts[i], SamplingParams(
        temperature=0.0 if greedy else 1.0, max_tokens=gen_len, seed=seed + i))
        for i in range(B)]
    out = engine.run()
    return np.stack([np.asarray(out[r], np.int64) for r in rids])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="decode batch width (0 = --batch)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.policy:
        cfg = cfg.replace(policy=args.policy)
    params = get_model(cfg).init(args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    ps = DEFAULT_PAGE_SIZE
    pages = -(-(args.prompt_len + args.gen + 1) // ps)
    slots = args.max_slots or args.batch
    engine = Engine(cfg, params, max_slots=slots,
                    num_pages=1 + max(slots, args.batch) * pages,
                    page_size=ps, max_pages_per_slot=pages, device=device)
    for i in range(args.batch):
        engine.add_request(prompts[i], SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, max_tokens=args.gen, seed=args.seed + i))
    t0 = time.perf_counter()
    out = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    reasons: dict[str, int] = {}
    for v in out.values():
        reasons[v.finish_reason] = reasons.get(v.finish_reason, 0) + 1
    print(f"engine on {device}: {args.batch} requests, {slots} slots, "
          f"{engine.n_prefills} prefills, {engine.n_decode_steps} decode "
          f"steps -> {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          "kernel builds on a first run and the decode graph's capture "
          "included)")
    print(f"finish reasons: {reasons}")
    print(f"stats: {engine.stats()}")
    print("sample:", list(out[0][:16]))


if __name__ == "__main__":
    main()
