"""Serving CLI and the batch ``generate`` API.

  python -m repro_torch.launch.serve --arch qwen3-0.6b [--smoke] \\
      --batch 4 --prompt-len 16 --gen 32 [--device cuda] \\
      [--numerics fuse_epilogue=1 ...]

Two code paths, as in the JAX package:

  * :func:`generate` runs the continuous-batching engine (paged KV cache)
    for the families with a paged decode path (dense, MoE);
  * :func:`generate_dense` is the dense-cache loop: the engine's
    verification oracle, and the only path of the families without a
    paged decode path (SSM, hybrid, enc-dec, VLM), to which ``generate``
    and the CLI fall back.  Its prompt prefill is one forward where the
    family has ``prefill``; otherwise the prompt is fed through
    ``decode_step`` one token at a time, as JAX does.  For the enc-dec and
    VLM families it drives the decoder / LM path only, as JAX's does: the
    enc-dec decoder attends over a cross cache of zeros (nothing calls
    ``encdec_lm.prefill_cross``, whose serving path is ``prefill_cross``
    then ``decode_step``), and the VLM loop is text only.

Parameters are random, from ``--seed``; prompts are random tokens.
``--numerics KEY=VALUE`` (repeatable) sets fields of the numerics config the
run uses (``repro_torch.numerics.NumericsConfig``); the engine pins it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import numerics, resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import get_model
from repro_torch.models.modules import tree_map
from repro_torch.serving import (DEFAULT_PAGE_SIZE, Engine, SamplingParams)


def fill_dense_cache(cache, kv):
    """Place a sequence-level prefill's K/V (leaves (layers, B, P, ...))
    at the start of a dense cache tree (leaves (layers, B, max_len, ...)),
    in place; returns the cache."""
    def fill(c, k):
        c[tuple(slice(0, n) for n in k.shape)] = k.to(c.dtype)
        return c
    return tree_map(fill, cache, kv)


def generate_dense(cfg, params, prompts, gen_len: int, greedy=True, seed=0,
                   device=None):
    """Dense-cache loop: same-length prompts (B, P) -> (B, gen_len) tokens.

    Greedy draws are the argmax over the first ``vocab_size`` logits;
    sampled ones come from a ``torch.Generator`` seeded with ``seed`` (the
    JAX draws' distribution, not their values)."""
    device = resolve_device(device)
    model = get_model(cfg)
    prompts = torch.as_tensor(np.asarray(prompts), device=device)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen_len + 1, device=device)
    with torch.no_grad():
        if model.prefill is not None:
            logits_all, kv = model.prefill(params, prompts)
            cache = fill_dense_cache(cache, kv)
            logits = logits_all[:, -1]
        else:
            for i in range(P):
                logits, cache = model.decode_step(params, cache,
                                                  prompts[:, i], i)
        gen = None if greedy else torch.Generator(device).manual_seed(seed)
        out = []
        for i in range(gen_len):
            lv = logits[:, :cfg.vocab_size]
            if greedy:
                tok = torch.argmax(lv, dim=-1)
            else:
                tok = torch.multinomial(torch.softmax(lv.float(), -1), 1,
                                        generator=gen)[:, 0]
            out.append(tok)
            logits, cache = model.decode_step(params, cache, tok, P + i)
    return torch.stack(out, dim=1).cpu().numpy()


def generate(cfg, params, prompts, gen_len: int, greedy=True, seed=0,
             device=None):
    """Batch API: prompts (B, P) -> (B, gen_len) tokens, through the
    continuous-batching engine (one slot per prompt, pages sized to fit);
    families without a paged decode path take :func:`generate_dense`."""
    if get_model(cfg).decode_step_paged is None:
        return generate_dense(cfg, params, prompts, gen_len, greedy, seed,
                              device)
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
    numerics.add_cli_overrides(ap)
    args = ap.parse_args(argv)
    with numerics.cli_context(args):
        _main(args)


def _main(args):
    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.policy:
        cfg = cfg.replace(policy=args.policy)
    if cfg.family in ("vlm", "audio"):
        print("note: serving CLI drives the LM/decoder path of this arch")
    model = get_model(cfg)
    params = model.init(args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    if model.decode_step_paged is None:
        t0 = time.perf_counter()
        out = generate_dense(cfg, params, prompts, args.gen,
                             greedy=args.temperature <= 0, seed=args.seed,
                             device=device)
        dt = time.perf_counter() - t0
        print(f"generate_dense on {device}: {out.shape} in {dt:.2f}s "
              f"({out.size / dt:.1f} tok/s, kernel builds on a first run "
              "included)")
        print("sample:", out[0][:16].tolist())
        return
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
