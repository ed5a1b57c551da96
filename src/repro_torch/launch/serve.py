"""Serving CLI and the batch ``generate`` API.

  python -m repro_torch.launch.serve --arch qwen3-0.6b [--smoke] \\
      --batch 4 --prompt-len 16 --gen 32 [--device cuda] \\
      [--numerics fuse_epilogue=1 ...] [--max-waiting N] [--deadline T] \\
      [--prefix-cache] [--chunked-prefill C] [--async-sched] \\
      [--shared-prefix N] [--trace t.json] [--metrics-out m.json] \
      [--mesh-model N [--backend gloo]]

Two code paths, as in the JAX package:

  * :func:`generate` runs the continuous-batching engine (paged KV cache)
    for the families with a paged decode path (dense, MoE);
  * :func:`generate_dense` is the dense-cache loop: the engine's
    verification oracle, and the only path of the families without a
    paged decode path (SSM, hybrid, enc-dec, VLM), to which ``generate``
    and the CLI fall back.  Under an installed mesh its cache is laid out
    by ``parallel.sharding.cache_specs`` and each step's logits are made
    whole over the vocab before the token is picked.  Its prompt prefill
    is one forward where the family has ``prefill``; otherwise the prompt
    is fed through ``decode_step`` one token at a time, as JAX does.  For
    the enc-dec and VLM families it drives the decoder / LM path only, as
    JAX's does: the enc-dec decoder attends over a cross cache of zeros
    (nothing calls ``encdec_lm.prefill_cross``, whose serving path is
    ``prefill_cross`` then ``decode_step``), and the VLM loop is text
    only.

Parameters are random, from ``--seed``; prompts are random tokens.
``--numerics KEY=VALUE`` (repeatable) sets fields of the numerics config the
run uses (``repro_torch.numerics.NumericsConfig``); the engine pins it.
``--max-waiting`` bounds the engine's waiting queue (requests past it are
rejected with ``EngineOverloaded``), ``--deadline`` gives every request a
deadline in engine steps.  ``--prefix-cache``, ``--chunked-prefill C`` and
``--async-sched`` turn the engine's serving knobs on (the numerics config's
``prefix_cache``, ``chunked_prefill``, ``async_sched``), and
``--shared-prefix N`` makes the first N prompt tokens the same in every
request, so the prefix cache has something to share.  The CLI's pools are
bf16, as JAX's are.  ``--trace PATH`` runs under
``repro_torch.obs.trace()`` and exports the spans (Chrome-trace JSON, or
JSONL for ``.jsonl``); ``--metrics-out PATH`` writes the metrics snapshot;
either prints the dispatch-explain summary.  ``REPRO_FAULTS`` runs the CLI
under a fault plan (``repro_torch.faults``).

``--mesh-model N`` serves every family under a ``(world / N, N)``
``("data", "model")`` mesh (``launch/mesh.py::make_host_mesh``): the
parameters are laid out by ``parallel.sharding.param_specs``, the engine
shards its page pools (KV heads on ``model``), ``generate_dense`` its
cache, and every kernel runs per shard (``kernels/shmap.py``).  The world
is the one ``torchrun`` gives (``torchrun --nproc-per-node 2 -m
repro_torch.launch.serve ...``), or this process alone; rank 0 prints
the mesh and the results.  ``--backend`` is NCCL by default on the card;
two ranks on one card need ``--backend gloo`` (NCCL refuses them), and
then decode runs eagerly.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import numerics, obs, resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import get_model
from repro_torch.models.modules import tree_map
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as shd
from repro_torch.serving import (DEFAULT_PAGE_SIZE, Engine, EngineOverloaded,
                                 SamplingParams)


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
    mesh = ctx.current_mesh()
    if mesh is not None and ctx.is_device_mesh(mesh):
        cache = shd.shard_tree(cache, shd.to_shardings(shd.cache_specs(
            cfg, mesh, cache, B, P + gen_len + 1), mesh))
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
            lv = ctx.full(logits)[:, :cfg.vocab_size]   # vocab made whole
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
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound the waiting queue: requests past it are "
                         "rejected with EngineOverloaded (0 = unbounded)")
    ap.add_argument("--deadline", type=int, default=0,
                    help="per-request deadline in engine steps; expired "
                         "requests finish with reason=timeout (0 = none)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages copy-on-write across "
                         "requests")
    ap.add_argument("--chunked-prefill", type=int, default=0, metavar="C",
                    help="prefill prompts in C-token chunks interleaved "
                         "with decode steps (0 = single-shot)")
    ap.add_argument("--async-sched", action="store_true",
                    help="overlap host scheduling with the in-flight "
                         "decode step (block only at consume)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="make the first N prompt tokens identical across "
                         "the batch (exercises the prefix cache)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_mesh_flags(ap)
    numerics.add_cli_overrides(ap)
    obs.add_cli_flags(ap)
    args = ap.parse_args(argv)
    with numerics.cli_context(args), obs.cli_session(args):
        _main(args)


def add_mesh_flags(ap):
    ap.add_argument("--mesh-model", type=int, default=0, metavar="N",
                    help="run under a (world/N, N) (data, model) mesh; the "
                         "kernels run per shard (0 = no mesh)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's process-group backend (default nccl "
                         "on cuda, gloo on cpu)")


def cli_mesh(args, device):
    """``(mesh or None, print)``: the CLI's mesh from ``--mesh-model`` and
    ``--backend``, and a ``print`` that only rank 0 speaks through.  Rank
    0 prints the mesh, as JAX's CLIs do."""
    if not args.mesh_model:
        return None, print
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=args.mesh_model, backend=args.backend,
                          device=device.type)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    return mesh, say


def _main(args):
    device = resolve_device(args.device)
    mesh, say = cli_mesh(args, device)
    if mesh is not None:
        device = resolve_device(device.type)    # this rank's card
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.policy:
        cfg = cfg.replace(policy=args.policy)
    if cfg.family in ("vlm", "audio"):
        say("note: serving CLI drives the LM/decoder path of this arch")
    model = get_model(cfg)
    params = model.init(args.seed, device=device)
    if mesh is not None:
        params = shd.shard_tree(params, shd.to_shardings(
            shd.param_specs(params, mesh, cfg), mesh))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    if args.shared_prefix:
        n = min(args.shared_prefix, args.prompt_len)
        prompts[:, :n] = prompts[0, :n]
    if model.decode_step_paged is None:
        t0 = time.perf_counter()
        with (ctx.use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            out = generate_dense(cfg, params, prompts, args.gen,
                                 greedy=args.temperature <= 0,
                                 seed=args.seed, device=device)
        dt = time.perf_counter() - t0
        say(f"generate_dense on {device}: {out.shape} in {dt:.2f}s "
            f"({out.size / dt:.1f} tok/s, kernel builds on a first run "
            "included)")
        say("sample:", out[0][:16].tolist())
        return
    ps = DEFAULT_PAGE_SIZE
    pages = -(-(args.prompt_len + args.gen + 1) // ps)
    slots = args.max_slots or args.batch
    nc = numerics.active()
    if args.prefix_cache or args.chunked_prefill or args.async_sched:
        nc = nc.replace(
            prefix_cache=bool(args.prefix_cache) or nc.prefix_cache,
            chunked_prefill=args.chunked_prefill or nc.chunked_prefill,
            async_sched=bool(args.async_sched) or nc.async_sched)
    engine = Engine(cfg, params, max_slots=slots,
                    num_pages=1 + max(slots, args.batch) * pages,
                    page_size=ps, max_pages_per_slot=pages,
                    max_waiting=args.max_waiting or None, device=device,
                    numerics_config=nc, mesh=mesh)
    rids = []
    for i in range(args.batch):
        try:
            rids.append(engine.add_request(
                prompts[i], SamplingParams(
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, max_tokens=args.gen,
                    seed=args.seed + i),
                deadline=args.deadline or None))
        except EngineOverloaded:
            say(f"request {i}: rejected (overloaded: queue at "
                  f"{args.max_waiting})")
    t0 = time.perf_counter()
    out = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    reasons: dict[str, int] = {}
    for v in out.values():
        reasons[v.finish_reason] = reasons.get(v.finish_reason, 0) + 1
    say(f"engine on {device}: {args.batch} requests, {slots} slots, "
          f"{engine.n_prefills} prefills, {engine.n_decode_steps} decode "
          f"steps -> {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          "kernel builds on a first run and the decode graph's capture "
          "included)")
    say(f"finish reasons: {reasons}")
    stats = engine.stats()
    say(f"stats: {stats}")
    say("prefix: " + str({k: stats[k] for k in (
        "prefix_hits", "prefix_tokens_reused", "cow_splits",
        "prefix_evictions", "prefill_chunks")}))
    if rids:
        say("sample:", list(out[rids[0]][:16]))


if __name__ == "__main__":
    main()
