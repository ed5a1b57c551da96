#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on a failed check (nothing is caught):

  1. the card (``nvidia-smi`` name and power limit) and the build of the
     three CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each,
     started together);
  2. each kernel at the shapes the main path gives it, plus a ragged one:
     held against its plain PyTorch version on the card, with its time,
     the plain version's time, the least time the card could take
     (``bound_ms``) and, where one PyTorch call computes the same function,
     that call's time (``library_ms``, timed only); every kernel is also
     held to f32 accuracy at its main-path x6 shapes: its residual against
     an f64 reference is at most twice that of the same function computed
     in plain f32.  Kernel 1's rows name the path the product took
     (``wgmma`` or ``skinny``), the grid's waves over the SMs, and the
     kernel's and ``torch.matmul``'s times with the host taken out
     (``device_only_ms``: launches queued behind a sleeping kernel); the
     MLP gate also runs at the largest M of the decode path and the
     smallest of the wgmma path; three rows take the backward's products
     of a training step at 8 x 128 tokens (the unembedding's and the MLP
     down projection's weight gradients, whose A is a transposed view the
     entry copies first, ``copy_ms``; the tied unembedding's input
     gradient, K 151936); two take granite-moe-1b-a400m's expert gate
     product as a batch of 32 (at decode, M 4, and at the 2 x 512
     prefill, M 320; ``torch.bmm`` beside it); three take phase 9's new
     shapes (mamba2-130m's SSD chunk products ``y_intra``, a batch of 48 at
     N 64, and the chunk state, a batch of 2 whose A is a transposed view;
     zamba2-1.2b's ``w_cat`` at decode, K 4096, and its B, C and dt
     projections at decode, N 64); two take phase 10's (seamless's untied
     unembedding at decode, N 256256, and internvl2's MLP gate at decode);
     six take phase 11b's step at 1 x 16384 (blocked attention's chunk
     products, a batch of 8: the scores and dP at M 4096, K 128, N 2048,
     P.V and dQ at M 4096, K 2048, N 128, dV and dK with A^T at K 4096;
     the MLP gate at M 16384; the unembedding's weight gradient at K
     16384, A^T); six take phase 12's (gemma-2b's tied unembedding at
     decode, N 256000, K 2048, B^T; qwen2.5-14b's MLP gate at decode and
     at the 2 x 512 prefill, N 13824, K 5120; at that prefill, M 1024 on
     path W, the gemmas' tied unembeddings, N 256000, K 2048 and 3584,
     B^T, and gemma2-9b's MLP gate, N 14336, K 3584); three take phase
     13's (deepseek-v3-671b's experts' gate at decode, a batch of 256, K
     7168, N 2048: 15 GB streamed; the absorbed decode's ``w_uk`` product,
     a batch of 128 heads, K 128, N 512, B a per-head view of the stored
     (512, 128, 128) weight read in place, ``torch.einsum`` beside it; and
     ``wo`` at the 2 x 512 prefill, K 16384, N 7168).  The rows are
     ``KERNEL1_CASES`` and ``DEEPSEEK_KERNEL1_CASES``;
     ``scripts/kernel1_rows.py`` times the first list on two checkouts.
     Kernel 2 runs at all four
     of the engine's prefill shapes, at the training shape 8 x 128, at 2 x
     512 with head_dim 64 (granite, and zamba2's 32/32 heads), once at
     x10 with a softcap and a window, non-causal at seamless's encoder
     (2 x 512, 16/16 heads of 64) and its cross-attention at decode (4 x 1
     queries against 512 keys), and at 1 x 16384 (phase 11b's training
     length; its f64 and f32 references are computed 1024 query rows at a
     time), and at phase 12's shapes: head_dim 256 at 2 x 512 for
     gemma-2b (8/1 heads) and gemma2-9b (16/8, softcap 50), gemma2-9b's
     local layer at 1 x 8192 (window 4096, which binds, softcap 50), x3 and
     x10 at head_dim 256, and qwen2.5-14b's 40/8 heads of 128 (5 query
     heads a kv head: padding rows in each block), and deepseek-v3-671b's
     MLA prefill (2 x 512, 128/128 heads, qk head dim 192 beside a v head
     dim of 128; f32 SDPA beside it); the f32 gate takes the
     window and the softcap; its ``ms`` is the public entry's,
     ``device_only_ms`` the same with the host taken out,
     ``kernel_only_ms`` the kernel's launch alone on operands already
     contiguous f32.  Kernel 3
     runs at the engine's decode shape (head_dim 128, and 64 for granite),
     a ragged one with a window, 32 slots of 1024 tokens (bound by
     bytes), gemma-2b's decode (8/1 heads of 256) and gemma2-9b's at 4
     slots of 5000/5000/4200/300 tokens (window 4096, which binds, softcap
     50; the f32 gate takes both), and its f32 instantiation (f32 pools,
     phase 16's) at qwen3-0.6b's and gemma2-9b's decode; copies of its page
     pools are rotated so that each timed call reads K/V cold, and each row
     names the chunk size ``chunk_pages``, the blocks and live blocks of
     the first pass and the share of the bound reached on the device
     (``bound_share``).  Kernel 2 also runs at a chunk of phase 16's
     chunked prefill: 256 queries at positions 256-511 against a scratch of
     768 keys (SDPA with a boolean mask beside it);
  3. the paper's check: at 2048^3, kernel 1's x6 residual against an f64
     product is at most twice that of an f32 ``torch.matmul``;
  4. the main path: the serving engine at the full width of qwen3-0.6b with
     random weights from a seed, 8 greedy requests; every kernel's launch
     count is zeroed before and read after, and each must be > 0.  The
     prompts (512, 512, 200, 200, 64, 64, 17, 17 tokens) arrive so that each
     admission prefills two prompts of one padded length together: the
     prefills are 2 x 512, 2 x 208, 2 x 64 and 2 x 32, the shapes phase 2
     times.  Decode steps are replays of the engine's captured CUDA graph
     (one eager warm-up step before the capture); the row gives the capture
     time, the replays and the host seconds spent in prefills;
  4b. the decode program against eager decode: a second engine at full
     width (4 slots, greedy and sampled requests) runs 8 decode steps, each
     replayed and also run eagerly through ``_decode_and_sample`` on a copy
     of the same state; logits, guard bits, tokens and the page pools must
     be bitwise equal;
  5. one 64-token prefill through the kernels against the same prefill with
     ``dispatch.use_plain()`` (relative logits difference <= 1e-3); then a
     prefill of its first 4 tokens through the kernels allocates less than
     one layer's largest weight (the weights are read in place);
  6. where the time goes: a third engine with four slots (512, 512, 200
     and 64 tokens) times 32 decode steps one by one with the profiler off
     (median and spread), then profiles 4 steps and one 2 x 512 prefill
     under ``torch.profiler``: each window's wall time, the device time of
     its kernels, the device's idle share, each port kernel's device time
     and launches, and the largest kernels.  Last, the decode program's
     two graphs are replayed back to back between CUDA events: their
     device time with the host taken out;
  7. training: (a) ``train()`` on qwen3-0.6b at full width, random
     weights from seed 0, batch 8 x 128, lr 1e-3, warmup 2, 8 steps, no
     checkpoint; the launch counts are zeroed before and read after (34L
     + 3 of kernel 1 and 2L of kernel 2 a step), every loss is finite and
     the last below the first; the row gives the step time (median and
     spread of steps 3-8) and the peak memory, then one more step is
     profiled as in phase 6; (b) one full-width ``loss_fn`` and backward
     through the kernels against the same under ``dispatch.use_plain()``:
     loss, gradient norm and the worst leaf within 1e-3 (relative); the
     kernel side launches kernel 1 34L + 3 and kernel 2 2L times, the plain
     side (backward and recomputes included) neither;
     (c) a 2-layer cut at full widths trains 2 steps and checkpoints,
     resumes to 4, and must end within 1e-5 of a fresh run to 4;
  8. the MoE family: granite-moe-1b-a400m at full width (24 layers,
     d_model 1024, 32 experts top 8), random weights from seed 0.  (a)
     phase 4's engine run with its checks (7L + 1 = 169 launches of kernel
     1 a forward: q, k, v, o, the three expert products and the unembed;
     the router and the bf16 dispatch and combine products are plain
     products) and phase 4b's replay comparison; (b) phase 5's 64-token
     prefill against ``dispatch.use_plain()``: each MoE layer's routes are
     compared first and the count of moved routes printed; where none
     moved, the logits are held to 1e-3; where routes moved, (c) decides,
     and the positions before the first moved route are held to 2^-8 (the
     MoE layers round the experts' inputs and outputs to bf16); (c) one
     MoE layer at 2 x 512 on identical inputs, kernels against plain:
     equal routes, 3 / 0 launches, the experts' f32 outputs within 8 F
     2^-24 and the layer's output within 2^-8 of their largest entries;
     (d) phase 6's windows (decode step median and spread of 32, 4
     profiled steps, the graphs' device time, a profiled 2 x 512
     prefill);
  9. the SSM and hybrid families, served by ``generate_dense`` (no paged
     decode path): mamba2-130m and zamba2-1.2b at full width and depth,
     random weights from seed 0, each freed before the next.  (a)
     ``generate_dense``, 4 greedy prompts of 64 tokens fed through
     ``decode_step`` one at a time, 16 generated; launch counts zeroed
     before and read after, as counted from the code (``ssm_counts``:
     kernel 1 145 a mamba2 step and 283 a zamba2 step, kernels 2 and 3
     none: the dense cache attends in plain bf16); tok/s, then the same
     run with every step timed to its synchronize (median, p10/p90 of the
     16 generated steps) beside the step's byte bound; (b)
     ``forward_logits`` at 2 x 512 against ``dispatch.use_plain()``
     (relative logits difference <= 1e-3; kernel 1 337 and 587, kernel 2
     0 and 6; the plain side none); (c) one 512-token prompt, the last
     position's logits of ``forward_logits`` (chunked) against
     ``decode_step`` fed token by token (the recurrence): 1e-3 for mamba2,
     2^-8 for zamba2, whose decode attends over a bf16 cache in bf16
     products; (d) one decode step at 4 slots and one 2 x 512 forward under
     ``torch.profiler``, idle shares against the unprofiled times;
  10. the enc-dec and VLM families: seamless-m4t-large-v2 and internvl2-2b
     at full width and depth, random weights from seed 0, each freed
     before the next.  (a) seamless served: ``init_cache(4, 81,
     mem_len=512)``, ``prefill_cross`` on 4 x 512 frames, then
     ``generate_dense``'s loop (64 prompt tokens fed one ``decode_step`` at
     a time, 16 greedy); launches as counted from the code
     (``family_counts``: ``prefill_cross`` 217 of kernel 1 and 24 of
     kernel 2, a decode step 217 and 24, the cross-attention one query
     row); tok/s, the step's median and p10/p90, ``prefill_cross``'s ms and
     the step's byte bound; two runs, the same tokens; (b)
     ``forward_logits`` on 2 x 512 frames + 2 x 512 tokens against
     ``dispatch.use_plain()`` (434 / 72 launches; relative logits
     difference <= 1e-3) and one ``decode_step`` after ``prefill_cross``,
     kernels against plain on copies of one cache state (<= 1e-3); (c)
     internvl2 through 9a's ``generate_dense`` run (169 of kernel 1 a
     step) and ``forward_logits`` on 2 x (256 patches + 256 tokens) against
     ``use_plain()`` (171 / 24); (d) 9d's profiles for both;
  11. the paper's numerics and the long-sequence path.  (a) Fig. 11: the
     JAX bench's exponent bands (Types 1-4: -15..14, -35..-15 and
     -100..-35 for A and B) from ``core/matgen.py::exp_rand`` at 4096^3
     (the bench's seeds), through ``policy_mm`` under x3, x6 and x10
     (kernel 1, path W), fp32 and bf16 (one f32 product, TF32 off), and
     fp16_halfhalf and fp16_markidis (the term expansion); then each of
     these on its own safe band (the conformance battery's
     ``operand_band``), and x9 (the TwoSum loop, plain PyTorch) with x6
     beside it at 1024^3 on each Type and on its band.  Each row: the Eq.
     (7) residual against the f64 product, its ratio to f32 SGEMM's
     (``torch.matmul``), ``theory.policy_error_bound`` at the band's low
     end and the policy's ``safe_exponent_range``.  Gates, the JAX
     package's own: every policy within its bound on its safe band; x6 at
     most 2x SGEMM on Types 1 and 3; x9 below half of x6 on every Type;
     x9's ``head + tail`` within 1e-13 of f64 at 1024^3 (uniform inputs);
     fp16_halfhalf worse than x6 on Type 3; kernel 1 launched 19 times.
     (b) blocked attention: one qwen3-0.6b layer's attention (16/8 heads
     of 128) at 1 x 8192, the gradients of ``_FusedSDPA``'s recompute
     backward (``blocked_attention``, 10 live chunk pairs: 60 kernel-1
     launches) against an ``mha`` backward on the same q, k, v under
     ``dispatch.use_plain()`` (no launch; 1e-3 of each gradient's largest
     entry), with each side's peak memory; then a
     full-width qwen3-0.6b train step at 1 x 16384 (seed-0 weights and
     data, remat, one AdamW step at lr 1e-3): every layer's backward takes
     ``blocked_attention`` (28 calls), kernel 1 (28 + 6 x 36 live pairs) L
     + 3 = 6835 and kernel 2 2L = 56 launches, loss, gradient norm and
     updated parameters finite; the row gives the step time and the peak
     memory;
  12. the larger dense models: gemma-2b, gemma2-9b and qwen2.5-14b at full
     width and depth (2.5 B, 9.2 B and 14.8 B parameters: 10, 37 and 59 GB
     in f32), random weights from seed 0, each freed before the next: phase
     4's engine run with its checks (7L + 1 / L / L launches a forward,
     prefill and decode step) and phase 4b's replay, phase 5's 64-token
     prefill against ``dispatch.use_plain()`` (1e-3); (12b)
     ``forward_logits`` at the engine's widest prefill, 2 x 512 (kernel 1
     on path W, M 1024, the unembedding too), against the plain path run
     one sequence at a time (1e-3; 7L + 1 / L / 0 launches); phase 6's
     timed and profiled windows (16 steps, 2 profiled, a profiled 2 x 512
     prefill); the parameter count, ``init_s`` and the memory: the init's
     peak at most the weights + the largest layer + the largest leaf; no
     weight copied: a 4-token prefill through the kernels (path S)
     allocates less than one layer's largest weight (as in phase 5), and
     the 2 x 512 forward less than its logits (three times over with the
     final softcap) and that weight; each phase's peak below the card's
     memory.  The same memory fields are recorded in phases 4 and 8;
  13. MLA and the MoE layer of deepseek-v3-671b at full width, depth cut
     to 4 layers (3 dense MLA layers, 1 MoE layer of 256 experts with a
     shared expert; the MTP head off: 60.44 GB in f32), random weights
     from seed 0.  (a) the init's peak at most the weights + the largest
     leaf (an expert stack, 15.03 GB); (b) phase 4's engine run and 4b's
     replay (``forward_counts``: 44 / 4 / 0 launches a prefill, 44 / 0 / 0
     a decode step; MLA decodes in the latent space over a page gather,
     without kernel 3); (c) the 64-token prefill and ``forward_logits`` at
     2 x 512 (path W; the plain side one sequence at a time) against
     ``dispatch.use_plain()``, each MoE layer's routes recorded on both
     sides: 1e-3 at the positions before a sequence's first moved route,
     and 8c's layer check on identical inputs (2^-8); (d) during one
     decode step and one 4-token prefill, every kernel-1 launch reads its
     B inside a parameter leaf's storage (the copy gate of this model: its
     largest layer weight is a 15 GB expert stack); (e) phase 6's windows
     (16 steps, 2 profiled, a profiled 2 x 512 prefill): the step's median
     and spread, busy and idle share, kernel 1's share and its weight
     stream in TB/s against the step's byte bound (every weight but the
     embedding, 56.74 GB); the peaks below the card; (f) 9a's
     ``generate_dense`` over the MLA dense cache (the prompts prefilled in
     one forward), then the engine on the same prompts: equal tokens
     reported, no gate; (g) the MTP head at the smoke config: ``loss_fn``
     and its gradients against ``use_plain()`` (7b's 1e-3 rule);
  14. the numerics config and the measured tuner, the engine pinned to
     ``NumericsConfig(policy="tcec_bf16x6", fuse_epilogue=True,
     tune="force")`` with a tune cache of its own.  (a) qwen3-0.6b at full
     width: phase 4's 8-request run (7L + 1 kernel-1 launches a forward, L
     of them with the silu epilogue: ``tcec_matmul.epilogue_launches``),
     the same run unfused (equal greedy tokens counted, no gate), the
     64-token prefill's logits and ``forward_logits`` at 2 x 512 against
     ``dispatch.use_plain()`` and against the unfused kernel path (1e-3
     each), 4b's replay check under the pin; (b) gemma-2b at full width
     the same (GeGLU: gelu in the epilogue, d_ff 16384); (c) the tuner:
     each kernel-1 bucket the runs filled with its chosen path and both
     paths' measured times, kernel 3's chosen C beside ``chunk_pages``'s; a
     second ``BlockCache`` on the file gives the same choices with no
     measurement; every bucket whose measured path is not the rule by M's
     runs on the chosen path against plain (``8 K 2^-24 |A||B|``) and the
     f32 gate; the 2 x 32 and 2 x 64 prefills timed tuned against
     ``tune="off"`` (no gate); no miss during a capture; (d) the hatches:
     an engine run under ``enabled=False`` launches no kernel (64-token
     logits within 1e-3 of the kernel path), one under
     ``paged_attention=False`` no kernel 3, and a train step's forward
     under ``use(enabled=False)`` whose backward runs after the scope
     launches none; (e) ``repro_torch.matmul`` at 2048^3 (kernel 1 once,
     phase 3's gate) and ``repro_torch.attention`` at 2 x 512 (kernel 2
     once, 1e-5 max|v| of plain); (f) reported, no gate: 13g's comparison
     under ``tune="auto"``, beside the plain side against itself with the
     parameters scaled by 1 + 1e-7;
  15. faults, telemetry and the guard: qwen3-0.6b at full width, random
     weights from seed 0, phase 4's 8 requests on fresh engines (the
     launch counts zeroed before each run and read after).  (a) the run
     under ``obs.trace()`` (exported to ``chiprun_out/trace_phase15.json``)
     against an untraced one: equal greedy tokens; every request's
     ``request`` begin, ``admitted`` and ``request`` end (with its finish
     reason) events; the queue-wait, TTFT and TPOT histograms non-empty
     (count, p50, p90 printed); tok/s and the decode step's median of both,
     and the host seconds of a 2 x 32 prefill with the explain table
     recording and without (reported, no gate); (b) every explain decision
     of the traced run for kernels 1-3 is ``fused``, each kernel has one,
     and a forward under ``enabled=False`` records only ``hatch-disabled``
     and launches nothing; (c) chaos under ``guard=True``, each plan on the
     8 requests: ``pool.alloc@0:1`` and ``prefill@0`` (tokens equal the
     fault-free run's), ``decode.nonfinite@3:arg=1`` (the slot-1 request
     ends ``error``, no re-run, every other request's tokens equal),
     ``kernel.matmul@0:1`` (2 failures counted, every request ends with its
     tokens or ``error``; the outcome printed), ``decode.slow@every=4:
     arg=3`` with deadline 12 (every request ends at the same clock, and
     with the same reason, as the same run on the CPU at the smoke
     config), ``kernel.paged`` at the decode graph's capture (that step's
     requests end ``error``, the next step captures afresh, the later
     requests' tokens equal), and the breaker's whole cycle at the MLP
     gate's decode product (2 failures open it, the cooldown's 8 calls
     raise ``KernelQuarantined`` without a launch, the probe launches,
     bitwise, and closes it); the plain versions of kernels 1-3, wrapped,
     are called 0 times across (c); (d) ``monitor=True``: the 64-token
     prefill's logits bitwise those without it and no risk counted; a
     product scaled out of the safe exponent range counts one; the decode
     graph's capture skips its probes (counted); (e) ``max_waiting=2``
     rejects the 3rd to 8th request with ``EngineOverloaded``, and
     ``max_preemptions=1`` on a 92-page pool parks a request while every
     request finishes with its fault-free tokens.  The phase prints its
     own seconds;
  16. the prefix cache, chunked prefill, async scheduling and defragment:
     qwen3-0.6b at full width, random weights from seed 0, f32 pools, 4
     slots, 8 greedy requests of one shared 512-token prefix and tails of
     128, 128, 64, 64, 32, 32, 17 and 17 tokens (16 tokens each), on fresh
     engines: knobs off (the reference), ``prefix_cache``,
     ``chunked_prefill=256``, ``async_sched``, all three (with one
     ``defragment()`` once the first request has finished), and knobs off
     again (the warm times).  Gates: every run's tokens equal the
     reference's; the prefix runs' hits and reused tokens at least those of
     the same plan on the CPU at the smoke config; the 32 pages a hit maps
     bitwise those the reference's prefill of that request writes; a hit's
     first-token logits bitwise the reference's where the tail's kernel-1
     products take the monolithic prefill's path, else within 1e-3 (which,
     printed); each chunk 7L + 1 / L launches of kernels 1 / 2; every
     kernel-3 launch on the f32 instantiation; 0 plain-version calls; the
     decode graph over f32 pools replayed bitwise as the eager step (4b).
     Printed: each run's tok/s, decode-step median and TTFT of requests 5-8
     (p50, p90 of the host-clock samples), and the profiled device busy
     time of requests 5-8's prefill with and without the prefix cache;
  17. the parallel layer in child processes (see the section comment);
  18. the dry run held to the card: in a child process (the dry run's fake
     world becomes the default process group), qwen3-0.6b at full width
     traced through ``launch/step.py::lower_cell`` on a one-rank mesh at
     the 8 x 128 train step, ``forward_logits`` at 2 x 512 and the serve
     step on a dense cache of 4 x 1024, and then each step on the card.
     Gates: each step's kernel-1/2/3 launches on the card equal the
     trace's, and kernel 1's FLOPs from the launch shapes equal the
     trace's.  Printed: the trace's peak beside ``max_memory_allocated``,
     the roofline step time from ``dryrun.HW`` beside the measured median
     (``roofline_fraction``), a profiled step.  18b traces qwen3-0.6b's
     train_4k cell on the (16, 16) fake world through the dry run's CLI
     (gate: status ok; its seconds printed).

Phases 2-13 run under the default numerics config, whose tune mode is
"off" (the rule by M, the parent's routing bit for bit); the tuner writes
only to files under ``chiprun_out/`` that each run starts afresh
(``tcec_autotune*.json``; the home directory is neither read nor written);
phase 2's rows call the kernels directly.

Every line of output is one JSON object, except the ``nvidia-smi`` line.
The last line is ``{"ok": true, "device": {...}}``.  The full record is
also written to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_OPS = 989e12          # dense bf16 tensor-core peak
H100_F32_OPS = 67e12            # f32 outside the tensor cores
U24 = 2.0 ** -24
RECORD: dict = {"kernel_checks": []}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_only_ms(fn, reps):
    """fn(i) for i < reps on the device alone: the launches are queued
    behind a sleeping kernel, so host time does not count."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rotating(fn_of_i):
    """fn(i) for timed runs, fn(0) for warm-up."""
    return lambda i=0: fn_of_i(i)


def bound(nbytes, ops, rate):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- kernel 1

def matmul_case(name, M, N, K, dev, trans_b=False, copies=1, reps=5,
                plain_reps=2, policy="tcec_bf16x6", trans_a=False,
                batch=None, per_head=False):
    """Kernel 1 at one product.  ``trans_a``: A is the transpose of a
    contiguous (K, M) tensor, as in a weight gradient ``x^T . g``; the
    entry then copies it first (``dispatch._canonicalize`` does), and the
    row gives that copy's time alone (``copy_ms``, device only).
    ``batch``: a batch of that many products (the MoE expert products;
    the library call is then ``torch.bmm``).  ``per_head``: B is the
    per-head view (batch, K, N) of a weight stored (N, batch, K), as MLA's
    absorbed decode reads ``w_uk`` (batch stride K, columns batch K
    apart), read in place; the library call is then ``torch.einsum``."""
    from repro_torch.core import get_policy
    from repro_torch.kernels import ops, tcec_matmul as tm
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    bsh = () if batch is None else (batch,)
    a = (torch.randn(*bsh, K, M, generator=g, device=dev).transpose(-1, -2)
         if trans_a else torch.randn(*bsh, M, K, generator=g, device=dev))

    def entry(b):
        return ops.tcec_matmul(a.contiguous(), b, policy)
    # `copies` weight copies of more than the 50 MB L2 in all, so a timed
    # launch reads its weight cold, as each layer of a decode step does
    shape = ((N, batch, K) if per_head else
             bsh + ((N, K) if trans_b else (K, N)))
    ws = [torch.randn(shape, generator=g, device=dev) * K ** -0.5
          for _ in range(copies)]
    bs = [w.permute(1, 2, 0) if per_head else w.mT if trans_b else w
          for w in ws]
    trans_b = trans_b or per_head
    out = entry(bs[0])
    ref = tm.tcec_matmul_plain(a, bs[0], policy)
    tol = 8 * K * U24 * (a.abs() @ bs[0].abs())
    err = (out - ref).abs()
    check(bool((err <= tol).all()), f"{name}: kernel 1 vs plain beyond "
          "8 K 2^-24 (|A| @ |B|)")
    ms = time_ms(rotating(lambda i: entry(bs[i % copies])), reps)
    plain_ms = time_ms(rotating(lambda i: tm.tcec_matmul_plain(
        a, bs[i % copies], policy)), plain_reps)
    lib = (functools.partial(torch.einsum, "hmk,hkn->hmn") if per_head
           else torch.bmm if batch else torch.matmul)
    lib_ms = time_ms(rotating(lambda i: lib(a, bs[i % copies])), reps)
    # the same launches with host time taken out (decode rows are host
    # bound through the entry, as torch.matmul is)
    dev_ms = device_only_ms(lambda i: entry(bs[i % copies]), reps)
    lib_dev_ms = device_only_ms(lambda i: lib(a, bs[i % copies]), reps)
    passes = get_policy(policy).passes
    nb = batch or 1
    b_ms, by = bound(4 * nb * (M * K + K * N + M * N),
                     passes * 2 * nb * M * N * K, H100_BF16_OPS)
    blocks, per_sm = tm.grid(M, N, nb, trans_b, policy)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row = {"kernel": "tcec_matmul", "shape": name, "batch": batch, "M": M,
           "N": N, "K": K, "trans_a": trans_a, "trans_b": trans_b,
           "per_head": per_head,
           "policy": policy,
           "path": tm.path(M),
           "blocks": blocks, "blocks_per_sm": per_sm,
           "waves": blocks / (per_sm * sms),
           "max_abs_err": float(err.max()),
           "tolerance": "8*K*2^-24*(|A|@|B|) elementwise",
           "max_err_over_tol": float((err / tol).max()),
           "ms": ms, "device_only_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
           "library_device_only_ms": lib_dev_ms,
           "library": ("torch.einsum" if per_head else
                       f"torch.{'bmm' if batch else 'matmul'}")
           + " f32, TF32 off"}
    if trans_a:
        row["copy_ms"] = device_only_ms(lambda i: a.contiguous(), reps)
    if policy == "tcec_bf16x6":
        f32_gate(row, a.double() @ bs[0].double(), out, a @ bs[0])
    emit(row)
    RECORD["kernel_checks"].append(row)
    del a, ws, bs, out, ref, tol, err
    torch.cuda.empty_cache()
    return row


# Kernel 1's phase-2 rows: each at the shapes the main path gives it.
# ``scripts/kernel1_rows.py`` times the same list on two checkouts.
KERNEL1_CASES = [
    dict(name="unembed at prefill (B*P=2*512)", M=1024, N=151936, K=1024,
         trans_b=True, reps=3),
    dict(name="mlp gate at prefill (B*P=2*512)", M=1024, N=3072, K=1024,
         reps=20, plain_reps=5),
    dict(name="mlp gate at decode (4 slots)", M=4, N=3072, K=1024, copies=8,
         reps=40, plain_reps=10),
    # the same product on each side of the path threshold (64)
    dict(name="mlp gate at M 64 (path threshold 64)", M=64, N=3072, K=1024,
         copies=8, reps=40, plain_reps=10),
    dict(name="mlp gate at M 65 (path threshold 64)", M=65, N=3072, K=1024,
         copies=8, reps=40, plain_reps=10),
    dict(name="unembed at decode (4 slots)", M=4, N=151936, K=1024,
         trans_b=True, reps=20, plain_reps=3),
    dict(name="ragged 1000^3", M=1000, N=1000, K=1000, reps=10,
         plain_reps=5),
    # the backward of a training step at 8 x 128 tokens (phase 7): the
    # weight gradients x^T . g read A transposed, the tied unembedding's
    # input gradient g . E contracts over the vocabulary
    dict(name="unembed dW at training (8x128)", M=1024, N=151936, K=1024,
         trans_a=True, reps=3, plain_reps=1),
    dict(name="unembed dx at training (8x128)", M=1024, N=1024, K=151936,
         reps=3, plain_reps=1),
    dict(name="mlp down dW at training (8x128)", M=3072, N=1024, K=1024,
         trans_a=True, reps=20, plain_reps=5),
    # granite-moe-1b-a400m's expert gate product (phase 8), a batch of 32
    # experts: at decode (4 slots, capacity 4) and at the 2 x 512 prefill
    # (8 groups of 128 tokens, capacity 40)
    dict(name="expert gate at decode (4 slots), batch 32", M=4, N=512,
         K=1024, batch=32, copies=2, reps=40, plain_reps=5),
    dict(name="expert gate at 2x512 prefill, batch 32", M=320, N=512,
         K=1024, batch=32, reps=20, plain_reps=3),
    # the SSM and hybrid families (phase 9): mamba2-130m's SSD chunk
    # products at 2 x 512 (chunks of 256, 24 heads of 64, state 128), the
    # chunk state's A a transposed view; zamba2-1.2b's w_cat at decode
    dict(name="mamba2 y_intra at 2x512, batch 48", M=256, N=64, K=256,
         batch=48, reps=20, plain_reps=3),
    dict(name="mamba2 chunk state at 2x512, batch 2, A^T", M=128, N=1536,
         K=256, batch=2, trans_a=True, reps=20, plain_reps=3),
    dict(name="zamba2 w_cat at decode (4 slots)", M=4, N=2048, K=4096,
         copies=4, reps=40, plain_reps=5),
    # zamba2's B, C and dt projections at decode: N 64 gives path S 4 blocks
    dict(name="zamba2 B/C/dt projection at decode (4 slots), N 64", M=4,
         N=64, K=2048, copies=128, reps=128, plain_reps=5),
    # the enc-dec and VLM families (phase 10): seamless's untied
    # unembedding at decode (N 256256, B read as stored, 1.05 GB) and
    # internvl2's MLP gate at decode
    dict(name="seamless unembed at decode (4 slots), N 256256", M=4,
         N=256256, K=1024, reps=20, plain_reps=3),
    dict(name="internvl2 mlp gate at decode (4 slots)", M=4, N=8192, K=2048,
         copies=4, reps=40, plain_reps=10),
    # phase 11b's qwen3-0.6b step at 1 x 16384: blocked attention's chunk
    # products, a batch of B x Hkv = 8 (2 query heads of a KV head x 2048
    # queries, 2048 keys, head_dim 128): the scores and dP = dO . V^T, P . V
    # and dQ = dS . K, and the A^T gradient products dV = P^T . dO and
    # dK = dS^T . Q; the MLP gate at M 16384 and the unembedding's weight
    # gradient at K 16384 (x^T . g)
    dict(name="blocked scores / dP at 1x16384, batch 8", M=4096, N=2048,
         K=128, batch=8, reps=10, plain_reps=2),
    dict(name="blocked P.V / dQ at 1x16384, batch 8", M=4096, N=128, K=2048,
         batch=8, reps=10, plain_reps=2),
    dict(name="blocked dV at 1x16384, batch 8, A^T", M=2048, N=128, K=4096,
         batch=8, trans_a=True, reps=10, plain_reps=2),
    dict(name="blocked dK at 1x16384, batch 8, A^T", M=128, N=2048, K=4096,
         batch=8, trans_a=True, reps=10, plain_reps=2),
    dict(name="mlp gate at 1x16384", M=16384, N=3072, K=1024, reps=5,
         plain_reps=1),
    dict(name="unembed dW at 1x16384, K 16384, A^T", M=1024, N=151936,
         K=16384, trans_a=True, reps=3, plain_reps=1),
    # phase 12's larger dense models: gemma-2b's tied unembedding at decode
    # (N 256000, B^T: the 2.1 GB embedding read in place), qwen2.5-14b's
    # MLP gate at decode and at the 2 x 512 prefill
    dict(name="gemma-2b unembed at decode (4 slots), N 256000, B^T", M=4,
         N=256000, K=2048, trans_b=True, reps=20, plain_reps=2),
    dict(name="qwen2.5-14b mlp gate at decode (4 slots)", M=4, N=13824,
         K=5120, reps=40, plain_reps=5),
    dict(name="qwen2.5-14b mlp gate at prefill (B*P=2*512)", M=1024,
         N=13824, K=5120, reps=10, plain_reps=2),
    # and path W at the gemmas' 2 x 512 prefill: their tied unembeddings
    # (N 256000, B^T) and gemma2-9b's MLP gate
    dict(name="gemma-2b unembed at prefill (B*P=2*512), N 256000, B^T",
         M=1024, N=256000, K=2048, trans_b=True, reps=3, plain_reps=1),
    dict(name="gemma2-9b unembed at prefill (B*P=2*512), N 256000, B^T",
         M=1024, N=256000, K=3584, trans_b=True, reps=3, plain_reps=1),
    dict(name="gemma2-9b mlp gate at prefill (B*P=2*512)", M=1024, N=14336,
         K=3584, reps=10, plain_reps=2),
]
# phase 13's deepseek-v3-671b: the experts' gate at decode (256 experts of
# 7168 x 2048, 15.03 GB, streamed once), the absorbed decode's w_uk product
# over 128 heads (B a per-head view of the (512, 128, 128) weight, read in
# place: batch stride 128, columns 16384 apart), and wo at the 2 x 512
# prefill (path W, K 16384)
DEEPSEEK_KERNEL1_CASES = [
    dict(name="deepseek expert gate at decode (4 slots), batch 256", M=4,
         N=2048, K=7168, batch=256, reps=10, plain_reps=1),
    dict(name="deepseek absorbed w_uk at decode (4 slots), batch 128, "
         "per-head B", M=4, N=512, K=128, batch=128, per_head=True,
         copies=4, reps=40, plain_reps=5),
    dict(name="deepseek wo at prefill (B*P=2*512), K 16384", M=1024, N=7168,
         K=16384, reps=10, plain_reps=2),
]


def matmul_epilogue_check(dev):
    from repro_torch.kernels import ops, tcec_matmul as tm
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn(3, 1000, 1000, generator=g, device=dev)
    b = torch.randn(3, 1000, 1000, generator=g, device=dev) * 0.03
    bias = torch.randn(1000, generator=g, device=dev)
    out = ops.tcec_matmul(a, b, "tcec_bf16x6", bias=bias, activation="gelu",
                          out_scale=0.5)
    ref = tm.tcec_matmul_plain(a, b, "tcec_bf16x6", bias=bias,
                               activation="gelu", out_scale=0.5)
    tol = 1.2 * 0.5 * 8 * 1000 * U24 * (a.abs() @ b.abs()) + 8 * U24 * ref.abs()
    err = (out - ref).abs()
    check(bool((err <= tol).all()), "kernel 1 batched epilogue vs plain")
    row = {"kernel": "tcec_matmul", "shape": "batched 3x1000^3 bias+gelu",
           "max_abs_err": float(err.max()),
           "max_err_over_tol": float((err / tol).max())}
    emit(row)
    RECORD["kernel_checks"].append(row)


def residual(ref, x):
    """Norm-wise relative residual of ``x`` against an f64 ``ref``."""
    return float(torch.linalg.norm(ref - x.double()) / torch.linalg.norm(ref))


def f32_gate(row, ref64, out, plain_f32):
    """Hold a kernel to f32 accuracy: its residual against the f64 reference
    is at most twice that of the same function in plain f32.  A kernel that
    dropped a scale group (x3 arithmetic) sits ~15x above the f32 one."""
    row["residual_f64"] = residual(ref64, out)
    row["f32_residual_f64"] = residual(ref64, plain_f32)
    check(row["residual_f64"] <= 2 * row["f32_residual_f64"],
          f"{row['shape']}: residual vs f64 <= 2x that of plain f32")


# ------------------------------------------------------------- kernel 2

def attention_direct(q, k, v, dtype, causal=True, window=0, softcap=None,
                     q0=0):
    """GQA attention computed directly in ``dtype`` (no split); causal
    masks keys after the query's position (queries from ``q0``, keys from
    0), a window keys ``window`` or more positions before it, and a
    softcap caps the scores.  1024 queries at a time, so that long
    sequences fit."""
    rows = 1024
    B, S, H, hd = q.shape
    T, rep = k.shape[1], H // k.shape[2]
    ks = k.to(dtype).repeat_interleave(rep, 2).transpose(1, 2)
    vs = v.to(dtype).repeat_interleave(rep, 2).transpose(1, 2)
    outs = []
    for r0 in range(0, S, rows):
        qs = q[:, r0:r0 + rows].to(dtype).transpose(1, 2)
        sc = qs @ ks.transpose(-1, -2) / math.sqrt(hd)
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        d = (torch.arange(q0 + r0, q0 + r0 + qs.shape[2],
                          device=q.device)[:, None]
             - torch.arange(T, device=q.device)[None])
        keep = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
        if window:
            keep = keep & (d < window)
        if not bool(keep.all()):
            sc = sc.masked_fill(~keep, -math.inf)
        outs.append((torch.softmax(sc, -1) @ vs).transpose(1, 2))
        del sc
    return torch.cat(outs, 1)


def attention_case(name, B, S, H, Hkv, hd, dev, reps=20, policy="tcec_bf16x6",
                   window=0, softcap=None, causal=True, T=None, hdv=None,
                   q0=0):
    """Kernel 2 at (B, S) queries against T keys (default S; key positions
    from 0, query positions from ``q0``: a chunk of a chunked prefill),
    value head dim ``hdv`` (default hd): against its plain version (1e-5
    max|v|) and, for plain x6 attention, against f64 (the f32 gate); timed
    beside f32 SDPA where SDPA computes the same function (with a boolean
    mask for a chunk)."""
    from repro_torch.core import get_policy
    from repro_torch.kernels import tcec_attention as ta
    T = S if T is None else T
    hdv = hd if hdv is None else hdv
    g = torch.Generator(device=dev).manual_seed(S + B + T + q0)
    q = torch.randn(B, S, H, hd, generator=g, device=dev)
    k = torch.randn(B, T, Hkv, hd, generator=g, device=dev)
    v = torch.randn(B, T, Hkv, hdv, generator=g, device=dev)
    qp, kp = (torch.arange(n, dtype=torch.int32, device=dev) for n in (S, T))
    qp = qp + q0
    kw = dict(policy=policy, window=window, softcap=softcap, causal=causal)
    pos = (qp, kp) if q0 else (None, None)
    out = ta.tcec_attention(q, k, v, *pos, **kw)
    ref = ta.tcec_attention_plain(q, k, v, *pos, **kw)
    err = float((out - ref).abs().max())
    tol = 1e-5 * float(v.abs().max())
    check(err <= tol, f"{name}: kernel 2 vs plain beyond 1e-5 max|v|")
    ms = time_ms(rotating(lambda i: ta.tcec_attention(q, k, v, *pos, **kw)),
                 reps)
    dev_ms = device_only_ms(lambda i: ta.tcec_attention(q, k, v, *pos, **kw),
                            reps)
    # the launch alone, without the entry's policy lookup and checks
    pol = get_policy(policy)
    kernel_ms = time_ms(rotating(lambda i: ta._launch(
        q, k, v, qp, kp, pol, causal, window, softcap, math.sqrt(hd))), reps)
    plain_ms = time_ms(rotating(lambda i: ta.tcec_attention_plain(
        q, k, v, *pos, **kw)), 2)
    lib_ms = None
    if not window and not softcap and (S == T or not causal or q0):
        rep = H // Hkv
        qs, ks, vs = (q.transpose(1, 2), k.repeat_interleave(rep, 2)
                      .transpose(1, 2), v.repeat_interleave(rep, 2)
                      .transpose(1, 2))
        if q0:        # the chunk's causal mask at its real positions
            mask = qp.long()[:, None] >= kp.long()[None, :]
            lib_ms = time_ms(rotating(lambda i: torch.nn.functional
                                      .scaled_dot_product_attention(
                                          qs, ks, vs, attn_mask=mask)), reps)
        else:
            lib_ms = time_ms(rotating(lambda i: torch.nn.functional
                                      .scaled_dot_product_attention(
                                          qs, ks, vs, is_causal=causal)),
                             reps)
    # (q, k) pairs the mask keeps: causal, and within the window if any
    d = (torch.arange(q0, q0 + S, device=dev)[:, None]
         - torch.arange(T, device=dev)[None, :])
    kept = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
    if window:
        kept = kept & (d < window)
    pairs = int(kept.sum())
    ops = pol.passes * 2 * (hd + hdv) * pairs * H * B  # QK^T and PV products
    nbytes = 4 * (B * S * H * (hd + hdv) + B * T * Hkv * (hd + hdv)) + 4 * (
        S + T)
    b_ms, by = bound(nbytes, ops, H100_BF16_OPS)
    row = {"kernel": "tcec_attention", "shape": name, "B": B, "S": S,
           "T": T, "q0": q0, "H": H, "Hkv": Hkv, "hd": hd, "hdv": hdv,
           "policy": policy,
           "causal": causal, "window": window,
           "window_binds": bool(window) and S > window, "softcap": softcap,
           "max_abs_err": err, "tolerance": "1e-5*max|v|", "tol": tol,
           "ms": ms, "device_only_ms": dev_ms, "kernel_only_ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": lib_ms,
           "library": (f"scaled_dot_product_attention f32 "
                       f"{'causal' if causal else 'non-causal'}"
                       f"{', boolean mask' if q0 else ''}"
                       if lib_ms is not None else None)}
    if policy == "tcec_bf16x6":
        ref64, ref32 = (attention_direct(q, k, v, dt, causal, window, softcap,
                                         q0)
                        for dt in (torch.float64, torch.float32))
        f32_gate(row, ref64, out, ref32)
        del ref64, ref32
    emit(row)
    RECORD["kernel_checks"].append(row)
    return row


# ------------------------------------------------------------- kernel 3

def paged_direct(q, kp, vp, bt, ln, dtype, window=0, softcap=None):
    """Paged decode attention computed directly in ``dtype``, slot by slot
    (no split): the last ``window`` tokens (all without one), the scores
    capped by ``softcap``."""
    B, H, hd = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    outs = []
    for b in range(B):
        n = int(ln[b])
        lo = max(0, n - window) if window else 0
        pages = bt[b, :-(-n // ps)].long()
        kk = kp[pages].reshape(-1, Hkv, hd)[lo:n].to(dtype)
        vv = vp[pages].reshape(-1, Hkv, hd)[lo:n].to(dtype)
        kk = kk.repeat_interleave(H // Hkv, 1)
        vv = vv.repeat_interleave(H // Hkv, 1)
        sc = torch.einsum("hd,thd->ht", q[b].to(dtype), kk) / math.sqrt(hd)
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        outs.append(torch.einsum("ht,thd->hd", torch.softmax(sc, -1), vv))
    return torch.stack(outs)


def paged_case(name, lengths, H, Hkv, hd, ps, maxp, dev, window=0, reps=20,
               copies=16, plain_reps=2, softcap=None, dtype=torch.bfloat16):
    """Kernel 3 at one decode step over ``dtype`` pools (bf16, or f32: its
    f32 instantiation): against its plain version at the same chunk size C
    (1e-5 max|v|) and against f64 (the f32 gate; every slot here holds a
    token).  ``copies`` copies of the pools are rotated so that a timed
    call reads its K/V cold, as the engine finds them after a layer's
    weights."""
    from repro_torch.core import get_policy
    from repro_torch.kernels import tcec_paged_attention as tp
    B = len(lengths)
    NP = 1 + B * maxp
    g = torch.Generator(device=dev).manual_seed(sum(lengths) + maxp)
    pools = [(torch.randn(NP, ps, Hkv, hd, generator=g, device=dev).to(dtype),
              torch.randn(NP, ps, Hkv, hd, generator=g, device=dev).to(dtype))
             for _ in range(copies)]
    kp, vp = pools[0]
    q = torch.randn(B, H, hd, generator=g, device=dev)
    perm = torch.randperm(NP - 1, generator=g, device=dev) + 1
    bt = perm.reshape(B, maxp).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    elem = kp.element_size()
    C = tp.chunk_pages(B, Hkv, maxp, ps, hd, hd, elem)
    kw = dict(window=window, softcap=softcap)
    out = tp.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    ref = tp.tcec_paged_attention_plain(q, kp, vp, bt, ln, pages_per_chunk=C,
                                        **kw)
    err = float((out - ref).abs().max())
    tol = 1e-5 * float(vp.float().abs().max())
    check(err <= tol, f"{name}: kernel 3 vs plain beyond 1e-5 max|v|")
    check(bool((out[ln <= 0] == 0).all()),
          f"{name}: empty slots must return zeros")

    def call(i):
        k, v = pools[i % copies]
        return tp.tcec_paged_attention(q, k, v, bt, ln, **kw)

    ms = time_ms(rotating(call), reps)
    dev_ms = device_only_ms(call, reps)
    plain_ms = time_ms(rotating(lambda i: tp.tcec_paged_attention_plain(
        q, kp, vp, bt, ln, **kw)), plain_reps)
    valid = sum(min(n, window) if window else max(n, 0) for n in lengths)
    kv_bytes = 2 * valid * Hkv * elem * hd
    nbytes = 4 * B * H * hd * 2 + kv_bytes + 4 * B * (maxp + 1)
    # QK and PV products: the 3 (i, 0) passes over bf16 pages, every kept
    # pass (6 at x6) over f32 pages, whose terms are not zero
    passes = 3 if elem == 2 else get_policy("tcec_bf16x6").passes
    ops = passes * 2 * 2 * hd * valid * H
    b_ms, by = bound(nbytes, ops, H100_F32_OPS)
    live = tp.live_chunks(ln.cpu(), maxp, ps, C, window)
    row = {"kernel": "tcec_paged_attention", "shape": name,
           "pools": str(dtype).replace("torch.", ""),
           "lengths": lengths if B <= 8 else f"{B} x {lengths[0]}",
           "window": window, "softcap": softcap,
           "window_binds": bool(window) and max(lengths) > window, "H": H,
           "Hkv": Hkv, "hd": hd, "page_size": ps,
           "maxp": maxp, "chunk_pages": C, "blocks": live.numel() * Hkv,
           "live_blocks": int(live.sum()) * Hkv,
           "second_pass": live.shape[1] > 1, "copies": copies,
           "rotated_kv_mb": copies * kv_bytes / 1e6, "max_abs_err": err,
           "tolerance": "1e-5*max|v|", "tol": tol, "ms": ms,
           "device_only_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": by, "bound_share": b_ms / dev_ms, "library_ms": None}
    if min(lengths) > 0:
        f32_gate(row, paged_direct(q, kp, vp, bt, ln, torch.float64, **kw),
                 out, paged_direct(q, kp, vp, bt, ln, torch.float32, **kw))
    emit(row)
    RECORD["kernel_checks"].append(row)
    return row


# ------------------------------------------------------------ phase 3

def paper_check(dev):
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(2048)
    n = 2048
    a = torch.rand(n, n, generator=g, device=dev) * 2 - 1
    b = torch.rand(n, n, generator=g, device=dev) * 2 - 1
    ref = a.double() @ b.double()

    def resid(c):
        return float(torch.linalg.norm(ref - c.double())
                     / torch.linalg.norm(ref))

    r6 = resid(ops.tcec_matmul(a, b, "tcec_bf16x6"))
    r32 = resid(a @ b)
    row = {"paper_check": "2048^3 uniform[-1,1): x6 vs f32 SGEMM residual",
           "x6_residual": r6, "sgemm_residual": r32, "ratio": r6 / r32}
    emit(row)
    RECORD["paper_check"] = row
    check(r6 <= 2 * r32, "x6 residual <= 2x the f32 SGEMM residual")


# ------------------------------------------------------------ phase 4/5

def forward_counts(cfg):
    """Kernel launches of one engine prefill and of one decode step,
    counted from the code.  Kernel 1: 4 products in a layer's attention (q,
    k, v, o) or 7 with MLA (w_dq, w_uq, w_dkv, w_kr, w_uk and w_uv: at
    decode absorbed, at prefill decompressing K and V; wo), 3 in its MLP or
    experts (the router and the bf16 dispatch and combine are plain
    products), 3 more in a shared expert, and the unembedding: 7L + 1 in
    the dense family and granite, 10 n_dense + 13 n_moe + 1 in
    deepseek-v3-671b.  Kernel 2 once a layer in a prefill; kernel 3 once a
    layer in a decode step, none with MLA (its latent attend is three
    plain bf16 products over a page gather)."""
    from repro_torch.models.lm import stacks
    k1 = 1 + sum(n * ((7 if cfg.use_mla else 4) + 3
                      + (3 if moe and cfg.n_shared_experts else 0))
                 for _, n, moe in stacks(cfg))
    L = cfg.n_layers
    return {"prefill": {"tcec_matmul": k1, "tcec_attention": L,
                        "tcec_paged_attention": 0},
            "decode": {"tcec_matmul": k1, "tcec_attention": 0,
                       "tcec_paged_attention": 0 if cfg.use_mla else L}}


def serve_run(dev, arch, key, cfg=None):
    """Phase 4 (8 for granite, 12, 13): the engine at the full width of
    ``arch`` (or at ``cfg``), random weights from seed 0, the 8 greedy
    requests; the launch counts are zeroed just before the run and read
    just after.  Then phase 4b on the same weights.  Returns the launches,
    ``(cfg, model, params)`` and the 64 tokens of phase 5 (drawn after the
    prompts); the rows go to ``RECORD[key]``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    from repro_torch.models import get_model
    from repro_torch.models.modules import param_count
    from repro_torch.serving import Engine, SamplingParams
    cfg = cfg or get_config(arch)
    model = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mem = init_memory(params, base)
    engine = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                    page_size=16, max_pages_per_slot=40, device=dev)
    mem["pools_gb"] = tree_bytes(engine.pools) / 1e9
    rng = np.random.default_rng(0)
    # two prompts of each length, in a row, so each admission of four
    # prefills two batches of two (all finish on one step, so the second
    # four are admitted together too)
    lens = [512, 512, 200, 200, 64, 64, 17, 17]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    probe = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(dev)
    prefill_s = timed_method(engine, "_admit_and_prefill")
    mods = (tm, ta, tp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.launches = 0
    t0 = time.perf_counter()
    out = engine.run(prompts, SamplingParams(max_tokens=16))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel_counts()
    # the run's peak beside the weights and the pools
    mem["run_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    mem["run_extra_gb"] = (mem["run_peak_gb"] - mem["weights_gb"]
                           - mem["pools_gb"])
    stats = engine.stats()
    tokens = sum(len(v) for v in out.values())
    row = {"engine": f"{arch} full width, random weights (seed 0)",
           "n_layers": cfg.n_layers,
           "params": param_count(params), "init_s": init_s,
           "requests": len(prompts), "prompt_lengths": lens,
           "max_tokens": 16, "max_slots": 4, "page_size": 16,
           "generated_tokens": tokens, "seconds": dt,
           "tokens_per_s": tokens / dt, "prefill_s": sum(prefill_s),
           "prefill_share": sum(prefill_s) / dt,
           "prefills": stats["prefills"],
           "decode_steps": stats["decode_steps"],
           "decode_warmups": stats["decode_warmups"],
           "capture_s": stats["capture_s"],
           "graph_replays": stats["graph_replays"],
           "sampler_replays": stats["sampler_replays"],
           "preemptions": stats["preemptions"], "launches": launches,
           "finish_reasons": sorted({v.finish_reason for v in out.values()}),
           "memory": mem}
    emit(row)
    RECORD[key] = {"engine": row}
    check(mem["init_peak_gb"] <= mem["weights_gb"] + mem["largest_layer_gb"]
          + mem["largest_leaf_gb"], "init peak <= weights + the largest "
          "layer + the largest leaf")
    check(all(v.finish_reason == "length" and len(v) == 16
              for v in out.values()), "every request finished with 16 tokens")
    counts = forward_counts(cfg)
    check(all(launches[k] > 0 for k in launches
              if counts["prefill"][k] or counts["decode"][k]),
          "every kernel of the path launched")
    check(stats["prefills"] == 4 and stats["preemptions"] == 0,
          "four prefills of two prompts each: 2x512, 2x208, 2x64, 2x32")
    check(stats["decode_warmups"] == 1
          and stats["graph_replays"] == stats["decode_steps"]
          and stats["sampler_replays"] == 0,
          "every decode step a replay of the graph captured after one "
          "warm-up step; all greedy, so no sampler replay")
    # decode forwards: every step, plus the warm-up before the capture
    decodes = stats["decode_steps"] + stats["decode_warmups"]
    row["launches_counted"] = {
        k: counts["prefill"][k] * stats["prefills"]
        + counts["decode"][k] * decodes for k in launches}
    check(launches == row["launches_counted"], "launches of every prefill "
          "and decode forward as counted (forward_counts)")

    torch.cuda.reset_peak_memory_stats()
    RECORD[key]["replay_vs_eager"] = replay_equals_eager(
        dev, cfg, params)                          # phase 4b
    mem["replay_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    return launches, (cfg, model, params), probe


def tree_bytes(tree):
    from repro_torch.models.modules import tree_leaves
    return sum(t.nbytes for t in tree_leaves(tree))


def largest_leaf_bytes(params):
    """The largest leaf, a layer's slice of each stacked leaf (the
    ``*blocks`` trees) counted on its own: an embedding, or one layer's
    largest weight."""
    from repro_torch.models.modules import tree_leaves
    return max(t[0].nbytes if k.endswith("blocks") else t.nbytes
               for k, v in params.items() for t in tree_leaves(v))


def layer_leaf_bytes(params):
    """One layer's largest weight: the largest slice of a stacked leaf."""
    from repro_torch.models.modules import tree_leaves
    return max(t[0].nbytes for k, v in params.items() if k.endswith("blocks")
               for t in tree_leaves(v))


def init_memory(params, base):
    """The parameters' bytes, their largest layer and leaf, and the peak
    of the init that made them (allocated since ``base``), in GB."""
    from repro_torch.models.modules import tree_leaves
    layers = [tree_bytes(v) / len(tree_leaves(v)[0]) for k, v in
              params.items() if k.endswith("blocks")]
    return {"weights_gb": tree_bytes(params) / 1e9,
            "largest_layer_gb": max(layers) / 1e9,
            "largest_leaf_gb": largest_leaf_bytes(params) / 1e9,
            "init_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "base_bytes": base}


def logits_vs_plain(model, params, toks, key):
    """Phase 5 (and 12): a 64-token prefill through the kernels against the
    same prefill under ``dispatch.use_plain()``, the logits within 1e-3;
    the plain side's peak (its term copies of each weight) is recorded.
    Then the weights are read in place: a prefill of the first 4 tokens
    through the kernels (kernel 1 on path S, as at decode) allocates less
    than one layer's largest weight, so a copy of that weight or of the
    embedding fails the gate.  (At 64 tokens the logits and K/V alone
    outgrow qwen3-0.6b's largest layer weight; that prefill's allocation
    is recorded.)"""
    from repro_torch.kernels import dispatch

    def allocated(fn):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - before

    with torch.no_grad():
        (fast, _), extra = allocated(lambda: model.prefill(params, toks))
        torch.cuda.reset_peak_memory_stats()
        with dispatch.use_plain():
            plain, _ = model.prefill(params, toks)
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        rel = float((fast - plain).abs().max() / plain.abs().max())
        del fast, plain
        _, probe = allocated(lambda: model.prefill(params, toks[:, :4]))
    layer = layer_leaf_bytes(params)
    row = {"logits_check": "64-token prefill, kernels vs dispatch.use_plain()",
           "max_rel_diff": rel, "limit": 1e-3,
           "kernel_prefill_extra_gb": extra / 1e9,
           "plain_peak_allocated_gb": plain_peak / 1e9,
           "probe_4_tokens_extra_gb": probe / 1e9,
           "largest_layer_weight_gb": layer / 1e9}
    emit(row)
    RECORD[key]["logits_check"] = row
    check(math.isfinite(rel) and rel <= 1e-3, "prefill logits vs plain path")
    check(probe < layer, "the kernels' 4-token prefill copies no weight: it "
          "allocates less than one layer's largest weight")
    return plain_peak


def main_path(dev):
    """Phases 4, 4b and 5 on qwen3-0.6b."""
    launches, (cfg, model, params), toks = serve_run(dev, "qwen3-0.6b",
                                                     "serving")
    logits_vs_plain(model, params, toks, "serving")
    return launches, (cfg, model, params)


def timed_method(obj, name):
    """Wrap ``obj.name`` so that each call's host seconds are appended to
    the returned list (the engine's prefill ends in a sync of its own)."""
    fn, spent = getattr(obj, name), []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(obj, name, timed)
    return spent


def replay_equals_eager(dev, cfg, params, steps=8, numerics_config=None,
                        cache_dtype=torch.bfloat16, mesh=None):
    """Phase 4b: each of ``steps`` decode steps of a full-width engine is
    replayed and also run eagerly through ``_decode_and_sample`` on copies
    of the same pools and inputs; everything must be bitwise equal.  With
    ``numerics_config`` the engine is pinned to it (its model handle runs
    the eager step under it too); ``cache_dtype`` is the pools' (phase 16
    replays over f32 pools); under ``mesh`` (phase 17b) the engine and the
    eager step run under that mesh."""
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.parallel import ctx
    from repro_torch.serving import Engine, SamplingParams
    from repro_torch.serving import engine as em
    engine = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                    page_size=16, max_pages_per_slot=40, device=dev,
                    numerics_config=numerics_config, cache_dtype=cache_dtype,
                    mesh=mesh)
    def scope():
        return (ctx.use_mesh(mesh) if mesh is not None
                else contextlib.nullcontext())
    rng = np.random.default_rng(2)
    knobs = [dict(), dict(temperature=0.8, top_k=50, top_p=0.9, seed=1),
             dict(), dict(temperature=1.0, seed=2)]
    for n, kw in zip((512, 200, 64, 17), knobs):
        engine.add_request(rng.integers(0, cfg.vocab_size, n),
                           SamplingParams(max_tokens=steps + 4, **kw))
    engine.step()                      # prefills, warm-up, capture, replay
    graph = engine._graph
    B, maxp = engine.max_slots, engine.max_pages_per_slot
    compared = []

    def checked(staged, sample):
        pools = tree_map(torch.clone, engine.pools)
        v = em._input_views(staged.to(dev), B, maxp)
        out, done = em._DecodeGraph.launch(graph, staged, sample)
        done.synchronize()
        with scope():
            toks, finite, logits = em._decode_and_sample(
                params, pools, v["block_tables"], v["lengths"],
                v["next_tok"], v["temps"], v["topks"], v["topps"],
                v["uniforms"], v["poison"], model=engine.model, cfg=cfg)
        check(torch.equal(logits, graph.logits), "replayed logits == eager")
        check(out[0].tolist() == finite.long().tolist(),
              "replayed guard bits == eager")
        check(out[1].tolist() == toks.tolist(), "replayed tokens == eager")
        check(all(torch.equal(ctx.full(a), ctx.full(b))
                  for a, b in zip(tree_leaves(pools),
                                  tree_leaves(engine.pools))),
              "page pools after the replay == after the eager step")
        compared.append(sample)
        return out, done

    graph.launch = checked
    for _ in range(steps):
        engine.step()
    del graph.launch
    row = {"replay_vs_eager": f"{cfg.name} full width, 4 slots (512, 200, "
           "64, 17 tokens; 2 greedy, 2 sampled)",
           "pools": str(cache_dtype).replace("torch.", ""),
           "steps": len(compared),
           "sampler_replays": sum(compared), "bitwise_equal": True,
           "capture_s": graph.capture_s}
    emit(row)
    check(len(compared) == steps and all(compared),
          f"{steps} compared steps, each with the sampler graph")
    return row


# ------------------------------------------------------------ phase 6

def device_us(event):
    """An event's own device time (the attribute's name differs between
    PyTorch versions)."""
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


# the port's kernels by the names of their CUDA kernels
PORT_KERNELS = {"tcec_matmul": ("skinny_kernel", "wide_kernel"),
                "tcec_attention": ("tcec_attention_kernel",),
                "tcec_paged_attention": ("paged_chunk_kernel",
                                         "paged_combine_kernel")}


def profile_window(name, fn, top=8):
    """Run ``fn`` under ``torch.profiler``; where its time went on the card:
    wall time (host clock around work that ends in a synchronize), the
    summed device time of its kernels, the idle share, each port kernel's
    device time and launches (kernel 3's two passes together), the device
    time of PyTorch's copy kernels (contiguous copies: ``_canonicalize``'s
    among them), the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((device_us(e) / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(k[0] for k in kernels) if kernels else None
    port = {name: [sum(k[i] for k in kernels if any(p in k[2] for p in pats))
                   for i in (0, 1)] for name, pats in PORT_KERNELS.items()}
    copies = sum(k[0] for k in kernels if "copy" in k[2])
    row = {"window": name, "wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms if kernels else None,
           "copy_kernels_ms": copies,
           "port_kernels": {k: {"ms": ms, "count": n}
                            for k, (ms, n) in port.items()},
           "kernels": [{"ms": ms, "count": n, "name": key[:90]}
                       for ms, n, key in kernels[:top]]}
    emit(row)
    RECORD["profile"].append(row)
    return row


def where_time_goes(dev, cfg, model, params, timed=32, steps=4, label=""):
    """Phase 6 (and 8, 12 and 13 with ``label``, which prefixes every
    window's name); returns the rows: ``step`` (the timed window),
    ``decode`` (the profiled steps), ``graphs`` and ``prefill``."""
    from repro_torch.serving import Engine, SamplingParams
    RECORD.setdefault("profile", [])
    rng = np.random.default_rng(1)
    engine = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                    page_size=16, max_pages_per_slot=40, device=dev)
    for n in (512, 512, 200, 64):
        engine.add_request(rng.integers(0, cfg.vocab_size, n),
                           SamplingParams(max_tokens=timed + steps + 8))
    engine.step()                       # admission, prefills, capture
    engine.step()                       # one decode step to warm up
    torch.cuda.synchronize()
    walls = []
    for _ in range(timed):              # each step ends in its one sync
        t0 = time.perf_counter()
        engine.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(walls))
    step_row = row = {
        "window": f"{label}decode step, 4 slots, profiler off ({timed} "
                  "steps)",
        "decode_step_ms": med, "tokens_per_s": 4e3 / med,
        "min_ms": min(walls), "p10_ms": float(np.percentile(walls, 10)),
        "p90_ms": float(np.percentile(walls, 90)), "max_ms": max(walls),
        "capture_s": engine.stats()["capture_s"]}
    emit(row)
    RECORD["profile"].append(row)

    def decode():
        for _ in range(steps):
            engine.step()

    prof = profile_window(f"{label}{steps} decode steps, 4 slots", decode)
    # the two graphs on the device alone (replaying the last step's inputs
    # rewrites the same K/V in place).  The profiler's own host cost
    # lengthens its window, so the idle share of a step is its kernels'
    # summed time (from the profile) against the unprofiled median
    graph = engine._graph
    main_ms = device_only_ms(lambda i: graph.main.replay(), 20)
    sampler_ms = device_only_ms(lambda i: graph.sampler.replay(), 20)
    kernels_ms = prof["device_busy_ms"] / steps
    row = {"window": f"{label}decode graphs, device only (CUDA events)",
           "main_graph_ms": main_ms, "sampler_graph_ms": sampler_ms,
           "kernels_ms_per_step": kernels_ms,
           "idle_share_of_median_step": 1 - kernels_ms / med,
           "graph_share_of_median_step": main_ms / med}
    emit(row)
    RECORD["profile"].append(row)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).to(dev)
    with torch.no_grad():
        model.prefill(params, toks)     # warm
        pre = profile_window(f"{label}prefill 2 x 512",
                             lambda: model.prefill(params, toks))
    return {"step": step_row, "decode": prof, "graphs": row, "prefill": pre}


# ------------------------------------------------------------ phase 7

def training(dev):
    """Phase 7: the training path at full width; returns its launches."""
    launches, state = train_full_width(dev)         # 7a
    grads_vs_plain(dev, state["params"])            # 7b
    del state
    torch.cuda.empty_cache()
    restart_replay(dev)                             # 7c
    return launches


def _quiet(*_):
    pass


def train_full_width(dev, steps=8):
    """7a: ``train()`` on qwen3-0.6b at full width, seed-0 weights, batch
    8 x 128, lr 1e-3, warmup 2, no checkpoint; then one more step under
    ``torch.profiler``."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import tcec_attention as ta, tcec_matmul as tm
    from repro_torch.launch.step import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg = get_config("qwen3-0.6b")
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = DataConfig(seed=0, global_batch=8, seq_len=128)
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=steps + 1,
                           straggler_factor=1e9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mods = (tm, ta)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for m in mods:
            m.launches = 0
        state, hist = train(cfg, opt, data, loop, ckpt_dir, device=dev,
                            log=_quiet)
        torch.cuda.synchronize()
        launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
        check(not os.listdir(ckpt_dir), "no checkpoint written")
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    times = [h["time_s"] * 1e3 for h in hist[2:]]       # steps 3 to 8
    L = cfg.n_layers
    # a step: the forward's 7L + 1 products, the remat recompute's 7L, two
    # gradient products each, and in each layer's attention backward the
    # recomputed composition's 2 products and their 4 gradient products;
    # kernel 2 in each layer's forward and again in its recompute
    per_step = {"tcec_matmul": 34 * L + 3, "tcec_attention": 2 * L}
    row = {"training": "qwen3-0.6b full width, random weights (seed 0), "
           "batch 8 x 128, lr 1e-3, warmup 2, remat", "steps": steps,
           "losses": losses, "step_ms_median": float(np.median(times)),
           "step_ms_min": min(times), "step_ms_max": max(times),
           "step_ms_all": [h["time_s"] * 1e3 for h in hist],
           "tokens_per_s": 1024e3 / float(np.median(times)),
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "launches_per_step": per_step}
    emit(row)
    RECORD["training"] = row
    check(all(math.isfinite(x) for x in losses), "every loss finite")
    check(losses[-1] < losses[0], "the last loss below the first")
    check(all(launches[k] == steps * n for k, n in per_step.items()),
          "kernel 1: 34L + 3 and kernel 2: 2L launches a training step")
    step_fn = make_train_step(cfg, opt)
    batch = device_batch(cfg, data, steps, dev)
    prof = profile_window("train step 8 x 128",
                          lambda: step_fn(state, batch), top=10)
    # the profiler's own host cost stretches its window, so the idle share
    # of a step is its kernels' summed time against the unprofiled median
    busy = prof["device_busy_ms"]
    row = {"window": "train step 8 x 128, shares of device busy time",
           "device_busy_ms": busy,
           "idle_share_of_median_step": 1 - busy / row["step_ms_median"],
           "copy_share": prof["copy_kernels_ms"] / busy,
           **{f"{k}_share": v["ms"] / busy
              for k, v in prof["port_kernels"].items() if v["count"]}}
    emit(row)
    RECORD["profile"].append(row)
    return launches, state


def grads_vs_plain(dev, params):
    """7b: one full-width ``loss_fn`` and backward through the kernels
    against the same under ``dispatch.use_plain()``; the kernel side must
    launch kernels 1 and 2 as a training step does, and the plain side,
    backward and recomputes included, must launch neither."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import (dispatch, tcec_attention as ta,
                                     tcec_matmul as tm)
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves, tree_map
    cfg = get_config("qwen3-0.6b")
    model = get_model(cfg)
    batch = device_batch(cfg, DataConfig(seed=1, global_batch=8,
                                         seq_len=128), 0, dev)

    def loss_and_grads():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = model.loss_fn(p, batch)
        return float(loss.detach()), torch.autograd.grad(loss,
                                                         tree_leaves(p))

    def counts():
        torch.cuda.synchronize()
        return {"tcec_matmul": tm.launches, "tcec_attention": ta.launches}

    c0 = counts()
    loss, grads = loss_and_grads()
    c1 = counts()
    with dispatch.use_plain():
        ploss, pgrads = loss_and_grads()
    c2 = counts()
    kernel_launches = {k: c1[k] - c0[k] for k in c0}
    plain_launches = {k: c2[k] - c1[k] for k in c0}
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    pnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in pgrads)))
    leaf = max(float((g - p).abs().max() / p.abs().max())
               for g, p in zip(grads, pgrads))
    row = {"grads_check": "qwen3-0.6b full width, 8 x 128: loss_fn + "
           "backward, kernels vs dispatch.use_plain()",
           "loss": loss, "plain_loss": ploss,
           "loss_rel_diff": abs(loss - ploss) / abs(ploss),
           "grad_norm": norm, "plain_grad_norm": pnorm,
           "grad_norm_rel_diff": abs(norm - pnorm) / pnorm,
           "worst_leaf_rel_diff": leaf,
           "tolerance": "1e-3 each (leaf: max|g - g_plain| / max|g_plain|)",
           "kernel_launches": kernel_launches,
           "plain_launches": plain_launches}
    emit(row)
    RECORD["grads_check"] = row
    L = cfg.n_layers
    check(kernel_launches == {"tcec_matmul": 34 * L + 3,
                              "tcec_attention": 2 * L},
          "kernel side: 34L + 3 kernel-1 and 2L kernel-2 launches")
    check(plain_launches == {"tcec_matmul": 0, "tcec_attention": 0},
          "plain side: no kernel launch, backward included")
    check(row["loss_rel_diff"] <= 1e-3, "loss vs plain")
    check(row["grad_norm_rel_diff"] <= 1e-3, "gradient norm vs plain")
    check(leaf <= 1e-3, "every gradient leaf vs plain")


def restart_replay(dev):
    """7c: a 2-layer cut of qwen3-0.6b at full widths trains 2 steps and
    checkpoints, resumes to 4; a fresh run to 4 in another directory must
    end within 1e-5 of it (not bitwise: the embedding's gradient is a
    scatter-add with atomics)."""
    import tempfile
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg = get_config("qwen3-0.6b").replace(n_layers=2)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    data = DataConfig(seed=0, global_batch=8, seq_len=128)

    def loop(steps, every):
        return TrainLoopConfig(total_steps=steps, ckpt_every=every,
                               straggler_factor=1e9)

    with tempfile.TemporaryDirectory() as run, \
            tempfile.TemporaryDirectory() as fresh_dir:
        t0 = time.perf_counter()
        train(cfg, opt, data, loop(2, 2), run, device=dev, log=_quiet)
        first_s = time.perf_counter() - t0
        check(ckpt.latest_step(run) == 2, "a checkpoint at step 2")
        ckpt_mb = sum(f.stat().st_size for f in
                      Path(run, "step_00000002").iterdir()) / 1e6
        t0 = time.perf_counter()
        resumed, hist = train(cfg, opt, data, loop(4, 100), run, device=dev,
                              log=_quiet)
        resume_s = time.perf_counter() - t0
        fresh, fhist = train(cfg, opt, data, loop(4, 100), fresh_dir,
                             device=dev, log=_quiet)
    check([h["step"] for h in hist] == [3, 4], "the resume runs steps 3-4")
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(resumed["params"]), tree_leaves(fresh["params"])))
    row = {"restart_replay": "qwen3-0.6b cut to 2 layers, full widths, "
           "8 x 128: 2 steps + checkpoint, resume to 4, against a fresh "
           "run to 4", "max_abs_param_diff": diff, "limit": 1e-5,
           "checkpoint_mb": ckpt_mb, "first_run_s": first_s,
           "resume_run_s": resume_s,
           "resumed_losses": [h["loss"] for h in hist],
           "fresh_losses": [h["loss"] for h in fhist]}
    emit(row)
    RECORD["restart_replay"] = row
    check(diff <= 1e-5, "resumed params within 1e-5 of the fresh run's")


# ------------------------------------------------------------ phase 8

@contextlib.contextmanager
def recorded(module, name, when=lambda *a: True, keep=lambda out: out):
    """Inside the scope, the results of ``module.name`` (looked up at each
    call), or what ``keep`` takes of them, are appended to the list it
    yields, for the calls whose arguments satisfy ``when``."""
    results, fn = [], getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if when(*a, **kw):
            results.append(keep(out))
        return out

    setattr(module, name, wrapped)
    try:
        yield results
    finally:
        setattr(module, name, fn)


def moved_routes(a, b):
    """Two runs' routes, call by call: the count of tokens whose expert
    sets differ in each call, and the first such token (its position in
    the flattened (G, gs) groups, its call, and the gap between its K-th
    and (K+1)-th gate in ``b``), or None."""
    counts, first = [], None
    for i, (ra, rb) in enumerate(zip(a, b)):
        differ = (ra["topi"].sort(-1).values != rb["topi"].sort(-1).values
                  ).any(-1).reshape(-1)
        counts.append(int(differ.sum()))
        if counts[-1] and (first is None
                           or int(differ.nonzero()[0]) < first["token"]):
            t = int(differ.nonzero()[0])
            K = rb["topi"].shape[-1]
            g = rb["gates"].reshape(-1, rb["gates"].shape[-1])[t]
            top = g.sort(descending=True).values
            first = {"token": t, "call": i,
                     "gate_gap": float(top[K - 1] - top[K]),
                     "gate_k": float(top[K - 1])}
    return counts, first


def moe_path(dev):
    """Phase 8: granite-moe-1b-a400m at full width.  (a) phases 4 and 4b's
    engine run and replay comparison; (b) the 64-token prefill through the
    kernels against ``dispatch.use_plain()``: the routes of each MoE layer
    are compared first.  Where none moved, the logits are held to 1e-3.
    A moved route changes its token far beyond any product tolerance, and
    every later position through attention: then (c) decides, and the
    positions before the first moved route are held to 2^-8 (the MoE
    layers round the experts' inputs and outputs to bf16, so two
    f32-accurate paths differ there by bf16 rounding steps; (c) shows it on
    one layer); (c) one MoE layer on identical inputs, kernels against
    plain; (d) phase 6's timing windows.  Returns (a)'s launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers
    arch = "granite-moe-1b-a400m"
    launches, (cfg, model, params), toks = serve_run(dev, arch, "moe")
    with recorded(layers, "moe_route") as routes, torch.no_grad():
        fast, _ = model.prefill(params, toks)
        n = len(routes)
        with dispatch.use_plain():
            plain, _ = model.prefill(params, toks)
    moved, first = moved_routes(routes[:n], routes[n:])
    held = toks.shape[1] if first is None else first["token"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    row = {"logits_check": f"{arch}: 64-token prefill, kernels vs "
           "dispatch.use_plain()", "max_rel_diff": rel(fast, plain),
           "limit": 1e-3, "moved_routes": sum(moved),
           "moved_routes_by_layer": moved, "routed_tokens": 64 * n,
           "first_moved": first, "positions_held": held,
           "max_rel_diff_held": rel(fast[:, :held], plain[:, :held])
           if held else None,
           "limit_held": 2.0 ** -8,
           "decided_by": ("the logits" if first is None else
                          f"the layer check on identical inputs (and "
                          f"positions 0-{held - 1} to 2^-8)")}
    emit(row)
    RECORD["moe"]["logits_check"] = row
    check(n == cfg.n_layers and math.isfinite(row["max_rel_diff"]),
          "one routing a MoE layer on each side, finite logits")
    if first is None:
        check(row["max_rel_diff"] <= 1e-3,
              f"{arch}: prefill logits vs plain path, no route moved")
    else:
        check(not held or row["max_rel_diff_held"] <= 2.0 ** -8,
              f"{arch}: prefill logits vs plain path before the first "
              "moved route, within a bf16 step")
    moe_layer_check(dev, cfg, params)
    del fast, plain
    RECORD["moe"]["decode"] = where_time_goes(dev, cfg, model, params,
                                              label=f"{arch}: ")["step"]
    return launches


def moe_layer_check(dev, cfg, params, B=2, S=512, key="moe"):
    """8c (and 13c): the first MoE layer's weights on identical random
    inputs (B, S, d_model), through the kernels and under
    ``dispatch.use_plain()``: the routes must be equal (the router and the
    bf16 dispatch and combine products are plain products on both sides),
    kernel 1 launched 3 times (gate, up, down; 3 more for a shared expert)
    on the kernel side and never on the plain side, the
    experts' f32 outputs (the down product, before the combine rounds them
    to bf16) within 8 F 2^-24 of their largest entry, the layer's output
    within 2^-8 of its largest entry, and the aux term equal.  The row
    also gives the share of output entries that differ by more than 2^-20
    of the largest: the bf16 roundings the two sides do not share."""
    from repro_torch.kernels import dispatch, tcec_matmul as tm
    from repro_torch.models import layers
    from repro_torch.models.modules import layer
    p = layer(params["moe_blocks"], 0)["moe"]
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(B, S, cfg.d_model, generator=g, device=dev)
    down = "gecf,efd->gecd"
    with recorded(layers, "moe_route") as routes, recorded(
            layers, "pdot", lambda spec, *a: spec == down) as ye, \
            torch.no_grad():
        n0 = tm.launches
        y, aux = layers.moe(p, x, cfg)
        n1 = tm.launches
        with dispatch.use_plain():
            py, paux = layers.moe(p, x, cfg)
        n2 = tm.launches
    same = all(torch.equal(routes[0][k], routes[1][k])
               for k in ("topi", "pos", "keep"))
    diff, top = (y - py).abs(), float(py.abs().max())
    ye_rel = float((ye[0] - ye[1]).abs().max() / ye[1].abs().max())
    ye_limit = 8 * cfg.moe_d_ff * U24
    row = {"moe_layer_check": f"{cfg.name} layer 0 at {B} x {S}, identical "
           "inputs, kernels vs dispatch.use_plain()", "routes_equal": same,
           "kept_share": float(routes[0]["keep"].float().mean()),
           "capacity": routes[0]["C"],
           "expert_out_max_rel_diff": ye_rel, "expert_out_limit": ye_limit,
           "max_rel_diff": float(diff.max()) / top, "limit": 2.0 ** -8,
           "share_above_2^-20": float((diff > 2.0 ** -20 * top).float()
                                      .mean()),
           "aux": float(aux), "plain_aux": float(paux),
           "kernel_launches": n1 - n0, "plain_launches": n2 - n1}
    emit(row)
    RECORD[key]["layer_check"] = row
    check(same, "equal routes, positions and keep masks on both sides")
    expected = 6 if cfg.n_shared_experts else 3
    check((n1 - n0, n2 - n1) == (expected, 0), f"kernel 1: {expected} "
          "launches on the kernel side, none on the plain side")
    check(ye_rel <= ye_limit, "experts' f32 outputs vs plain within "
          "8 F 2^-24 of their largest entry")
    check(bool(torch.isfinite(y).all()) and row["max_rel_diff"] <= 2.0 ** -8,
          "MoE layer output vs plain within 2^-8 of its largest entry")
    check(float(aux) == float(paux), "aux term equal")


# ------------------------------------------------------------ phase 9

@contextlib.contextmanager
def synced_times(owner, name):
    """Inside the scope each call of ``owner.name`` (looked up at each call)
    ends in a synchronize, and its wall milliseconds are appended to the
    list the scope yields."""
    times, fn = [], getattr(owner, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(owner, name, timed)
    try:
        yield times
    finally:
        setattr(owner, name, fn)


def ssm_counts(cfg, S=None):
    """Launches counted from the code, of one decode step (``S`` None) or
    of one forward of S tokens: kernel 1 runs 6 products a Mamba layer (z,
    x, B, C, dt and the output projection; a forward adds 4 chunk products
    a chunk), 9 an application of zamba2's shared block (w_cat, q, k, v, o,
    the MLP's three, w_out) and the unembed; kernel 2 once an application
    in a forward.  The dense-cache decode attends in plain bf16, so kernels
    2 and 3 are not launched at decode."""
    from repro_torch.models.hybrid_lm import group_sizes
    apps = group_sizes(cfg)[1] if cfg.family == "hybrid" else 0
    per_layer = 6 if S is None else 6 + 4 * (S // min(cfg.ssm_chunk, S))
    return {"tcec_matmul": per_layer * cfg.n_layers + 9 * apps + 1,
            "tcec_attention": 0 if S is None else apps,
            "tcec_paged_attention": 0}


def kernel_counts():
    """Every kernel's launch count, once the queued work has run."""
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    torch.cuda.synchronize()
    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in (tm, ta, tp)}


def ssm_path(dev):
    """Phase 9: mamba2-130m and zamba2-1.2b at full width and depth, random
    weights from seed 0; each model's weights are freed before the next.
    Returns (a)'s launches of both."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.hybrid_lm import group_sizes
    from repro_torch.models.modules import param_count
    RECORD.setdefault("profile", [])
    RECORD["ssm"] = {}
    total = dict.fromkeys(PORT_KERNELS, 0)
    # the recurrence of zamba2 attends over a bf16 cache in bf16 products
    # (JAX's dense decode), so its chunked-vs-recurrent gap is a bf16 step
    for arch, recur_limit in (("mamba2-130m", 1e-3),
                              ("zamba2-1.2b", 2.0 ** -8)):
        cfg = get_config(arch)
        model = get_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev)
        torch.cuda.synchronize()
        rec = RECORD["ssm"][arch] = {
            "params": param_count(params),
            "init_s": time.perf_counter() - t0}
        # the least a decode step could take: every weight it uses read
        # once (zamba2's shared block once an application; the tied
        # unembedding reads the table)
        apps = group_sizes(cfg)[1] if cfg.family == "hybrid" else 0
        weights = 4 * (param_count(params["blocks"]) + params["embed"].numel()
                       + apps * param_count(params.get("shared", {})))
        launches, step_ms = dense_run(dev, cfg, model, params, rec,
                                      ssm_counts(cfg), weights)       # 9a
        for k in total:
            total[k] += launches[k]
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, 512))).to(dev)
        fwd_ms = forward_vs_plain(dev, cfg, model, params, rec,
                                  {"tokens": toks}, "2 x 512",
                                  ssm_counts(cfg, 512))               # 9b
        chunked_vs_recurrent(dev, cfg, model, params, rec,
                             recur_limit)                             # 9c
        ssm_profile(dev, cfg, model, params, rec, step_ms, fwd_ms)    # 9d
        del params
        torch.cuda.empty_cache()
    return total


def dense_run(dev, cfg, model, params, rec, per_step, weight_bytes, B=4,
              P=64, gen=16, prefill=None):
    """9a (and 10c, 13f): ``generate_dense``, B greedy prompts of P tokens,
    ``gen`` generated; the launch counts are zeroed before the run and read
    after, and must be ``per_step`` a decode step (the prompt fed through
    ``decode_step`` a token at a time), or ``prefill`` for the prompt's one
    forward and ``per_step`` a generated token where the model has a
    prefill.  Then the same run again with every decode step timed to its
    synchronize.  The step's byte bound is ``weight_bytes`` (what a step
    reads of the weights) with the cache read and written once.  Returns
    the launches and the generated steps' median; the tokens go to
    ``rec["tokens"]``."""
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    from repro_torch.launch import serve
    from repro_torch.models.modules import tree_leaves
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, P))
    for m in (tm, ta, tp):
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve.generate_dense(cfg, params, prompts, gen, device=dev)
    dt = time.perf_counter() - t0
    launches = kernel_counts()
    with synced_times(model.module, "decode_step") as steps:
        again = serve.generate_dense(cfg, params, prompts, gen, device=dev)
    fed = P if model.prefill is None else 0   # prompt tokens fed one a step
    gen_ms = steps[fed:]               # the steps after each drawn token
    cache = model.init_cache(B, P + gen + 1, device=dev)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cache))
    del cache
    step_bytes = weight_bytes + 2 * cache_bytes
    row = {"generate_dense": f"{cfg.name} full width, random weights (seed "
           f"0): {B} greedy prompts of {P} tokens, {gen} generated",
           "params": rec["params"], "init_s": rec["init_s"], "seconds": dt,
           "tokens_per_s": B * gen / dt,
           "tokens_per_s_with_prompt": B * (P + gen) / dt,
           "decode_step_ms": float(np.median(gen_ms)),
           "p10_ms": float(np.percentile(gen_ms, 10)),
           "p90_ms": float(np.percentile(gen_ms, 90)),
           "min_ms": min(gen_ms), "max_ms": max(gen_ms),
           "prompt_step_ms": float(np.median(steps[:P])) if fed else None,
           "step_bytes": step_bytes,
           "step_bound_ms": step_bytes / H100_BYTES_PER_S * 1e3,
           "launches": launches, "launches_per_step": per_step}
    emit(row)
    rec["generate_dense"] = row
    rec["tokens"] = out.tolist()
    check(len(steps) == fed + gen, "one decode step a drawn token and, "
          "without a prefill, a prompt token")
    check(out.shape == (B, gen) and out.min() >= 0
          and out.max() < cfg.vocab_size,
          f"every request yields {gen} tokens of the vocabulary")
    check(np.array_equal(out, again), "two greedy runs, the same tokens")
    check(launches == {k: (fed + gen) * n + (prefill or {}).get(k, 0)
                       for k, n in per_step.items()},
          f"{cfg.name}: launches of {fed + gen} decode steps (and the "
          "prefill) as counted")
    return launches, row["decode_step_ms"]


def forward_vs_plain(dev, cfg, model, params, rec, batch, what, counts):
    """9b (and 10b, 10c): ``forward_logits`` of ``batch`` (``what`` names
    its shape) through the kernels against ``dispatch.use_plain()``; the
    kernel side must launch ``counts``, the plain side nothing.  Returns
    the kernel side's median ms of 3."""
    from repro_torch.kernels import dispatch
    with torch.no_grad():
        c0 = kernel_counts()
        fast = model.forward_logits(params, batch)
        c1 = kernel_counts()
        with dispatch.use_plain():
            plain = model.forward_logits(params, batch)
        c2 = kernel_counts()
        rel = float((fast - plain).abs().max() / plain.abs().max())
        del fast, plain
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.forward_logits(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    kernel_launches = {k: c1[k] - c0[k] for k in c0}
    plain_launches = {k: c2[k] - c1[k] for k in c0}
    row = {"logits_check": f"{cfg.name}: forward_logits {what}, kernels "
           "vs dispatch.use_plain()", "max_rel_diff": rel, "limit": 1e-3,
           "forward_ms": walls, "kernel_launches": kernel_launches,
           "launches_counted": counts, "plain_launches": plain_launches}
    emit(row)
    rec["logits_check"] = row
    check(kernel_launches == counts,
          f"{cfg.name}: forward launches as counted")
    check(not any(plain_launches.values()), "plain side: no kernel launch")
    check(math.isfinite(rel) and rel <= 1e-3, f"{cfg.name}: forward logits "
          "vs plain path")
    return float(np.median(walls))


def chunked_vs_recurrent(dev, cfg, model, params, rec, limit, S=512):
    """9c: the last position's logits of one S-token ``forward_logits``
    (the chunked SSD path) against ``decode_step`` fed the same tokens one
    at a time (the recurrence; JAX's ``ssd_reference`` oracle)."""
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(dev)
    with torch.no_grad():
        chunked = model.forward_logits(params, toks)[:, -1]
        cache = model.init_cache(1, S, device=dev)
        t0 = time.perf_counter()
        for i in range(S):
            step, cache = model.decode_step(params, cache, toks[:, i], i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    rel = float((chunked - step).abs().max() / step.abs().max())
    row = {"chunked_vs_recurrent": f"{cfg.name}: one {S}-token prompt, "
           "last position's logits, forward_logits vs decode_step token by "
           "token", "max_rel_diff": rel, "limit": limit, "recurrence_s": dt}
    emit(row)
    rec["chunked_vs_recurrent"] = row
    check(math.isfinite(rel) and rel <= limit,
          f"{cfg.name}: chunked path vs recurrence")


def ssm_profile(dev, cfg, model, params, rec, step_ms, fwd_ms):
    """9d: one decode step at 4 slots (cache of 81 positions, as in 9a)
    and one 2 x 512 ``forward_logits`` under ``torch.profiler``; each idle
    share against the unprofiled time (9a's median step, 9b's median
    forward)."""
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4,))).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).to(dev)
    cache = model.init_cache(4, 81, device=dev)
    family_profile(cfg, model, params, rec, cache, tok, {"tokens": toks},
                   "2 x 512", step_ms, fwd_ms)


def family_profile(cfg, model, params, rec, cache, tok, batch, what, step_ms,
                   fwd_ms):
    """9d and 10d: one decode step (``tok`` at position 1 of ``cache``,
    after a warm-up step at 0) and one ``forward_logits`` of ``batch``
    (``what``) under ``torch.profiler``; each idle share against the
    unprofiled time (``step_ms``, ``fwd_ms``)."""
    rows = {}
    with torch.no_grad():
        model.decode_step(params, cache, tok, 0)          # warm
        rows["decode"] = profile_window(
            f"{cfg.name}: decode step, 4 slots, dense cache",
            lambda: model.decode_step(params, cache, tok, 1), top=10)
        rows["forward"] = profile_window(
            f"{cfg.name}: forward_logits {what}",
            lambda: model.forward_logits(params, batch), top=10)
    for key, wall in (("decode", step_ms), ("forward", fwd_ms)):
        busy = rows[key]["device_busy_ms"]
        row = {"window": f"{cfg.name}: {key}, shares of the unprofiled "
               f"time ({wall:.3f} ms)", "device_busy_ms": busy,
               "idle_share_of_unprofiled": 1 - busy / wall,
               **{f"{k}_share_of_busy": v["ms"] / busy
                  for k, v in rows[key]["port_kernels"].items()
                  if v["count"]}}
        emit(row)
        RECORD["profile"].append(row)
        rec[f"{key}_profile"] = rows[key] | {"shares": row}


# ------------------------------------------------------------ phase 10

def family_counts(cfg, what):
    """Launches counted from the code (kernels 1, 2, 3) of ``what``:
    ``"step"`` (one dense-cache decode step), ``"forward"``
    (``forward_logits``) or ``"prefill_cross"``.  Kernel 1 runs 7 products
    an encoder or VLM layer (q, k, v, o, the MLP's three), 11 a seamless
    decoder layer in a forward (self q, k, v, o; cross q, o and the
    memory's k and v) and 9 at decode (the memory's K/V come from the cross
    cache), the frontend projection (seamless) or the projector's two
    products (internvl2), and the unembed.  Kernel 2 runs once a
    self-attention of a forward and once a cross-attention, also at decode
    (one query row); the dense cache's self-attention is plain bf16."""
    L = cfg.n_layers
    if cfg.family == "vlm":
        k1, k2 = {"step": (7 * L + 1, 0), "forward": (2 + 7 * L + 1, L)}[what]
    else:
        Le = cfg.n_enc_layers
        k1, k2 = {"step": (9 * L + 1, L),
                  "forward": (1 + 7 * Le + 11 * L + 1, Le + 2 * L),
                  "prefill_cross": (1 + 7 * Le + 2 * L, Le)}[what]
    return {"tcec_matmul": k1, "tcec_attention": k2,
            "tcec_paged_attention": 0}


def encdec_vlm_path(dev):
    """Phase 10: seamless-m4t-large-v2 and internvl2-2b at full width and
    depth, random weights from seed 0; each model's weights are freed
    before the next.  Returns the launches of 10a and 10c's served runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.modules import param_count
    RECORD.setdefault("profile", [])
    RECORD["encdec_vlm"] = {}
    total = dict.fromkeys(PORT_KERNELS, 0)
    for arch, phase in (("seamless-m4t-large-v2", encdec_phase),
                        ("internvl2-2b", vlm_phase)):
        cfg = get_config(arch)
        model = get_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev)
        torch.cuda.synchronize()
        rec = RECORD["encdec_vlm"][arch] = {
            "params": param_count(params),
            "init_s": time.perf_counter() - t0}
        launches = phase(dev, cfg, model, params, rec)
        for k in total:
            total[k] += launches[k]
        del params
        torch.cuda.empty_cache()
    return total


def encdec_phase(dev, cfg, model, params, rec, B=4, P=64, gen=16, T=512):
    """10a: seamless served: ``init_cache(B, P + gen + 1, mem_len=T)``,
    ``prefill_cross`` on B x T frames, then ``generate_dense``'s loop (the
    P-token prompt fed one ``decode_step`` at a time, ``gen`` greedy
    tokens); launches zeroed before and read after, as counted; the run
    again with every decode step timed to its synchronize, the same
    tokens.  10b: ``forward_logits`` at 2 x 512 frames + 2 x 512 tokens
    against ``use_plain()``, and one ``decode_step`` after
    ``prefill_cross``, kernels against plain on copies of one cache state.
    10d: the profiles.  Returns 10a's launches."""
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    from repro_torch.models.modules import param_count, tree_leaves
    mod = model.module
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.frontend_dim)).astype(np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).to(dev)

    def served():
        cache = model.init_cache(B, P + gen + 1, mem_len=T, device=dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            mod.prefill_cross(params, frames, cfg, cache)
            torch.cuda.synchronize()
            cross_ms = (time.perf_counter() - t0) * 1e3
            for i in range(P):
                logits, cache = model.decode_step(params, cache,
                                                  prompts[:, i], i)
            out = []
            for i in range(gen):
                tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
                out.append(tok)
                logits, cache = model.decode_step(params, cache, tok, P + i)
        return torch.stack(out, 1).cpu().numpy(), cross_ms

    for m in (tm, ta, tp):
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, cross_ms = served()
    dt = time.perf_counter() - t0
    launches = kernel_counts()
    with synced_times(mod, "decode_step") as steps:
        again, cross_ms2 = served()
    gen_ms = steps[P:]
    pc, st = family_counts(cfg, "prefill_cross"), family_counts(cfg, "step")
    counted = {k: pc[k] + (P + gen) * st[k] for k in pc}
    # the least a decode step could take: the decoder's weights that a step
    # reads (not the memory's K/V projections), the unembedding and B rows
    # of the table once; the self cache read and one position of it
    # written, the cross cache read
    xattn = params["dec_blocks"]["xattn"]
    weights = 4 * (param_count(params["dec_blocks"]) - xattn["wk"].numel()
                   - xattn["wv"].numel() + params["unembed"].numel()
                   + B * cfg.d_model)
    cache = model.init_cache(B, P + gen + 1, mem_len=T, device=dev)
    self_b, cross_b = (sum(t.numel() * t.element_size()
                           for t in tree_leaves(cache[k]))
                       for k in ("self", "cross"))
    step_bytes = weights + self_b + self_b // (P + gen + 1) + cross_b
    row = {"served": f"{cfg.name} full width, random weights (seed 0): "
           f"prefill_cross on {B} x {T} frames, {B} greedy prompts of {P} "
           f"tokens fed one decode_step at a time, {gen} generated",
           "params": rec["params"], "init_s": rec["init_s"], "seconds": dt,
           "tokens_per_s": B * gen / dt,
           "decode_step_ms": float(np.median(gen_ms)),
           "p10_ms": float(np.percentile(gen_ms, 10)),
           "p90_ms": float(np.percentile(gen_ms, 90)),
           "min_ms": min(gen_ms), "max_ms": max(gen_ms),
           "prompt_step_ms": float(np.median(steps[:P])),
           "prefill_cross_ms": [cross_ms, cross_ms2],
           "step_bytes": step_bytes,
           "step_bound_ms": step_bytes / H100_BYTES_PER_S * 1e3,
           "launches": launches, "launches_counted": counted}
    emit(row)
    rec["served"] = row
    check(len(steps) == P + gen, "one decode step a prompt and drawn token")
    check(out.shape == (B, gen) and out.min() >= 0
          and out.max() < cfg.vocab_size,
          f"every request yields {gen} tokens of the vocabulary")
    check(np.array_equal(out, again), "two greedy runs, the same tokens")
    check(launches == counted, f"{cfg.name}: launches of prefill_cross and "
          f"{P + gen} decode steps as counted")

    # 10b: the forward, then one decode step on copies of one cache state
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 512))).to(dev),
        "frames": torch.from_numpy(rng.standard_normal(
            (2, 512, cfg.frontend_dim)).astype(np.float32)).to(dev)}
    fwd_ms = forward_vs_plain(dev, cfg, model, params, rec, batch,
                              "2 x 512 frames + 2 x 512 tokens",
                              family_counts(cfg, "forward"))
    with torch.no_grad():
        mod.prefill_cross(params, frames, cfg, cache)
    rows = decode_vs_plain(cfg, model, params, cache, prompts[:, 0], st)
    rec["decode_check"] = rows
    family_profile(cfg, model, params, rec, cache, prompts[:, 1], batch,
                   "2 x 512 frames + 2 x 512 tokens",
                   rec["served"]["decode_step_ms"], fwd_ms)     # 10d
    return launches


@contextlib.contextmanager
def f32_self_attention():
    """Inside the scope the dense cache's self-attention products, which
    run the ``bf16`` policy (JAX's dense decode), run ``fp32``; the models'
    other products are untouched."""
    from repro_torch.models import layers
    fn = layers.pdot

    def pdot(spec, a, b, policy):
        return fn(spec, a, b, "fp32" if policy == "bf16" else policy)

    layers.pdot = pdot
    try:
        yield
    finally:
        layers.pdot = fn


def decode_vs_plain(cfg, model, params, cache, tok, counted):
    """10b: one seamless ``decode_step`` at position 0 of ``cache`` (after
    ``prefill_cross``), through the kernels and under
    ``dispatch.use_plain()``, each on its own copy of the cache.  (i) As
    JAX computes it: the step writes its K/V into the bf16 self cache and
    attends over it in bf16 products, so a value the two f32-accurate sides
    round to different bf16 neighbours moves the logits by up to a bf16
    step: held to 2^-8.  (ii) The same step with the self cache in f32 and
    its attention products in f32 on both sides (the cross cache keeps its
    bf16 values), so that only the kernels and their plain versions
    differ: held to 1e-3.  The kernel side launches ``counted`` each time,
    the plain side nothing."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.modules import tree_map
    rows = []
    for label, limit, dtype, scope in (
            ("bf16 self cache and attention (JAX's)", 2.0 ** -8, None,
             contextlib.nullcontext),
            ("f32 self cache and attention on both sides", 1e-3,
             torch.float32, f32_self_attention)):
        copies = [tree_map(lambda t: t.to(dtype or t.dtype, copy=True),
                           cache) for _ in range(2)]
        with torch.no_grad(), scope():
            c0 = kernel_counts()
            fast, _ = model.decode_step(params, copies[0], tok, 0)
            c1 = kernel_counts()
            with dispatch.use_plain():
                plain, _ = model.decode_step(params, copies[1], tok, 0)
            c2 = kernel_counts()
        rel = float((fast - plain).abs().max() / plain.abs().max())
        row = {"logits_check": f"{cfg.name}: one decode_step after "
               f"prefill_cross, kernels vs dispatch.use_plain() on copies "
               f"of one cache state; {label}",
               "max_rel_diff": rel, "limit": limit,
               "kernel_launches": {k: c1[k] - c0[k] for k in c0},
               "plain_launches": {k: c2[k] - c1[k] for k in c0}}
        emit(row)
        rows.append(row)
        del copies, fast, plain
        check(row["kernel_launches"] == counted,
              "decode step launches as counted")
        check(not any(row["plain_launches"].values()),
              "plain side: no kernel launch")
        check(math.isfinite(rel) and rel <= limit,
              f"{cfg.name}: decode logits vs plain path, {label}")
    return rows


def vlm_phase(dev, cfg, model, params, rec):
    """10c: internvl2 through ``generate_dense`` (phase 9a's run: 4 greedy
    prompts of 64 text tokens, 16 generated) and ``forward_logits`` on 2 x
    (256 patches + 256 tokens) against ``use_plain()``; 10d: the profiles.
    Returns the served run's launches."""
    from repro_torch.models.modules import param_count
    weights = 4 * (param_count(params["dense_blocks"])
                   + params["unembed"].numel() + 4 * cfg.d_model)
    launches, step_ms = dense_run(dev, cfg, model, params, rec,
                                  family_counts(cfg, "step"), weights)
    rng = np.random.default_rng(1)
    P = cfg.n_frontend_tokens
    batch = {"patches": torch.from_numpy(rng.standard_normal(
        (2, P, cfg.frontend_dim)).astype(np.float32)).to(dev),
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 256))).to(dev)}
    what = f"2 x ({P} patches + 256 tokens)"
    fwd_ms = forward_vs_plain(dev, cfg, model, params, rec, batch, what,
                              family_counts(cfg, "forward"))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4,))).to(dev)
    family_profile(cfg, model, params, rec, model.init_cache(
        4, 81, device=dev), tok, batch, what, step_ms, fwd_ms)   # 10d
    return launches


# ------------------------------------------------------------ phase 11

# Fig. 11's operand bands and Types (benchmarks/fig11_exponent_range.py)
FIG11_BANDS = {"hi": (-15, 14), "lo": (-35, -15), "out": (-100, -35)}
FIG11_TYPES = {"Type1": ("hi", "hi"), "Type2": ("hi", "out"),
               "Type3": ("lo", "lo"), "Type4": ("out", "out")}
# kernel 1 (x3, x6, x10), the plain products and the fp16 term expansion;
# the fp8 policies' band excludes the Types
FIG11_POLICIES = ("tcec_bf16x3", "tcec_bf16x6", "tcec_bf16x10", "fp32",
                  "bf16", "fp16_halfhalf", "fp16_markidis")
X9 = "tcec_bf16x9"


def operand_band(pol):
    """A policy's band in the conformance battery
    (``tests/test_policy_conformance.py::operand_band``): its safe exponent
    range where that is not empty, else its format's representable range,
    clamped to [-40, 14]."""
    from repro_torch.core import theory
    if pol.is_plain():
        if pol.name == "fp32":
            return (-30, 14)
        lo, hi = theory.representable_range(
            theory.FORMATS_BY_DTYPE[pol.dtype])
    else:
        fmt = theory.FORMATS_BY_DTYPE[pol.dtype]
        lo, hi = theory.safe_exponent_range(fmt, pol.scale_bits)
        if lo > hi:
            lo, hi = theory.representable_range(fmt)
    return max(lo, -40), min(hi, 14)


def safe_range(pol):
    """``theory.safe_exponent_range`` of a split policy (the representable
    range of plain bf16; none for f32)."""
    from repro_torch.core import theory
    if pol.name == "fp32":
        return None
    fmt = theory.FORMATS_BY_DTYPE[pol.dtype]
    if pol.is_plain():
        return list(theory.representable_range(fmt))
    return list(theory.safe_exponent_range(fmt, pol.scale_bits))


def exp_rand_mats(specs):
    """``matgen.exp_rand((n, n), lo, hi, seed)`` for each ``(n, lo, hi,
    seed)``, made on the host in threads (numpy's generators and ufuncs
    release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.matgen import exp_rand
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        return list(ex.map(lambda sp: exp_rand((sp[0], sp[0]), sp[1], sp[2],
                                               seed=sp[3]), specs))


def fig11_battery(dev, n=4096, n9=1024):
    """Phase 11a: the paper's Fig. 11 on the card, every number against
    ``core/theory.py``.  Returns kernel 1's launches."""
    from repro_torch.core import get_policy, policy_mm, theory
    from repro_torch.core.matgen import urand
    from repro_torch.core.policy import tcec_dot_unevaluated
    from repro_torch.kernels import tcec_attention as ta, tcec_matmul as tm
    t_start = time.perf_counter()
    types = list(FIG11_TYPES.items())
    bands = sorted({operand_band(get_policy(p)) for p in FIG11_POLICIES})
    x9_band = operand_band(get_policy(X9))
    specs = []
    for ti, (_, (ka, kb)) in enumerate(types):      # the bench's seeds
        specs += [(n, *FIG11_BANDS[ka], 2 * ti),
                  (n, *FIG11_BANDS[kb], 2 * ti + 1)]
    for bi, band in enumerate(bands):
        specs += [(n, *band, 400 + 2 * bi), (n, *band, 401 + 2 * bi)]
    for ti, (_, (ka, kb)) in enumerate(types):      # the x9 test's seeds
        specs += [(n9, *FIG11_BANDS[ka], 100 + 2 * ti),
                  (n9, *FIG11_BANDS[kb], 101 + 2 * ti)]
    specs += [(n9, *x9_band, 500), (n9, *x9_band, 501)]
    mats = iter(exp_rand_mats(specs))
    gen_s = time.perf_counter() - t_start
    tm.launches = ta.launches = 0
    rows, res = [], {}

    def pair():
        return (torch.from_numpy(next(mats)).to(dev),
                torch.from_numpy(next(mats)).to(dev))

    def measure(kind, names, a, b, e_lo, band):
        ref = a.double() @ b.double()
        r32 = res[(kind, "sgemm", a.shape[0])] = residual(ref, a @ b)
        for name in names:
            pol = get_policy(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = policy_mm(a, b, name)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            r = residual(ref, c)
            bound_ = theory.policy_error_bound(pol, a.shape[1], e_lo=e_lo)
            row = {"fig11": kind, "policy": name, "n": a.shape[0],
                   "operand_bands": band, "residual": r,
                   "sgemm_residual": r32, "ratio_to_sgemm": r / r32,
                   "bound": bound_, "within_bound": r <= bound_,
                   "safe_exponent_range": safe_range(pol),
                   "route": ("kernel 1" if name.startswith("tcec_bf16x")
                             and name != X9 else "TwoSum loop" if name == X9
                             else "term expansion" if name.startswith("fp16")
                             else "one f32 product"),
                   "ms": ms}
            emit(row)
            rows.append(row)
            res[(kind, name, a.shape[0])] = r
            del c
        del ref

    for tname, (ka, kb) in types:
        a, b = pair()
        band = [FIG11_BANDS[ka], FIG11_BANDS[kb]]
        measure(tname, FIG11_POLICIES, a, b, min(band[0][0], band[1][0]),
                band)
    for band in bands:
        a, b = pair()
        names = [p for p in FIG11_POLICIES
                 if operand_band(get_policy(p)) == band]
        measure("SafeBand", names, a, b, band[0], [band, band])
    for tname, (ka, kb) in types:
        a, b = pair()
        band = [FIG11_BANDS[ka], FIG11_BANDS[kb]]
        measure(tname, ("tcec_bf16x6", X9), a, b,
                min(band[0][0], band[1][0]), band)
    a, b = pair()
    measure("SafeBand", (X9,), a, b, x9_band[0], [x9_band, x9_band])
    a = torch.from_numpy(urand((n9, n9), seed=31)).to(dev)
    b = torch.from_numpy(urand((n9, n9), seed=32)).to(dev)
    head, tail = tcec_dot_unevaluated(a, b, X9)
    ref = a.double() @ b.double()
    pair_rel = residual(ref, head.double() + tail.double())
    torch.cuda.synchronize()
    launches = tm.launches
    del a, b, head, tail, ref
    torch.cuda.empty_cache()
    summary = {
        "fig11_summary": f"Fig. 11 Types 1-4 at {n}^3 (x9 and its x6 "
        f"beside it at {n9}^3), every policy on its safe band",
        "x9_unevaluated_pair_residual": pair_rel,
        "x9_unevaluated_pair_limit": 1e-13,
        "kernel1_launches": launches, "kernel2_launches": ta.launches,
        "host_generation_s": gen_s,
        "phase_s": time.perf_counter() - t_start}
    emit(summary)
    RECORD["fig11"] = {"rows": rows, **summary}
    for row in rows:
        if row["fig11"] == "SafeBand":
            check(row["within_bound"], f"{row['policy']} within "
                  "theory.policy_error_bound on its safe band")
    for t in ("Type1", "Type3"):
        check(res[(t, "tcec_bf16x6", n)] <= 2 * res[(t, "sgemm", n)],
              f"x6 residual <= 2x f32 SGEMM's on {t}")
    for t in FIG11_TYPES:
        check(res[(t, X9, n9)] < 0.5 * res[(t, "tcec_bf16x6", n9)],
              f"x9 residual < 0.5 x6's on {t}")
    check(pair_rel < 1e-13, "x9 head + tail within 1e-13 of f64")
    check(res[("Type3", "fp16_halfhalf", n)]
          > res[("Type3", "tcec_bf16x6", n)],
          "fp16_halfhalf worse than x6 on Type 3")
    # kernel 1 takes x3, x6 and x10 on each Type and on their band, and x6
    # beside x9 on each Type; no kernel 2
    check(launches == 3 * len(types) + 3 + len(types) and not ta.launches,
          "phase 11a: kernel 1 once for each x3, x6 and x10 product")
    return {"tcec_matmul": launches, "tcec_attention": 0,
            "tcec_paged_attention": 0}


def long_sequence(dev, L_check=8192, S_train=16384):
    """Phase 11b: blocked attention, the composition's long-sequence path,
    on the card.  Returns the launches of the 1 x ``S_train`` step."""
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import (dispatch, tcec_attention as ta,
                                     tcec_matmul as tm)
    from repro_torch.launch.step import make_train_step
    from repro_torch.models import get_model, layers
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import adamw
    cfg = get_config("qwen3-0.6b")
    H, Hkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    pol = cfg.mix_policy

    def live_pairs(S, chunk=2048):
        n = S // chunk
        return n * (n + 1) // 2

    # (i) one layer's attention at L_check: the blocked recompute backward
    # (its products on kernel 1) against an mha backward on the same q, k,
    # v with every product plain
    g = torch.Generator(device=dev).manual_seed(L_check)
    q = torch.randn(1, L_check, H, hd, generator=g, device=dev)
    k, v = (torch.randn(1, L_check, Hkv, hd, generator=g, device=dev)
            for _ in range(2))
    cot = torch.randn(1, L_check, H, hd, generator=g, device=dev)
    pos = torch.arange(L_check, dtype=torch.int32, device=dev)[None]
    acfg = SimpleNamespace(mix_policy=pol, attn_softcap=None)
    out = {}
    for side in ("blocked", "mha"):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tm.launches = ta.launches = 0
        t0 = time.perf_counter()
        with recorded(layers, "blocked_attention",
                      keep=lambda o: tuple(o.shape)) as calls:
            if side == "blocked":
                layers._FusedSDPA.apply(*qkv, pos, pos, pol, None, True,
                                        0).backward(cot)
            else:
                with dispatch.use_plain():
                    layers.mha(*qkv, acfg, pos, pos, True, 0).backward(cot)
            torch.cuda.synchronize()
        out[side] = {"grads": [t.grad for t in qkv],
                     "s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "blocked_calls": len(calls),
                     "launches": {"tcec_matmul": tm.launches,
                                  "tcec_attention": ta.launches}}
        del qkv
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(
        out["blocked"]["grads"], out["mha"]["grads"])]
    row = {"long_attention": f"qwen3-0.6b attention, 1 x {L_check}, "
           f"{H}/{Hkv} heads of {hd}: _FusedSDPA's blocked recompute "
           "backward (kernels) against an mha backward on the same q, k, v "
           "under dispatch.use_plain()",
           "rel_diff_dq_dk_dv": rel, "limit": 1e-3,
           **{f"{s}_{k}": out[s][k] for s in out
              for k in ("s", "peak_gb", "blocked_calls", "launches")}}
    emit(row)
    RECORD["long_sequence"] = {"layer": row}
    check(out["blocked"]["blocked_calls"] == 1
          and out["mha"]["blocked_calls"] == 0,
          "the recompute backward takes blocked_attention once")
    check(out["blocked"]["launches"] == {
        "tcec_matmul": 6 * live_pairs(L_check), "tcec_attention": 1},
        "blocked: kernel 2 forward, 6 kernel-1 products a live chunk pair")
    check(out["mha"]["launches"] == {"tcec_matmul": 0, "tcec_attention": 0},
          "mha under use_plain(): no kernel launched")
    check(all(r <= 1e-3 for r in rel), "blocked vs mha gradients, 1e-3")
    del out, q, k, v, cot
    torch.cuda.empty_cache()

    # (ii) a full-width train step at 1 x S_train: loss_fn, its backward
    # (remat: each block recomputed, its attention backward blocked) and
    # one AdamW step
    model = get_model(cfg)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=1)
    params = model.init(0, device=dev)
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    batch = device_batch(cfg, DataConfig(seed=0, global_batch=1,
                                         seq_len=S_train), 0, dev)
    step_fn = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tm.launches = ta.launches = 0
    t0 = time.perf_counter()
    with recorded(layers, "blocked_attention",
                  keep=lambda o: tuple(o.shape)) as calls:
        new_state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {"tcec_matmul": tm.launches, "tcec_attention": ta.launches,
                "tcec_paged_attention": 0}
    peak = torch.cuda.max_memory_allocated()
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(new_state["params"]))
    moved = any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(new_state["params"]), tree_leaves(params)))
    per_step = {"tcec_matmul": (28 + 6 * live_pairs(S_train)) * L + 3,
                "tcec_attention": 2 * L, "tcec_paged_attention": 0}
    row = {"long_train_step": f"qwen3-0.6b full width, random weights "
           f"(seed 0), 1 x {S_train}, remat, lr 1e-3: loss_fn + backward "
           "+ one AdamW step", "loss": loss, "grad_norm": gnorm,
           "step_s": step_s, "tokens_per_s": S_train / step_s,
           "peak_memory_gb": peak / 1e9, "blocked_calls": len(calls),
           "launches": launches, "launches_expected": per_step}
    emit(row)
    RECORD["long_sequence"]["train_step"] = row
    check(len(calls) == L and all(c == (1, S_train, H, hd) for c in calls),
          "every layer's backward took blocked_attention")
    check(math.isfinite(loss) and math.isfinite(gnorm) and finite,
          "loss, gradient norm and updated parameters finite")
    check(moved, "the AdamW step moved the parameters")
    check(launches == per_step, "kernel 1: (28 + 6 live pairs) L + 3 and "
          "kernel 2: 2L launches in the step")
    del state, new_state, params, batch, metrics
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 12

LARGE_DENSE = ("gemma-2b", "gemma2-9b", "qwen2.5-14b")


def large_dense(dev):
    """Phase 12: the larger dense models at full width, random weights
    from seed 0, each freed before the next; returns their launches."""
    total = dict.fromkeys(PORT_KERNELS, 0)
    card = torch.cuda.get_device_properties(dev).total_memory
    for arch in LARGE_DENSE:
        key = f"large_{arch}"
        launches, (cfg, model, params), toks = serve_run(dev, arch, key)
        for name in total:
            total[name] += launches[name]
        mem = RECORD[key]["engine"]["memory"]
        plain_peak = logits_vs_plain(model, params, toks, key)
        plain_peak = max(plain_peak, wide_vs_plain(cfg, model, params, key))
        torch.cuda.reset_peak_memory_stats()
        where_time_goes(dev, cfg, model, params, timed=16, steps=2,
                        label=f"{arch}: ")
        # the largest allocation of the arch's phases: the engine run, the
        # replay check, the plain prefills and forwards, the timed engine
        mem["phase_peak_gb"] = max(
            mem["run_peak_gb"], mem["replay_peak_gb"],
            (max(plain_peak, torch.cuda.max_memory_allocated())
             - mem["base_bytes"]) / 1e9)
        mem["card_gb"] = card / 1e9
        row = {"memory": arch, **mem}
        emit(row)
        check(mem["phase_peak_gb"] * 1e9 < card,
              f"{arch}: the run's peak below the card's memory")
        del params, model, cfg
        torch.cuda.empty_cache()
    return total


def wide_vs_plain(cfg, model, params, key, B=2, S=512):
    """Phase 12b: ``forward_logits`` at the engine's widest prefill, B x S
    = 2 x 512, through the kernels (kernel 1 on path W at M 1024, the
    unembedding too) against ``dispatch.use_plain()``, the logits within
    1e-3.  The plain side runs one sequence at a time, to keep its term
    copies of each weight beside qwen2.5-14b's 59 GB: a row of a product
    depends on that row alone, so the logits are the same function.  The
    kernel side launches 7L + 1 / L / 0, the plain side nothing.  The
    kernel side allocates less than its logits (three times over with a
    final softcap: ``x / cap``, its tanh) and one layer's largest weight,
    so a copy of the embedding or unembedding on path W fails the gate.
    Returns the plain side's peak allocation."""
    from repro_torch.kernels import dispatch, tcec_matmul as tm
    dev = params["embed"].device
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    counts = forward_counts(cfg)["prefill"]
    with torch.no_grad():
        c0 = kernel_counts()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fast = model.forward_logits(params, toks)
        c1 = kernel_counts()
        wall = (time.perf_counter() - t0) * 1e3
        extra = torch.cuda.max_memory_allocated() - before
        logits_bytes = fast.nbytes
        fast = fast.cpu()
        torch.cuda.reset_peak_memory_stats()
        diff = scale = 0.0
        t0 = time.perf_counter()
        with dispatch.use_plain():
            for i in range(B):
                plain = model.forward_logits(params, toks[i:i + 1]).cpu()
                diff = max(diff, float((fast[i] - plain[0]).abs().max()))
                scale = max(scale, float(plain.abs().max()))
                del plain
        c2 = kernel_counts()
        plain_wall = (time.perf_counter() - t0) * 1e3
        plain_peak = torch.cuda.max_memory_allocated()
    del fast
    rel = diff / scale
    kernel_launches = {k: c1[k] - c0[k] for k in c0}
    plain_launches = {k: c2[k] - c1[k] for k in c0}
    layer = layer_leaf_bytes(params)
    allowed = (3 if cfg.final_softcap else 1) * logits_bytes + layer
    row = {"logits_check": f"{cfg.name}: forward_logits {B} x {S}, kernels "
           "vs dispatch.use_plain() (one sequence at a time)",
           "kernel1_path": tm.path(B * S), "max_rel_diff": rel,
           "limit": 1e-3, "forward_ms": wall, "plain_forward_ms": plain_wall,
           "kernel_launches": kernel_launches, "launches_counted": counts,
           "plain_launches": plain_launches,
           "kernel_extra_gb": extra / 1e9, "logits_gb": logits_bytes / 1e9,
           "allowed_gb": allowed / 1e9,
           "plain_peak_allocated_gb": plain_peak / 1e9}
    emit(row)
    RECORD[key]["wide_logits_check"] = row
    check(tm.path(B * S) == "wgmma", f"{cfg.name}: M {B * S} on path W")
    check(kernel_launches == counts, f"{cfg.name}: forward launches as "
          "counted")
    check(not any(plain_launches.values()), "plain side: no kernel launch")
    check(math.isfinite(rel) and rel <= 1e-3, f"{cfg.name}: {B} x {S} "
          "logits vs plain path")
    check(extra < allowed, f"{cfg.name}: the kernels' {B} x {S} forward "
          "copies no weight: it allocates less than its logits and one "
          "layer's largest weight")
    return plain_peak


# ------------------------------------------------------------ phase 13

DEEPSEEK = "deepseek-v3-671b"


def deepseek_config():
    """deepseek-v3-671b at full width, depth cut to 4 layers (3 dense MLA
    layers and 1 MoE layer of 256 experts, top 8, a shared expert): 60.44
    GB in f32 (the 61 layers are about 2.7 TB).  The MTP head is off:
    serving never runs it, and it is a second 46 GB MoE layer."""
    from repro_torch.configs import get_config
    return get_config(DEEPSEEK).replace(n_layers=4, mtp=False)


def deepseek_path(dev):
    """Phase 13; returns (b)'s launches."""
    from repro_torch.models.modules import param_count
    key = "deepseek"
    card = torch.cuda.get_device_properties(dev).total_memory
    launches, (cfg, model, params), toks = serve_run(
        dev, DEEPSEEK, key, deepseek_config())                 # (a), (b)
    rec = RECORD[key]
    mem = rec["engine"]["memory"]
    check(mem["init_peak_gb"] <= mem["weights_gb"] + mem["largest_leaf_gb"],
          "13a: init peak <= the weights + the largest leaf")
    plain_peak = routed_logits_vs_plain(                        # (c)
        cfg, lambda t: model.prefill(params, t)[0], toks, "64-token prefill",
        rec)
    toks2 = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 512))).to(dev)
    plain_peak = max(plain_peak, routed_logits_vs_plain(
        cfg, lambda t: model.forward_logits(params, t), toks2,
        "forward_logits 2 x 512", rec, per_sequence=True))
    del toks2
    torch.cuda.reset_peak_memory_stats()
    moe_layer_check(dev, cfg, params, key=key)
    plain_peak = max(plain_peak, torch.cuda.max_memory_allocated())
    weights_read_in_place(cfg, model, params, toks, rec)        # (d)
    torch.cuda.reset_peak_memory_stats()
    rows = where_time_goes(dev, cfg, model, params, timed=16,   # (e)
                           steps=2, label=f"{DEEPSEEK}: ")
    timed_peak = torch.cuda.max_memory_allocated()
    # a decode step streams every weight but the embedding, which it only
    # gathers (B rows of it)
    streamed = tree_bytes(params) - params["embed"].nbytes
    steps, step, prof = 2, rows["step"], rows["decode"]
    k1_ms = prof["port_kernels"]["tcec_matmul"]["ms"] / steps
    busy = prof["device_busy_ms"] / steps
    row = {"deepseek_decode": f"{DEEPSEEK}, 4 layers at full width: decode "
           "step at 4 slots and the 2 x 512 prefill",
           "decode_step_ms": step["decode_step_ms"], "p10_ms": step["p10_ms"],
           "p90_ms": step["p90_ms"], "device_busy_ms_per_step": busy,
           "idle_share_of_median_step":
               rows["graphs"]["idle_share_of_median_step"],
           "kernel1_ms_per_step": k1_ms,
           "kernel1_launches_per_step":
               prof["port_kernels"]["tcec_matmul"]["count"] / steps,
           "kernel1_share_of_busy": k1_ms / busy,
           "streamed_weight_bytes": streamed,
           "step_bound_ms": streamed / H100_BYTES_PER_S * 1e3,
           "kernel1_stream_tb_s": streamed / (k1_ms * 1e-3) / 1e12,
           "step_stream_tb_s": streamed / (step["decode_step_ms"] * 1e-3)
           / 1e12,
           "prefill_wall_ms": rows["prefill"]["wall_ms"],
           "prefill_busy_ms": rows["prefill"]["device_busy_ms"]}
    emit(row)
    rec["decode"] = row
    rec["params"] = param_count(params)
    rec["init_s"] = rec["engine"]["init_s"]
    counts = forward_counts(cfg)
    engine_tokens_vs_dense(dev, cfg, model, params, rec, counts,     # (f)
                           streamed + 4 * cfg.d_model * 4)
    mem["plain_peak_gb"] = (plain_peak - mem["base_bytes"]) / 1e9
    mem["phase_peak_gb"] = max(
        mem["run_peak_gb"], mem["replay_peak_gb"], mem["plain_peak_gb"],
        (timed_peak - mem["base_bytes"]) / 1e9)
    mem["card_gb"] = card / 1e9
    emit({"memory": DEEPSEEK, **mem})
    check(mem["phase_peak_gb"] * 1e9 < card, f"{DEEPSEEK}: every peak "
          "below the card's memory")
    del params, model
    torch.cuda.empty_cache()
    mtp_on_the_card(dev, rec)                                   # (g)
    return launches


def routed_logits_vs_plain(cfg, forward, toks, what, rec, per_sequence=False):
    """13c: ``forward(toks)``'s logits (toks (B, S)) through the kernels
    against ``dispatch.use_plain()``, with phase 8's rule for moved routes:
    each MoE layer's routes are recorded on both sides; a moved route
    changes its token and, through attention, every later position of its
    sequence, so each sequence is held to 1e-3 at the positions before its
    first moved route, and the count of moved routes is reported.
    ``per_sequence``: the plain side runs one sequence at a time, to keep
    its term copies of each weight beside the 60 GB of weights; each
    sequence is one routing group on both sides, so the routes are the
    same function.  The kernel side launches as ``forward_counts`` counts
    a prefill, the plain side nothing.  Returns the plain side's peak."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers
    B, S = toks.shape
    if per_sequence:
        check(layers.group_size(B * S, cfg) == S, "one routing group a "
              "sequence")
    with recorded(layers, "moe_route", keep=lambda r: r["topi"]) as routes, \
            torch.no_grad():
        c0 = kernel_counts()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fast = forward(toks)
        c1 = kernel_counts()
        wall = (time.perf_counter() - t0) * 1e3
        extra = torch.cuda.max_memory_allocated() - before
        fast = fast.cpu()
        n = len(routes)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with dispatch.use_plain():
            plain = torch.cat([forward(t).cpu() for t in (
                toks.split(1) if per_sequence else [toks])])
        c2 = kernel_counts()
        plain_wall = (time.perf_counter() - t0) * 1e3
        plain_peak = torch.cuda.max_memory_allocated()
    # each side's routes of each MoE layer, tokens in (B, S) order
    calls = len(routes) - n
    plain_routes = [torch.cat(routes[n + l::n]) for l in range(n)] \
        if per_sequence else routes[n:]
    moved, held = 0, [S] * B
    for a, b in zip(routes[:n], plain_routes):
        differ = (a.sort(-1).values != b.sort(-1).values).any(-1).reshape(-1)
        moved += int(differ.sum())
        for t in differ.nonzero()[:, 0].tolist():
            held[t // S] = min(held[t // S], t % S)
    diff = max((float((fast[i, :h] - plain[i, :h]).abs().max())
                for i, h in enumerate(held) if h), default=0.0)
    scale = max((float(plain[i, :h].abs().max())
                 for i, h in enumerate(held) if h), default=1.0)
    counts = forward_counts(cfg)["prefill"]
    row = {"logits_check": f"{cfg.name}: {what}, kernels vs "
           "dispatch.use_plain()"
           + (" (one sequence at a time)" if per_sequence else ""),
           "moved_routes": moved, "routed_tokens": B * S * n,
           "positions_held": held,
           "max_rel_diff_held": diff / scale, "limit": 1e-3,
           "max_rel_diff_all": float((fast - plain).abs().max()
                                     / plain.abs().max()),
           "forward_ms": wall, "plain_forward_ms": plain_wall,
           "kernel_launches": {k: c1[k] - c0[k] for k in c0},
           "launches_counted": counts,
           "plain_launches": {k: c2[k] - c1[k] for k in c0},
           "kernel_extra_gb": extra / 1e9,
           "plain_peak_allocated_gb": plain_peak / 1e9}
    emit(row)
    rec.setdefault("logits_checks", []).append(row)
    from repro_torch.models.lm import stacks
    check(n == sum(k for _, k, moe in stacks(cfg) if moe)
          and calls == n * (B if per_sequence else 1),
          "one routing a MoE layer (and sequence) on each side")
    check(row["kernel_launches"] == counts, f"{what}: launches as counted")
    check(not any(row["plain_launches"].values()),
          "plain side: no kernel launch")
    check(math.isfinite(row["max_rel_diff_held"])
          and row["max_rel_diff_held"] <= 1e-3,
          f"{what}: logits vs plain before the first moved route")
    return plain_peak


def weights_read_in_place(cfg, model, params, toks, rec):
    """13d: during one decode step (4 slots) and one 4-token prefill
    through the kernels, every kernel-1 launch reads its B from inside a
    parameter leaf's own storage: the span of B (its first element to its
    last, by its strides) lies within one leaf's bytes.  A copy of a weight,
    of a per-head view of ``w_uk`` or ``w_uv`` say, fails."""
    from repro_torch.kernels import tcec_matmul as tm
    from repro_torch.models.modules import tree_leaves
    dev = toks.device
    spans = [(t.data_ptr(), t.data_ptr() + t.nbytes)
             for t in tree_leaves(params)]
    reads, launch = [], tm.launch

    def spy(a, b, *rest):
        lo = b.data_ptr()
        hi = lo + b.element_size() * (1 + sum(
            (n - 1) * st for n, st in zip(b.shape, b.stride())))
        reads.append(any(s <= lo and hi <= e for s, e in spans))
        return launch(a, b, *rest)

    B, ps, maxp = 4, 16, 4
    pools = model.init_paged_cache(1 + B * maxp, ps, device=dev)
    bt = torch.arange(1, 1 + B * maxp, dtype=torch.int32,
                      device=dev).reshape(B, maxp)
    lengths = torch.tensor([3, 17, 40, 63], dtype=torch.int32, device=dev)
    tm.launch = spy
    try:
        with torch.no_grad():
            model.decode_step_paged(params, pools, bt, lengths, toks[0, :B])
            at_decode = len(reads)
            model.prefill(params, toks[:, :4])
        torch.cuda.synchronize()
    finally:
        tm.launch = launch
    counts = forward_counts(cfg)
    row = {"weights_in_place": f"{cfg.name}: every kernel-1 launch of one "
           "decode step (4 slots) and one 4-token prefill reads B inside a "
           "parameter leaf", "decode_launches": at_decode,
           "prefill_launches": len(reads) - at_decode,
           "in_place": sum(reads), "copied": len(reads) - sum(reads)}
    emit(row)
    rec["weights_in_place"] = row
    check(at_decode == counts["decode"]["tcec_matmul"]
          and len(reads) - at_decode == counts["prefill"]["tcec_matmul"],
          "13d: the step's and the prefill's kernel-1 launches as counted")
    check(all(reads), "13d: every kernel-1 launch reads B in place")


def engine_tokens_vs_dense(dev, cfg, model, params, rec, counts, weights):
    """13f: ``generate_dense`` over the MLA dense cache (9a's run: 4 greedy
    prompts of 64 tokens, 16 generated; the prompts prefill in one
    forward), then the engine on the same prompts: how many tokens are
    equal is reported, with no gate (the two attend over caches of other
    lengths, so their masked reductions differ in order)."""
    from repro_torch.serving import Engine, SamplingParams
    dense_run(dev, cfg, model, params, rec, counts["decode"], weights,
              prefill=counts["prefill"])
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
    engine = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 6,
                    page_size=16, max_pages_per_slot=6, device=dev)
    rids = [engine.add_request(p, SamplingParams(max_tokens=16))
            for p in prompts]
    out = engine.run()
    got = [list(out[r]) for r in rids]
    same = sum(a == b for g, d in zip(got, rec["tokens"])
               for a, b in zip(g, d))
    row = {"engine_vs_generate_dense": f"{cfg.name}: the engine on "
           "generate_dense's 4 prompts of 64 tokens, 16 greedy tokens each",
           "equal_tokens": same, "tokens": 4 * 16,
           "equal_requests": sum(g == d for g, d in zip(got, rec["tokens"]))}
    emit(row)
    rec["engine_vs_generate_dense"] = row


def mtp_on_the_card(dev, rec):
    """13g: the MTP head at deepseek-v3-671b's smoke config (3 layers,
    d_model 64, 4 experts top 2, mtp on): ``loss_fn`` and its gradients
    through the kernels against ``dispatch.use_plain()`` (phase 7b's
    rule: the loss, the MTP loss, the gradient norm and the worst leaf
    within 1e-3), the routes recorded on both sides; the kernel side
    launches kernels 1 and 2, the plain side neither."""
    row, moved, n, n_routes = mtp_row(dev)
    emit(row)
    rec["mtp_check"] = row
    check(n_routes == 2 * n and moved == 0, "13g: equal routes")
    check(row["kernel_launches"]["tcec_matmul"] > 0
          and row["kernel_launches"]["tcec_attention"] > 0,
          "13g: the kernel side runs kernels 1 and 2")
    check(not any(row["plain_launches"].values()),
          "13g: plain side: no kernel launch")
    for k in ("loss_rel_diff", "mtp_loss_rel_diff", "grad_norm_rel_diff",
              "worst_leaf_rel_diff"):
        check(row[k] <= 1e-3, f"13g: {k} <= 1e-3")


def mtp_row(dev, scale=None):
    """13g's comparison: ``(row, moved routes, routings a side, routings
    recorded)``.  With ``scale``, the plain side against itself with every
    parameter multiplied by ``scale`` (the leaves' conditioning: how far an
    f32 rounding-sized change of the inputs moves each gradient)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import dispatch
    from repro_torch.models import get_model, layers
    from repro_torch.models.modules import tree_leaves, tree_map
    cfg = get_smoke_config(DEEPSEEK)
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = device_batch(cfg, DataConfig(seed=1, global_batch=4, seq_len=32),
                         0, dev)

    def loss_and_grads():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, met = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return {k: float(v.detach()) for k, v in met.items()}, grads

    with recorded(layers, "moe_route", keep=lambda r: r["topi"]) as routes:
        c0 = kernel_counts()
        if scale is None:
            met, grads = loss_and_grads()
        else:
            kept = params
            params = tree_map(lambda t: t * scale, kept)
            with dispatch.use_plain():
                met, grads = loss_and_grads()
            params = kept
        c1 = kernel_counts()
        n = len(routes)
        with dispatch.use_plain():
            pmet, pgrads = loss_and_grads()
        c2 = kernel_counts()
    moved = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(routes[:n], routes[n:]))
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    pnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in pgrads)))
    def paths(tree, at=""):
        if isinstance(tree, dict):
            return [q for k, v in tree.items() for q in paths(v, f"{at}/{k}")]
        return [at]

    names = paths(params)
    leaves = [float((g - q).abs().max() / q.abs().max())
              for g, q in zip(grads, pgrads)]
    worst = max(range(len(leaves)), key=leaves.__getitem__)
    row = {"mtp_check": f"{cfg.name} smoke (mtp on), 4 x 32: loss_fn + "
           "backward, kernels vs dispatch.use_plain()",
           "loss": met["loss"], "plain_loss": pmet["loss"],
           "mtp_loss": met["mtp_loss"], "plain_mtp_loss": pmet["mtp_loss"],
           "loss_rel_diff": abs(met["loss"] - pmet["loss"]) / abs(
               pmet["loss"]),
           "mtp_loss_rel_diff": abs(met["mtp_loss"] - pmet["mtp_loss"])
           / abs(pmet["mtp_loss"]),
           "grad_norm_rel_diff": abs(norm - pnorm) / pnorm,
           "worst_leaf_rel_diff": leaves[worst],
           "worst_leaf": names[worst], "moved_routes": moved,
           "routings": n, "tolerance": "1e-3 each",
           "kernel_launches": {k: c1[k] - c0[k] for k in c0},
           "plain_launches": {k: c2[k] - c1[k] for k in c0}}
    return row, moved, n, len(routes)


def paper_numerics(dev):
    """Phase 11: (a) the Fig. 11 battery, (b) the long-sequence path."""
    a = fig11_battery(dev)
    b = long_sequence(dev)
    return {k: a[k] + b[k] for k in a}


# ------------------------------------------------------------ phase 14

def fresh_tune_cache(name):
    """A fresh autotuner file under ``chiprun_out/`` (gitignored), so every
    run starts cold and nothing is read from or left in the home
    directory."""
    path = ROOT / "chiprun_out" / name
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    return path


def use_tune_cache(path):
    """Point the process's env-default numerics config at ``path``: the
    environment, not a ``numerics.use`` scope, so that autograd's worker
    thread (which starts from the env defaults) sees it too."""
    from repro_torch import numerics
    os.environ["REPRO_TUNE_CACHE"] = str(path)
    return numerics.reload_env_defaults()


def zero_counts():
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    for m in (tm, ta, tp):
        m.launches = 0
    tp.f32_launches = 0
    for k in tm.epilogue_launches:
        tm.epilogue_launches[k] = 0


SERVE_LENS = [512, 512, 200, 200, 64, 64, 17, 17]


def pinned_engine_run(dev, cfg, params, pin, label):
    """Phase 4's 8-request run on an engine pinned to ``pin``, the counts
    zeroed just before and read just after.  Returns the row (launches,
    epilogue launches, times) and the tokens."""
    from repro_torch.kernels import tcec_matmul as tm
    from repro_torch.serving import Engine, SamplingParams
    engine = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                    page_size=16, max_pages_per_slot=40, device=dev,
                    numerics_config=pin)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENS]
    prefill_s = timed_method(engine, "_admit_and_prefill")
    step_s = timed_method(engine, "step")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = engine.run(prompts, SamplingParams(max_tokens=16))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel_counts()
    stats = engine.stats()
    # steps after the first (which captures the graph), without admissions
    decode_s = sorted(s - p for s, p in zip(step_s[1:], prefill_s[1:])
                      if p < 1e-3)
    tokens = sum(len(v) for v in out.values())
    row = {"phase14_engine": label, "n_layers": cfg.n_layers,
           "generated_tokens": tokens, "seconds": dt,
           "tokens_per_s": tokens / dt, "prefill_s": sum(prefill_s),
           "first_step_s": step_s[0],
           "decode_step_median_ms": 1e3 * decode_s[len(decode_s) // 2]
           if decode_s else None,
           "decode_steps_timed": len(decode_s),
           "prefills": stats["prefills"],
           "decode_steps": stats["decode_steps"],
           "decode_warmups": stats["decode_warmups"],
           "launches": launches,
           "epilogue_launches": dict(tm.epilogue_launches),
           "finish_reasons": sorted({v.finish_reason for v in out.values()})}
    check(all(v.finish_reason == "length" and len(v) == 16
              for v in out.values()),
          f"{label}: every request finished with 16 tokens")
    return row, stats, {r: list(v) for r, v in out.items()}


def rel_diff(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def fused_vs_plain_and_unfused(cfg, params, pin, label):
    """14a/b: the 64-token prefill's logits and ``forward_logits`` at 2 x
    512 through the pinned model (the gate's activation in kernel 1's
    epilogue) against the same under ``dispatch.use_plain()`` and against
    the unfused kernel path, each within 1e-3; L epilogue launches a
    forward."""
    from repro_torch.kernels import dispatch, tcec_matmul as tm
    from repro_torch.models import get_model
    fused = get_model(cfg, pin)
    unfused = get_model(cfg, pin.replace(fuse_epilogue=False))
    dev = params["embed"].device
    rng = np.random.default_rng(5)
    probe = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(dev)
    wide = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).to(dev)
    row = {"phase14_logits": label, "limit": 1e-3}
    L = cfg.n_layers
    with torch.no_grad():
        for name, run in (
                ("prefill_64", lambda m: m.prefill(params, probe)[0]),
                ("forward_2x512", lambda m: m.forward_logits(params, wide))):
            zero_counts()
            fast = run(fused)
            counts = kernel_counts()
            check(tm.epilogue_launches[cfg.activation] == L
                  and counts["tcec_matmul"] == 7 * L + 1,
                  f"{label} {name}: 7L + 1 launches, L with the "
                  f"{cfg.activation} epilogue")
            with dispatch.use_plain():
                plain = run(fused)
            other = run(unfused)
            row[f"{name}_vs_plain"] = rel_diff(fast, plain)
            row[f"{name}_vs_unfused"] = rel_diff(fast, other)
            del fast, plain, other
            torch.cuda.empty_cache()
    emit(row)
    for k, v in row.items():
        if k.endswith(("_vs_plain", "_vs_unfused")):
            check(math.isfinite(v) and v <= 1e-3, f"{label} {k} <= 1e-3")
    return row


def pinned_path(dev, arch, pin):
    """14a / 14b: ``arch`` at full width, random weights from seed 0, served
    under ``pin`` (the gate's activation fused); launch counts, logits
    against plain and unfused, replay bitwise equal to eager, and the
    greedy tokens of an unfused run counted beside the fused run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    params = get_model(cfg).init(seed=0, device=dev)
    L = cfg.n_layers
    row, stats, toks = pinned_engine_run(dev, cfg, params, pin,
                                         f"{arch} fused")
    counts = forward_counts(cfg)
    forwards = stats["prefills"] + stats["decode_steps"] \
        + stats["decode_warmups"]
    row["launches_counted"] = {
        k: counts["prefill"][k] * stats["prefills"] + counts["decode"][k]
        * (stats["decode_steps"] + stats["decode_warmups"])
        for k in row["launches"]}
    check(row["launches"] == row["launches_counted"],
          f"{arch}: launches as counted (7L + 1 a forward)")
    check(row["epilogue_launches"][cfg.activation] == L * forwards
          and sum(row["epilogue_launches"].values()) == L * forwards,
          f"{arch}: L of the 7L + 1 kernel-1 launches a forward carry the "
          f"{cfg.activation} epilogue")
    off_row, _, off_toks = pinned_engine_run(
        dev, cfg, params, pin.replace(fuse_epilogue=False),
        f"{arch} unfused")
    row["unfused_tokens_per_s"] = off_row["tokens_per_s"]
    row["unfused_decode_step_median_ms"] = off_row["decode_step_median_ms"]
    row["unfused_prefill_s"] = off_row["prefill_s"]
    row["greedy_tokens_equal_unfused"] = sum(
        a == b for r in toks for a, b in zip(toks[r], off_toks[r]))
    row["greedy_tokens"] = sum(len(v) for v in toks.values())
    emit(row)
    logits = fused_vs_plain_and_unfused(cfg, params, pin, arch)
    replay = replay_equals_eager(dev, cfg, params, numerics_config=pin)
    return {"engine": row, "logits": logits, "replay": replay}, \
        (cfg, params), row["launches"]


def prefill_tuned_vs_off(cfg, params, pin, reps=10):
    """14c: the 2 x 32 and 2 x 64 prefills (M 64 and 128, the products
    where a path crossing sits) timed under ``pin`` (tuned) and under
    ``tune="off"`` (the rule by M), in turns: medians of host time to a
    synchronize, and two profiled prefills of each (off, tuned, tuned,
    off): the device's busy time and kernel 1's.  No gate: a first
    measurement."""
    from repro_torch.models import get_model
    dev = params["embed"].device
    rng = np.random.default_rng(6)
    row = {"phase14_prefill_tuned_vs_off": cfg.name}
    models = {"tuned": get_model(cfg, pin),
              "off": get_model(cfg, pin.replace(tune="off"))}
    with torch.no_grad():
        for S in (32, 64):
            toks = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (2, S))).to(dev)
            times = {k: [] for k in models}
            for m in models.values():
                m.prefill(params, toks)                  # tune, warm up
            for i in range(reps):
                for k in (("tuned", "off") if i % 2 else ("off", "tuned")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    models[k].prefill(params, toks)
                    torch.cuda.synchronize()
                    times[k].append((time.perf_counter() - t0) * 1e3)
            for k, v in times.items():
                v.sort()
                row[f"2x{S}_{k}_ms"] = v[len(v) // 2]
                row[f"2x{S}_{k}_min_ms"] = v[0]
            for k in ("off", "tuned", "tuned", "off"):
                prof = profile_window(f"{cfg.name} prefill 2 x {S}, {k}",
                                      lambda m=models[k]: m.prefill(params,
                                                                    toks))
                row.setdefault(f"2x{S}_{k}_device_busy_ms", []).append(
                    prof["device_busy_ms"])
                row.setdefault(f"2x{S}_{k}_kernel1_ms", []).append(
                    prof["port_kernels"]["tcec_matmul"]["ms"])
    emit(row)
    return row


def _bucket(key):
    m = re.search(r"b(\d+)_m(\d+)_n(\d+)_k(\d+)$", key)
    return tuple(int(x) for x in m.groups())


def tuner_report(dev, cache_path, pin):
    """14c: the cache the pinned runs filled.  For each kernel-1 bucket the
    chosen path and both paths' measured times, for kernel 3 the chosen C
    beside ``chunk_pages``'s; a second ``BlockCache`` on the file gives the
    same choices with no measurement; every bucket whose measured path is
    not the rule by M's is run on the chosen path and held to phase 2's
    gate against plain and to the f32 gate."""
    from repro_torch.kernels import ops, tcec_matmul as tm, tuning
    from repro_torch.kernels import tcec_paged_attention as tp
    entries = json.loads(Path(cache_path).read_text())["entries"]
    names = {v: k for k, v in tm.tiles().items()}
    rows, changed = [], []
    for key, e in sorted(entries.items()):
        if "/paged/" in key:
            b, h, r, p, ps, d, v = (int(x) for x in re.search(
                r"b(\d+)_h(\d+)_r(\d+)_p(\d+)_ps(\d+)_d(\d+)_v(\d+)",
                key).groups())
            rows.append({"key": key, "kernel": "tcec_paged_attention",
                         "C": e["block"][0], "ms": e["ms"],
                         "chunk_pages_C": tp.chunk_pages(b, h, p, ps, d, v),
                         "timings": tuning.measured.get((str(cache_path),
                                                         key))})
            continue
        if "/attn/" in key:
            continue
        B, M, N, K = _bucket(key)
        path = names[tuple(e["block"])]
        row = {"key": key, "kernel": "tcec_matmul", "path": path,
               "rule_path": tm.path(M), "ms": e["ms"],
               "timings": {names[tuple(json.loads(k))]: v for k, v in
                           tuning.measured.get((str(cache_path), key),
                                               {}).items()}}
        rows.append(row)
        if path != row["rule_path"]:
            changed.append((key, B, M, N, K, e["block"]))
    for row in rows:
        emit({"phase14_tuner": row})
    # a second cache object on the same file: the same choices, and the
    # tuner measures nothing
    cache2 = tuning.BlockCache(path=str(cache_path))
    calls = []
    for key, e in entries.items():
        check(cache2.get(key)["block"] == e["block"],
              f"{key}: the file's choice read back")
        if "/paged/" in key or "/attn/" in key:
            continue
        B, M, N, K = _bucket(key)
        blk, meta = tuning.autotune(
            B, M, N, K, key.split("/")[1], cache=cache2, cfg=pin,
            device=dev, measure=lambda b: calls.append(b) or 0.0)
        check(meta["source"] == "cache" and list(blk) == e["block"],
              f"{key}: a fresh cache hits")
    check(not calls, "reuse from a fresh BlockCache measures nothing")
    # the buckets whose measured path is not the rule's: that product on
    # the chosen path, against plain and against f64
    checked = []
    for key, B, M, N, K, block in changed:
        g = torch.Generator(device=dev).manual_seed(M + N + K)
        bsh = (B,) if B > 1 else ()
        a = torch.randn(*bsh, M, K, generator=g, device=dev)
        b = torch.randn(*bsh, K, N, generator=g, device=dev) * K ** -0.5
        pol = key.split("/")[1]
        out = ops.tcec_matmul(a, b, pol, block=block)
        ref = tm.tcec_matmul_plain(a, b, pol)
        tol = 8 * K * U24 * (a.abs() @ b.abs())
        err = (out - ref).abs()
        row = {"shape": f"changed bucket {key}", "path": names[tuple(block)],
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float((err / tol).max())}
        check(bool((err <= tol).all()), f"{key}: chosen path vs plain")
        ref64 = a.double() @ b.double()
        f32_gate(row, ref64, out, a @ b)
        emit({"phase14_changed_bucket": row})
        checked.append(row)
        del a, b, out, ref, ref64, err, tol
        torch.cuda.empty_cache()
    return {"entries": rows, "changed_buckets": checked,
            "measure_launches": tuning.measure_launches,
            "capture_misses": tuning.capture_misses}


def hatches_on_the_card(dev, cfg, params, base):
    """14d: an engine pinned to ``enabled=False`` launches none of the three
    kernels and its 64-token logits are within 1e-3 of the kernel path's;
    one pinned to ``paged_attention=False`` launches kernel 3 zero times;
    a train step's forward under ``use(enabled=False)`` with its backward
    run after the scope launches no kernel (the autograd functions and the
    remat recompute carry the forward's config to autograd's worker
    thread), while the same step under the default config does."""
    from repro_torch import numerics
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves
    row = {"phase14_hatches": cfg.name}
    off = base.replace(enabled=False)
    erow, _, _ = pinned_engine_run(dev, cfg, params, off,
                                   f"{cfg.name} enabled=False")
    row["enabled_false_launches"] = erow["launches"]
    row["enabled_false_tokens_per_s"] = erow["tokens_per_s"]
    check(not any(erow["launches"].values()),
          "enabled=False: no kernel launched")
    probe = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 64))).to(dev)
    with torch.no_grad():
        plain = get_model(cfg, off).prefill(params, probe)[0]
        fast = get_model(cfg, base).prefill(params, probe)[0]
    row["enabled_false_logits_vs_kernels"] = rel_diff(plain, fast)
    check(row["enabled_false_logits_vs_kernels"] <= 1e-3,
          "enabled=False: 64-token logits within 1e-3 of the kernel path")
    prow, _, _ = pinned_engine_run(dev, cfg, params,
                                   base.replace(paged_attention=False),
                                   f"{cfg.name} paged_attention=False")
    row["paged_false_launches"] = prow["launches"]
    check(prow["launches"]["tcec_paged_attention"] == 0
          and prow["launches"]["tcec_matmul"] > 0,
          "paged_attention=False: kernel 3 never launched")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 128))).to(dev)
    batch = {"tokens": toks, "labels": toks}
    model = get_model(cfg)
    for scope in ("enabled=False", "default"):
        zero_counts()
        with numerics.use(enabled=scope == "default"):
            loss, _ = model.loss_fn(params, batch)
        forward = kernel_counts()
        zero_counts()
        loss.backward()
        backward = kernel_counts()
        row[f"train_{scope}_forward"] = forward
        row[f"train_{scope}_backward"] = backward
        check(math.isfinite(float(loss.detach())), "train step loss finite")
        for t in leaves:
            t.grad = None
    for t in leaves:
        t.requires_grad_(False)
    check(not any(row["train_enabled=False_forward"].values())
          and not any(row["train_enabled=False_backward"].values()),
          "a forward under use(enabled=False), its backward after the scope:"
          " no kernel launched")
    check(row["train_default_backward"]["tcec_matmul"] > 0,
          "the same step under the default config launches kernel 1 in its "
          "backward")
    emit(row)
    return row


def verbs_on_the_card(dev):
    """14e: ``repro_torch.matmul`` at 2048^3 x6 launches kernel 1 once and
    passes phase 3's gate; ``repro_torch.attention`` at 2 x 512, 16/8 heads
    launches kernel 2 once, within 1e-5 max|v| of plain."""
    import repro_torch
    from repro_torch.kernels import tcec_attention as ta
    g = torch.Generator(device=dev).manual_seed(2048)
    a = torch.rand(2048, 2048, generator=g, device=dev) * 2 - 1
    b = torch.rand(2048, 2048, generator=g, device=dev) * 2 - 1
    zero_counts()
    out = repro_torch.matmul(a, b, policy="tcec_bf16x6")
    mm = kernel_counts()
    ref = a.double() @ b.double()
    r6 = residual(ref, out)
    r32 = residual(ref, a @ b)
    q = torch.randn(2, 512, 16, 128, generator=g, device=dev)
    k = torch.randn(2, 512, 8, 128, generator=g, device=dev)
    v = torch.randn(2, 512, 8, 128, generator=g, device=dev)
    zero_counts()
    o = repro_torch.attention(q, k, v, policy="tcec_bf16x6")
    at = kernel_counts()
    err = float((o - ta.tcec_attention_plain(q, k, v)).abs().max())
    row = {"phase14_verbs": "matmul 2048^3 x6, attention 2x512 16/8 hd 128",
           "matmul_launches": mm, "x6_residual": r6, "sgemm_residual": r32,
           "ratio": r6 / r32, "attention_launches": at,
           "attention_max_abs_err": err,
           "attention_tol": 1e-5 * float(v.abs().max())}
    emit(row)
    check(mm == {"tcec_matmul": 1, "tcec_attention": 0,
                 "tcec_paged_attention": 0}, "matmul verb: kernel 1 once")
    check(r6 <= 2 * r32, "matmul verb: x6 residual <= 2x SGEMM's")
    check(at == {"tcec_matmul": 0, "tcec_attention": 1,
                 "tcec_paged_attention": 0}, "attention verb: kernel 2 once")
    check(err <= row["attention_tol"], "attention verb vs plain, 1e-5 max|v|")
    return row, {"tcec_matmul": 1, "tcec_attention": 1,
                 "tcec_paged_attention": 0}


def mtp_under_the_tuner(dev, cache_path):
    """14f (reported, no gate): 13g's comparison with the kernel side under
    ``tune="auto"`` (the tuner measures the smoke-sized products; it takes
    path S at M 65-128, where the rule by M takes path W), beside the same
    comparison with the plain side against itself, every parameter scaled
    by 1 + 1e-7: how far an f32-rounding-sized change moves the worst
    gradient leaf.  The port's default tune mode stays "off" while 13g's
    gate (1e-3 on that leaf) sits below it (``repro_torch/numerics.py``)."""
    from repro_torch import numerics
    with numerics.use(tune="auto", tune_cache=str(cache_path)):
        tuned, moved, _, _ = mtp_row(dev)
    floor, _, _, _ = mtp_row(dev, scale=1.0 + 1e-7)
    keys = ("worst_leaf_rel_diff", "worst_leaf", "grad_norm_rel_diff",
            "loss_rel_diff")
    row = {"phase14_mtp_under_the_tuner": "deepseek-v3-671b smoke: 13g's "
           "comparison under tune=auto, and plain against plain with the "
           "parameters scaled by 1 + 1e-7 (reported, no gate)",
           "tuned": {k: tuned[k] for k in keys}, "moved_routes": moved,
           "plain_scaled_1e-7": {k: floor[k] for k in keys},
           "gate_of_13g": 1e-3}
    emit(row)
    return row


def numerics_path(dev):
    """Phase 14: the numerics config and the measured tuner; returns the
    launches of (a), (b) and (e)."""
    from repro_torch import numerics
    from repro_torch.kernels import tuning
    cache = fresh_tune_cache("tcec_autotune_phase14.json")
    pin = numerics.NumericsConfig(policy="tcec_bf16x6", fuse_epilogue=True,
                                  tune="force", tune_cache=str(cache))
    base = numerics.active()
    total = dict.fromkeys(PORT_KERNELS, 0)
    rec = RECORD["phase14"] = {}
    # the earlier phases' engines hold their models through reference
    # cycles (a wrapped bound method): collect them before this one
    gc.collect()
    torch.cuda.empty_cache()
    rec["allocated_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
    emit({"phase14_allocated_at_start_gb": rec["allocated_at_start_gb"]})
    before = tuning.measure_launches, tuning.capture_misses
    rec["qwen3"], (cfg, params), launches = pinned_path(
        dev, "qwen3-0.6b", pin)                                 # 14a
    for k in total:
        total[k] += launches[k]
    rec["prefill_tuned_vs_off"] = prefill_tuned_vs_off(cfg, params, pin)
    rec["hatches"] = hatches_on_the_card(dev, cfg, params, base)  # 14d
    rec["verbs"], launches = verbs_on_the_card(dev)              # 14e
    for k in total:
        total[k] += launches[k]
    del params, cfg
    gc.collect()
    torch.cuda.empty_cache()
    rec["gemma"], (cfg, params), launches = pinned_path(
        dev, "gemma-2b", pin)                                   # 14b
    for k in total:
        total[k] += launches[k]
    del params, cfg
    torch.cuda.empty_cache()
    rec["tuner"] = tuner_report(dev, cache, pin)                # 14c
    rec["mtp_under_the_tuner"] = mtp_under_the_tuner(          # 14f
        dev, fresh_tune_cache("tcec_autotune_phase14f.json"))
    rec["tuner"]["phase_measure_launches"] = \
        tuning.measure_launches - before[0]
    rec["tuner"]["phase_capture_misses"] = tuning.capture_misses - before[1]
    emit({"phase14_tuner_counts": {
        k: rec["tuner"][k] for k in ("measure_launches", "capture_misses",
                                     "phase_measure_launches",
                                     "phase_capture_misses")}})
    check(rec["tuner"]["phase_capture_misses"] == 0,
          "no tuner miss while a graph was captured: the warm-up step "
          "filled the cache first")
    return total


# ------------------------------------------------------------ phase 15

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def resilient_run(dev, cfg, params, prompts, pin, plan=None, deadline=None,
                  spy=None, **kw):
    """The 8 greedy requests (16 tokens each) on a fresh engine pinned to
    ``pin`` (phase 4's engine, ``kw`` overriding it; ``spy(engine)`` called
    on it first), under the fault plan ``plan``; the launch counts zeroed
    just before, read just after.
    Returns the engine, ``{rid: (tokens, finish reason, clock at the
    finish)}``, the launches and the host seconds of the run and of each
    step without an admission (the decode steps after the capture)."""
    from repro_torch import faults
    from repro_torch.serving import Engine, SamplingParams
    args = dict(max_slots=4, num_pages=1 + 4 * 40, page_size=16,
                max_pages_per_slot=40)
    args.update(kw)
    eng = Engine(cfg, params, device=dev, numerics_config=pin, **args)
    if spy is not None:
        spy(eng)
    prefill_s = timed_method(eng, "_admit_and_prefill")
    step_s = timed_method(eng, "step")
    _sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    for p in prompts:
        eng.add_request(p, SamplingParams(max_tokens=16), deadline=deadline)
    clocks = {}
    with faults.use(plan):
        while eng.sched.has_work:
            eng.step()
            for rid, req in eng._requests.items():
                if req.finish_reason is not None:
                    clocks.setdefault(rid, eng.clock)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = (kernel_counts() if dev.type == "cuda" else
                dict.fromkeys(PORT_KERNELS, 0))
    out = {rid: (list(r.out), r.finish_reason, clocks[rid])
           for rid, r in eng._requests.items()}
    decode_s = [s - p for s, p in zip(step_s[1:], prefill_s[1:]) if p < 1e-3]
    timing = {"seconds": dt,
              "tokens_per_s": sum(len(v[0]) for v in out.values()) / dt,
              "decode_step_median_ms": 1e3 * float(np.median(decode_s))
              if decode_s else None,
              "decode_steps_timed": len(decode_s)}
    return eng, out, launches, timing


def _tokens(out):
    return {rid: v[0] for rid, v in out.items()}


def explain_cost(dev, model, params, toks, reps=10):
    """Host seconds of one prefill (ending in a sync) with the explain
    table recording and with ``record`` replaced by a no-op, in turns
    (with, without, without, with): medians."""
    from repro_torch.kernels import dispatch
    real = dispatch._explain
    times = {"recording": [], "not_recording": []}

    def once(key):
        dispatch._explain = real if key == "recording" else (
            lambda *a, **k: None)
        try:
            t0 = time.perf_counter()
            model.prefill(params, toks)
            _sync(dev)
            times[key].append(time.perf_counter() - t0)
        finally:
            dispatch._explain = real

    with torch.no_grad():
        once("recording")                      # warm
        for _ in range(reps):
            for key in ("recording", "not_recording", "not_recording",
                        "recording"):
                once(key)
    return {k: float(np.median(v)) for k, v in times.items()}


def counted_plain_versions():
    """Wrap the plain versions of kernels 1-3 (the names dispatch calls and
    the modules' own) so each call is counted; returns the count dict and
    the undo function."""
    from repro_torch.kernels import (dispatch, tcec_attention as ta,
                                     tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    counts = dict.fromkeys(("tcec_matmul_plain", "tcec_attention_plain",
                            "tcec_paged_attention_plain"), 0)
    undo = []
    for mod in (dispatch, tm, ta, tp):
        for name in counts:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def counted(*a, _fn=fn, _name=name, **k):
                counts[_name] += 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
            undo.append((mod, name, fn))

    def restore():
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    return counts, restore


def deadline_reference(lens, plan_spec, deadline):
    """The deadline run of 15c on the CPU at the smoke config (the same
    engine shape, prompt lengths, plan and deadline): each request's
    finish reason and the clock at its finish.  Scheduling alone decides
    both, so the full-width run on the card must match."""
    from repro_torch import faults, numerics
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    cfg = get_smoke_config("qwen3-0.6b")
    params = get_model(cfg).init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    _, out, _, _ = resilient_run(
        torch.device("cpu"), cfg, params, prompts,
        numerics.active().replace(guard=True),
        faults.plan_from_spec(plan_spec), deadline=deadline)
    return {rid: (v[1], v[2]) for rid, v in out.items()}


def resilience_path(dev, arch="qwen3-0.6b"):
    """Phase 15: faults, telemetry and the guard on qwen3-0.6b at full
    width; returns the phase's launches (every engine run's, zeroed before
    and read after).  It also runs on the CPU (with ``get_config`` giving
    the smoke config) to rehearse it there; the checks that only a card can
    make (launch counts, the decode graph, the plain versions' calls) then
    pass by default."""
    from repro_torch import faults, numerics, obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import policy_mm
    from repro_torch.kernels import guard, tcec_matmul as tm
    from repro_torch.models import get_model
    from repro_torch.obs import metrics
    from repro_torch.serving import Engine, EngineOverloaded, SamplingParams
    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = RECORD["phase15"] = {}
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENS]
    probe = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(dev)
    base = numerics.active()
    guarded = base.replace(guard=True)
    total = dict.fromkeys(PORT_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    # (a) the traced run between two untraced ones (the first also warms
    # the kernels' libraries up)
    _, plain_out, launches, t_first = resilient_run(dev, cfg, params,
                                                    prompts, base)
    add(launches)
    ref = _tokens(plain_out)
    obs.reset()
    with obs.trace() as tr:
        _, traced, launches, t_on = resilient_run(dev, cfg, params, prompts,
                                                  base)
    add(launches)
    _, again, launches, t_off = resilient_run(dev, cfg, params, prompts,
                                              base)
    add(launches)
    check(_tokens(again) == ref, "15a: two untraced runs, the same tokens")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tr.export(str(out_dir / "trace_phase15.json"))
    check(_tokens(traced) == ref, "15a: the traced run's greedy tokens equal "
          "the untraced run's")
    life = {}
    for e in tr.events:
        if e.get("cat") == "request":
            life.setdefault(e["id"], []).append((e["name"], e["ph"],
                                                 e["args"].get("finish")))
    check(sorted(life) == sorted(ref) and all(
        ev[0] == ("request", "b", None) and ("admitted", "n", None) in ev
        and ev[-1] == ("request", "e", "length") for ev in life.values()),
        "15a: every request has its begin, admitted and end (with its "
        "finish reason) events")
    hist = {}
    for name in ("queue_wait_s", "ttft_s", "tpot_s"):
        h = metrics.histogram(f"serving/latency/{name}")
        hist[name] = {"count": h.count(), "p50": h.percentile(50),
                      "p90": h.percentile(90)}
    check(all(v["count"] > 0 for v in hist.values()),
          "15a: the three latency histograms are non-empty")
    spans = {}
    for e in tr.events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    by = {}                           # the traced run's decisions, for (b)
    for e in obs.explain().entries:
        by.setdefault(e["kernel"], {}).setdefault(e["rule"], 0)
        by[e["kernel"]][e["rule"]] += e["count"]
    cost = explain_cost(dev, model, params, probe[:, :32].repeat(2, 1))
    rec["a"] = {"untraced_first": t_first, "traced": t_on,
                "untraced": t_off, "latency": hist,
                "spans": spans, "events": len(tr.events),
                "prefill_2x32_host_s": cost}
    emit({"phase15a": rec["a"]})

    # (b) explain: every decision of the traced run for kernels 1-3 fused
    kernel_rules = {k: by.get(k, {}) for k in ("matmul", "attention",
                                               "paged_attention")}
    check(all(set(v) == {"fused"} for v in kernel_rules.values()),
          "15b: every decision for kernels 1-3 in the traced run is fused, "
          "and each kernel has one")
    obs.reset()
    zero_counts()
    with torch.no_grad(), numerics.use(enabled=False):
        get_model(cfg).prefill(params, probe)
    _sync(dev)
    off = {e["rule"] for e in obs.explain().entries}
    off_launches = (kernel_counts() if dev.type == "cuda" else
                    dict.fromkeys(PORT_KERNELS, 0))
    check(off == {"hatch-disabled"} and not any(off_launches.values()),
          "15b: a forward under enabled=False records only hatch-disabled "
          "and launches nothing")
    rec["b"] = {"traced_run_rules": by, "disabled_rules": sorted(off)}
    emit({"phase15b": rec["b"]})

    # (c) chaos under guard=True; the plain versions are counted (after
    # the CPU reference of the deadline plan, whose route is theirs)
    slow_spec = "decode.slow@every=4:arg=3"
    cpu_clocks = deadline_reference(SERVE_LENS, slow_spec, 12)
    plain, restore = counted_plain_versions()
    try:
        guard.reset()
        _, free, launches, _ = resilient_run(dev, cfg, params, prompts,
                                             guarded)
        add(launches)
        check(_tokens(free) == ref, "15c: the guarded fault-free run's "
              "tokens equal the unguarded run's")
        chaos = {}

        def plan_run(spec, **kw):
            guard.reset()
            plan = faults.plan_from_spec(spec)
            eng, out, launches, _ = resilient_run(dev, cfg, params, prompts,
                                                  guarded, plan, **kw)
            add(launches)
            st = eng.stats()
            row = {"log": plan.log, "breaker": guard.counters(),
                   "finish": {r: v[1] for r, v in out.items()},
                   **{k: st[k] for k in ("prefill_faults", "numerics_errors",
                                         "guard_trips", "fallback_reruns",
                                         "decode_faults", "timeouts",
                                         "preemptions", "graph_replays")}}
            chaos[spec] = row
            emit({"phase15c": {spec: row}})
            return eng, out, row

        _, out, row = plan_run("pool.alloc@0:1")
        check(len(row["log"]) == 2 and _tokens(out) == ref,
              "15c pool.alloc@0:1: tokens equal the fault-free run's")
        _, out, row = plan_run("prefill@0")
        check(row["prefill_faults"] == 1 and _tokens(out) == ref,
              "15c prefill@0: the group re-queued, tokens equal")
        victims = []

        def nonfinite_victims(eng):
            real = eng._poison_mask

            def spy():
                mask = real()
                victims.extend(r.rid for r in eng.sched.running.values()
                               if mask[r.slot])
                return mask
            eng._poison_mask = spy
        spec = "decode.nonfinite@3:arg=1"
        guard.reset()
        eng, out, launches, _ = resilient_run(
            dev, cfg, params, prompts, guarded, faults.plan_from_spec(spec),
            spy=nonfinite_victims)
        add(launches)
        chaos[spec] = {"victims": victims, "finish": {
            r: v[1] for r, v in out.items()},
            "guard_trips": eng.stats()["guard_trips"],
            "fallback_reruns": eng.stats()["fallback_reruns"]}
        check(len(victims) == 1 and out[victims[0]][1] == "error"
              and all(out[r][0] == ref[r] and out[r][1] == "length"
                      for r in ref if r != victims[0])
              and chaos[spec]["guard_trips"] == 1
              and chaos[spec]["fallback_reruns"] == 0,
              "15c decode.nonfinite@3:arg=1: the slot-1 request ends error "
              "(no re-run), every other request's tokens equal")
        _, out, row = plan_run("kernel.matmul@0:1")
        row["tokens_equal"] = sorted(r for r in ref if out[r][0] == ref[r])
        check(row["breaker"]["failures"] == 2 and all(
            (v[1] == "length" and v[0] == ref[r]) or v[1] == "error"
            for r, v in out.items()),
            "15c kernel.matmul@0:1: two failures counted, the engine "
            "survives, every request ends with its tokens or error")
        _, out, row = plan_run(slow_spec, deadline=12)
        card = {r: (v[1], v[2]) for r, v in out.items()}
        row["finish_clocks"] = card
        check(card == cpu_clocks and row["timeouts"] > 0,
              "15c decode.slow@every=4:arg=3, deadline 12: the requests end "
              "(timeout) at the same clocks as on the CPU at the smoke "
              "config")
        if dev.type == "cuda":
            spec = f"kernel.paged@{L}"
            eng, out, row = plan_run(spec)
            check(row["log"] == [("kernel.paged", L)]
                  and row["decode_faults"] == 1
                  and [out[r][1] for r in range(4)] == ["error"] * 4
                  and all(out[r][0] == ref[r] for r in range(4, 8))
                  and eng._graph is not None and row["graph_replays"] > 0,
                  "15c kernel.paged during the decode graph's capture: that "
                  "step's requests end error, the next step captures "
                  "afresh, the later requests' tokens equal")
        # the breaker's whole cycle at the MLP gate's decode product
        guard.reset()
        g = torch.Generator(device=dev).manual_seed(15)
        a = torch.randn(4, cfg.d_model, generator=g, device=dev)
        b = torch.randn(cfg.d_model, cfg.d_ff, generator=g, device=dev)
        cycle = {}
        with numerics.use(guard=True):
            eager = policy_mm(a, b, cfg.policy)
            with faults.use(faults.plan_from_spec("kernel.matmul@0:1")):
                for _ in range(guard.THRESHOLD):
                    try:
                        policy_mm(a, b, cfg.policy)
                    except faults.FaultInjected:
                        cycle["failed"] = cycle.get("failed", 0) + 1
                before = tm.launches
                for _ in range(guard.COOLDOWN):
                    try:
                        policy_mm(a, b, cfg.policy)
                    except guard.KernelQuarantined:
                        cycle["quarantined"] = cycle.get("quarantined",
                                                         0) + 1
                cycle["cooldown_launches"] = tm.launches - before
                probe_out = policy_mm(a, b, cfg.policy)
                cycle["probe_launches"] = tm.launches - before
        cycle["probe_bitwise"] = bool(torch.equal(probe_out, eager))
        cycle["breaker"] = guard.counters()
        chaos["breaker_cycle"] = cycle
        br = cycle["breaker"]
        check(cycle.get("failed") == 2
              and cycle.get("quarantined") == guard.COOLDOWN
              and cycle["cooldown_launches"] == 0
              and (dev.type != "cuda" or cycle["probe_launches"] == 1)
              and cycle["probe_bitwise"]
              and (br["failures"], br["opens"], br["closes"]) == (2, 1, 1),
              "15c breaker cycle: 2 failures open it, the cooldown raises "
              "KernelQuarantined without a launch, the probe launches and "
              "closes it")
    finally:
        restore()
    chaos["plain_calls"] = dict(plain)
    # (a CPU operand's route is the plain version: counted on the card)
    check(dev.type != "cuda" or not any(plain.values()),
          "15c: the plain versions of kernels 1-3 were called 0 times "
          "across the chaos runs")
    rec["c"] = chaos
    emit({"phase15c": {k: chaos[k] for k in (
        "decode.nonfinite@3:arg=1", "breaker_cycle", "plain_calls")}})

    # (d) the monitor
    before = {n: metrics.counter(f"numerics/monitor/{n}").total()
              for n in ("probes", "underflow_risk", "product_underflow_risk",
                        "skipped_capture")}
    with torch.no_grad():
        on, _ = get_model(cfg, base.replace(monitor=True)).prefill(params,
                                                                   probe)
        off_logits, _ = get_model(cfg, base).prefill(params, probe)
    delta = {n: metrics.counter(f"numerics/monitor/{n}").total() - v
             for n, v in before.items()}
    check(torch.equal(on, off_logits) and delta["probes"] > 0
          and delta["underflow_risk"] == 0
          and delta["product_underflow_risk"] == 0,
          "15d: monitor=True leaves the 64-token prefill's logits bitwise, "
          "probes every contraction and counts no risk on these weights")
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(64, cfg.d_model, generator=g, device=dev) * 2.0 ** -115
    w = torch.randn(cfg.d_model, 256, generator=g, device=dev)
    risk = metrics.counter("numerics/monitor/underflow_risk")
    r0 = risk.total()
    with numerics.use(monitor=True):
        policy_mm(x, w, cfg.policy)
    scaled_risk = risk.total() - r0
    check(scaled_risk == 1, "15d: operands scaled out of the safe exponent "
          "range raise the underflow risk count")
    skipped = metrics.counter("numerics/monitor/skipped_capture")
    s0 = skipped.total()
    eng = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                 page_size=16, max_pages_per_slot=40, device=dev,
                 numerics_config=base.replace(monitor=True))
    mon = eng.run(prompts[4:6], SamplingParams(max_tokens=16))
    skipped_n = skipped.total() - s0
    check(dev.type != "cuda" or skipped_n > 0,
          "15d: the decode graph's capture skipped its probes (counted)")
    check([list(v) for v in mon.values()] == [ref[4], ref[5]],
          "15d: the monitored engine's tokens equal the unmonitored run's")
    rec["d"] = {"prefill_64": delta, "scaled_underflow_risk": scaled_risk,
                "skipped_capture": skipped_n}
    emit({"phase15d": rec["d"]})

    # (e) backpressure and parking
    eng = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                 page_size=16, max_pages_per_slot=40, device=dev,
                 max_waiting=2)
    overloaded = []
    for i, p in enumerate(prompts):
        try:
            eng.add_request(p, SamplingParams(max_tokens=16))
        except EngineOverloaded:
            overloaded.append(i)
    kept = eng.run()
    check(overloaded == list(range(2, 8))
          and [list(v) for v in kept.values()] == [ref[0], ref[1]],
          "15e: max_waiting=2 rejects the 3rd to 8th request with "
          "EngineOverloaded; the two kept finish with their tokens")
    # the first admission takes 33 + 33 + 13 + 13 pages: a 92-page pool
    # runs dry when a 200-token request needs its 14th page
    eng, out, launches, _ = resilient_run(dev, cfg, params, prompts, base,
                                          num_pages=1 + 92,
                                          max_preemptions=1)
    add(launches)
    st = eng.stats()
    rec["e"] = {"overloaded": overloaded, "preemptions": st["preemptions"],
                "parks": st["parks"],
                "finish": {r: v[1] for r, v in out.items()},
                "tokens_equal": sorted(r for r in ref if out[r][0] == ref[r])}
    emit({"phase15e": rec["e"]})
    check(st["parks"] >= 1 and all(v[1] == "length" and v[0] == ref[r]
                                   for r, v in out.items()),
          "15e: max_preemptions=1 on a 92-page pool parks, and every request "
          "finishes with its fault-free tokens")
    rec["launches"] = total
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase15_s": rec["seconds"], "phase15_launches": total})
    del params, model, eng
    gc.collect()
    return total


# ------------------------------------------------------------ phase 16

PREFIX_LEN = 512
PREFIX_TAILS = [128, 128, 64, 64, 32, 32, 17, 17]
PREFIX_KNOBS = {"off": {}, "prefix": dict(prefix_cache=True),
                "chunked": dict(chunked_prefill=256),
                "async": dict(async_sched=True),
                "all": dict(prefix_cache=True, chunked_prefill=256,
                            async_sched=True)}
# the runs in order: the knob-off run first (the reference; the first f32
# engine of the process, so also its warm-up), again last (its times)
PREFIX_RUNS = ("off", "prefix", "chunked", "async", "all", "off again")


def prefix_prompts(vocab, seed=16):
    """Phase 16's prompts: one shared 512-token prefix, then a distinct
    tail each."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PREFIX_LEN)
    return [np.concatenate([shared, rng.integers(0, vocab, n)])
            for n in PREFIX_TAILS]


def prefix_run(dev, cfg, params, prompts, knob, defrag=False, keep=()):
    """One of phase 16's runs: the 8 greedy requests (16 tokens each) on a
    fresh engine with f32 pools (4 slots, pages of 16, room for every
    request's pages twice over), the serving knobs of ``knob``; the launch
    counts zeroed just before, read just after.  A one-token request runs
    first, before the clock starts, so that the decode graph's capture
    (about 0.2 s) falls outside the times.  With ``defrag`` the engine is
    defragmented once the first request has finished.  Recorded for each
    request, by its index in ``prompts``: its first token's logits row and
    host seconds from the start (TTFT), and for the requests in ``keep``
    the K/V of the shared prefix's pages when that token is drawn; for
    each chunk its launches.  Returns the engine, the tokens (a list, in
    the order of ``prompts``) and the record."""
    from repro_torch import numerics
    from repro_torch.kernels import tcec_paged_attention as tp
    from repro_torch.models.modules import tree_leaves
    from repro_torch.serving import Engine, SamplingParams
    ps = 16
    pages = -(-(PREFIX_LEN + max(PREFIX_TAILS) + 17) // ps)
    eng = Engine(cfg, params, device=dev, max_slots=4,
                 num_pages=1 + 2 * len(prompts) * pages, page_size=ps,
                 max_pages_per_slot=pages, cache_dtype=torch.float32,
                 numerics_config=numerics.active().replace(
                     **PREFIX_KNOBS[knob]))
    rec = {"first": {}, "prefix_kv": {}, "chunks": [], "defragged": False}
    first = eng._first_token

    def spy_first(req, row):
        if req.rid not in rids:                     # the warm-up request
            return first(req, row)
        i = rids.index(req.rid)
        if i in keep:
            idx = torch.tensor(req.pages[:PREFIX_LEN // ps], device=dev)
            rec["prefix_kv"][i] = [p[:, idx] for p in tree_leaves(eng.pools)]
        rec["first"][i] = row.clone()
        first(req, row)
        _sync(dev)
        rec.setdefault("ttft", {})[i] = time.perf_counter() - t0

    chunk = eng.model.prefill_chunk

    def spy_chunk(*a, **k):
        before = {m: n for m, n in counts().items()}
        out = chunk(*a, **k)
        rec["chunks"].append({m: n - before[m] for m, n in counts().items()})
        return out

    def counts():
        from repro_torch.kernels import (tcec_attention as ta,
                                         tcec_matmul as tm)
        return {"tcec_matmul": tm.launches, "tcec_attention": ta.launches,
                "tcec_paged_attention": tp.launches}

    rids = []
    eng._first_token = spy_first
    eng.run([prompts[0][:1]], SamplingParams(max_tokens=2))   # the capture
    eng.model.prefill_chunk = spy_chunk
    prefill_s = timed_method(eng, "_admit_and_prefill")
    chunk_s = timed_method(eng, "_prefill_chunk_step")
    step_s = timed_method(eng, "step")
    _sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    rids += [eng.add_request(p, SamplingParams(max_tokens=16))
             for p in prompts]
    while eng.sched.has_work or eng._inflight is not None:
        eng.step()
        if (defrag and not rec["defragged"]
                and any(eng._requests[r].finished for r in rids)):
            eng.defragment()
            rec["defragged"] = True
    _sync(dev)
    dt = time.perf_counter() - t0
    rec["launches"] = counts() if dev.type == "cuda" else dict.fromkeys(
        PORT_KERNELS, 0)
    rec["f32_launches"] = tp.f32_launches
    out = eng.results()
    toks = [list(out[r]) for r in rids]
    rec["seconds"] = dt
    rec["tokens_per_s"] = sum(len(v) for v in toks) / dt
    # decode-only steps: no admission and no chunk work in the step
    decode = [s for s, p, c in zip(step_s, prefill_s, chunk_s)
              if p + c < 1e-3]
    rec["decode_step_median_ms"] = (1e3 * float(np.median(decode))
                                    if decode else None)
    rec["decode_steps_timed"] = len(decode)
    rec["finish"] = sorted({out[r].finish_reason for r in rids})
    return eng, toks, rec


def prefill_busy(dev, cfg, params, prompts, knob):
    """The device busy time of the admission that prefills requests 5-8
    (their 4 x 544 prefill with the knobs off; their 32- and 17-token tails
    on the cached prefix with the prefix cache): requests 1-4 run to the
    end first, then 5-8 are added and the admission is profiled alone."""
    from repro_torch.serving import SamplingParams
    RECORD.setdefault("profile", [])
    eng, _, _ = prefix_run(dev, cfg, params, prompts[:4], knob)
    for p in prompts[4:]:
        eng.add_request(p, SamplingParams(max_tokens=16))

    def admit():
        with torch.no_grad():
            eng._admit_and_prefill()
            eng._prefill_chunk_step()

    row = profile_window(f"phase 16: prefill of requests 5-8, {knob}", admit)
    eng.run()
    return row


def prefix_reference_counts(knobs=("prefix", "all")):
    """Phase 16's plan at the smoke config on the CPU: the prefix
    counters each knob's run gives there (the prediction the card's run
    must reach)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    cfg = get_smoke_config("qwen3-0.6b")
    params = get_model(cfg).init(seed=0, device="cpu")
    prompts = prefix_prompts(cfg.vocab_size)
    out = {}
    for knob in knobs:
        eng, _, _ = prefix_run(torch.device("cpu"), cfg, params, prompts,
                               knob)
        st = eng.stats()
        out[knob] = {k: st[k] for k in ("prefix_hits", "prefix_tokens_reused",
                                        "cow_splits", "prefill_chunks",
                                        "prefills")}
    return out


def prefix_path(dev, arch="qwen3-0.6b"):
    """Phase 16: the prefix cache, chunked prefill, async scheduling and
    defragment on qwen3-0.6b at full width (28 layers), random weights
    from seed 0, f32 pools; returns the phase's launches (kernel 3's are
    its f32 instantiation's).  Also runs on the CPU at the smoke config
    (``get_config`` patched) to rehearse it; the checks only a card can
    make then pass by default."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import tcec_matmul as tm
    from repro_torch.models import get_model
    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    on_card = dev.type == "cuda"
    rec = RECORD["phase16"] = {"card": RECORD.get("nvidia_smi")}
    cfg = get_config(arch)
    params = get_model(cfg).init(seed=0, device=dev)
    L = cfg.n_layers
    prompts = prefix_prompts(cfg.vocab_size)
    hits = list(range(4, 8))                  # requests 5-8 find the prefix
    predicted = prefix_reference_counts()
    rec["predicted"] = predicted
    counted, restore = counted_plain_versions()
    total = dict.fromkeys(PORT_KERNELS, 0)
    f32 = 0
    runs = {}
    try:
        for name in PREFIX_RUNS:
            knob = name.split()[0]
            eng, toks, r = prefix_run(
                dev, cfg, params, prompts, knob, defrag=knob == "all",
                keep=hits if name in ("off", "prefix", "all") else ())
            st = eng.stats()
            r["stats"] = {k: st[k] for k in (
                "prefix_hits", "prefix_tokens_reused", "cow_splits",
                "prefix_evictions", "prefill_chunks", "prefills",
                "decode_steps", "graph_replays")}
            runs[name] = (toks, r)
            for k in total:
                total[k] += r["launches"][k]
            f32 += r["f32_launches"]
            del eng
    finally:
        restore()
    ref, ref_rec = runs["off"]
    rows = {}
    for knob, (toks, r) in runs.items():
        row = {"run": knob, "knobs": PREFIX_KNOBS[knob.split()[0]],
               "tokens_equal_reference": toks == ref,
               "seconds": r["seconds"], "tokens_per_s": r["tokens_per_s"],
               "decode_step_median_ms": r["decode_step_median_ms"],
               "decode_steps_timed": r["decode_steps_timed"],
               "stats": r["stats"], "launches": r["launches"],
               "f32_launches": r["f32_launches"], "finish": r["finish"],
               "chunks": len(r["chunks"]), "defragged": r["defragged"],
               "ttft_s": [r["ttft"][i] for i in sorted(r["ttft"])],
               "card": rec["card"]}
        ttft = [r["ttft"][i] for i in hits]
        row["ttft_requests_5_8_p50_s"] = float(np.percentile(ttft, 50))
        row["ttft_requests_5_8_p90_s"] = float(np.percentile(ttft, 90))
        # first-token logits of the hits against the reference: bitwise
        # where the tail's kernel-1 products take the monolithic path
        firsts = {}
        for i in hits:
            a, b = r["first"][i], ref_rec["first"][i]
            firsts[i] = {"bitwise": bool(torch.equal(a, b)),
                         "max_rel_diff": float((a - b).abs().max()
                                               / b.abs().max())}
        row["first_token_logits"] = firsts
        rows[knob] = row
        emit({"phase16": row})
        check(toks == ref, f"16 {knob}: the tokens equal the knob-off run's")
        check(r["finish"] == ["length"], f"16 {knob}: every request ends "
              "with its 16 tokens")
        check(not on_card or counted == dict.fromkeys(counted, 0),
              f"16 {knob}: no call of a plain version")
        if on_card:
            check(r["f32_launches"] > 0 and r["f32_launches"]
                  == r["launches"]["tcec_paged_attention"],
                  f"16 {knob}: every kernel-3 launch on the f32 pools")
        for c in r["chunks"]:
            check(not on_card or c == {"tcec_matmul": 7 * L + 1,
                                       "tcec_attention": L,
                                       "tcec_paged_attention": 0},
                  f"16 {knob}: a chunk launches kernel 1 7L + 1 and "
                  "kernel 2 L times")
    # the counters against the CPU's prediction, and the reuse contract
    for knob in ("prefix", "all"):
        st, pred = runs[knob][1]["stats"], predicted[knob]
        check(st["prefix_hits"] >= pred["prefix_hits"] >= 4
              and st["prefix_tokens_reused"]
              >= pred["prefix_tokens_reused"] >= 4 * PREFIX_LEN,
              f"16 {knob}: hits and reused tokens at least the CPU run's")
        kv, ref_kv = runs[knob][1]["prefix_kv"], ref_rec["prefix_kv"]
        same = {i: all(torch.equal(a, b) for a, b in zip(kv[i], ref_kv[i]))
                for i in hits}
        rows[knob]["reuse_bitwise"] = same
        check(all(same.values()), f"16 {knob}: the pages a hit maps are "
              "bitwise the pages a fresh knob-off prefill writes")
    check(runs["chunked"][1]["stats"]["prefill_chunks"] == 3 * 8
          and runs["all"][1]["defragged"],
          "16: 3 chunks a prompt at chunk 256; the all-three run "
          "defragmented")
    # first-token logits of a hit: the tail's rows (C) against the
    # monolithic 4 x 544 prefill's
    mono = tm.path(4 * (PREFIX_LEN + 32))
    paths = {}
    for knob in ("prefix", "all"):
        tail = 32 if knob == "prefix" else 256
        same_path = tm.path(tail) == mono
        paths[knob] = {"tail_rows": tail, "tail_path": tm.path(tail),
                       "monolithic_path": mono, "same_path": same_path}
        for i, f in rows[knob]["first_token_logits"].items():
            if same_path:
                check(f["bitwise"], f"16 {knob}: request {i + 1}'s first "
                      "logits bitwise the reference's (same kernel-1 path)")
            else:
                check(f["max_rel_diff"] <= 1e-3, f"16 {knob}: request "
                      f"{i + 1}'s first logits within 1e-3 of the reference")
    rec["first_token_paths"] = paths
    emit({"phase16_first_token_paths": paths})
    rec["runs"] = rows
    if on_card:
        rec["replay_vs_eager"] = replay_equals_eager(
            dev, cfg, params, cache_dtype=torch.float32)
        rec["prefill_busy"] = {k: prefill_busy(dev, cfg, params, prompts, k)
                               for k in ("off", "prefix")}
    rec["launches"] = total
    rec["f32_launches"] = f32
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase16_s": rec["seconds"], "phase16_launches": total,
          "phase16_f32_launches": f32, "card": rec["card"]})
    del params
    gc.collect()
    return total, f32


# ------------------------------------------------------------ phase 17
#
# The parallel layer (``parallel/``, ``kernels/shmap.py``) in child
# processes: 17b on one rank over NCCL, 17a/c/d on two ranks over gloo,
# both ranks on the one card (NCCL refuses two ranks on one GPU).  Each
# child writes its rows and the kernel launches of its mesh runs to
# ``chiprun_out/phase17_*.json``; the parent reads them after checking the
# children's exit codes (``start_processes`` raises on any failure).

P17_PROBES = ("all_reduce", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_to_all_single")
# each is probed through torch.distributed (what 17c's K plans call) and
# through the functional collectives (what DTensor's redistributions call:
# 17d needs all four of those)
P17_APIS = ("c10d", "functional")


def _p17_out(name, rank):
    return ROOT / "chiprun_out" / f"phase17_{name}_rank{rank}.json"


def _p17_setup(on_card):
    """A child's imports: the repo's ``src``, the built kernels (already
    on disk: the build is keyed by the sources), and on the CPU the smoke
    config in place of the full one.  A child that dies on a signal
    prints its Python stack (``faulthandler``)."""
    import faulthandler
    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401
    from repro_torch import configs
    from repro_torch.kernels import _build
    if on_card:
        _build.build()
    else:
        configs.get_config = configs.get_smoke_config
    return configs.get_config


def _p17_launches():
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in (tm, ta, tp)}


def _p17_zero():
    from repro_torch.kernels import (tcec_attention as ta, tcec_matmul as tm,
                                     tcec_paged_attention as tp)
    for m in (tm, ta, tp):
        m.launches = 0


def _p17_engine(cfg, params, dev, mesh=None, lens=None, max_tokens=16):
    """Phase 4's engine run (4 slots, pages of 16, the 8 greedy requests of
    ``SERVE_LENS``) -> (tokens, stats, seconds, decode-step host ms)."""
    from repro_torch.serving import Engine, SamplingParams
    engine = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                    page_size=16, max_pages_per_slot=40, device=dev,
                    mesh=mesh)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in (lens or SERVE_LENS)]
    disp = timed_method(engine, "_decode_dispatch")
    cons = timed_method(engine, "_decode_consume")
    t0 = time.perf_counter()
    out = engine.run(prompts, SamplingParams(max_tokens=max_tokens))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = [(a + b) * 1e3 for a, b in zip(disp, cons)]
    return ([list(map(int, out[r])) for r in sorted(out)], engine.stats(),
            dt, steps, prompts)


def _p17_step_row(name, toks, stats, dt, steps):
    n = sum(len(t) for t in toks)
    return {"run": name, "tokens": n, "seconds": dt, "tokens_per_s": n / dt,
            "decode_steps": stats["decode_steps"],
            "decode_step_ms_median": float(np.median(steps)),
            "decode_step_ms_p90": float(np.percentile(steps, 90)),
            "decode_graph": stats["decode_graph"],
            "decode_graph_reason": stats["decode_graph_reason"],
            "graph_replays": stats["graph_replays"]}


def _p17_one_rank(rank, on_card):
    """17b: one rank over NCCL, a (1, 1) mesh, qwen3-0.6b at full width:
    the engine's tokens, replay against eager under the mesh, and the
    8 x 128 train step bitwise against the unsharded ones.  The child runs
    with deterministic algorithms: otherwise the embedding gradient's
    index accumulation sums repeated tokens in an arbitrary order, and two
    unsharded steps differ in its last bits."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    get_config = _p17_setup(on_card)
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import shmap
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.step import make_sharded_train_step, \
        make_train_step
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    dev = torch.device("cuda" if on_card else "cpu")
    t_all = time.perf_counter()
    mesh = make_host_mesh(1, device=dev.type)
    backend = torch.distributed.get_backend()
    cfg = get_config("qwen3-0.6b")
    params = get_model(cfg).init(seed=0, device=dev)
    sharded = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh, cfg), mesh))
    rows, launches = [], {}
    # the unsharded engine twice (the first run captures the graph and
    # warms every shape), then the mesh's
    _p17_engine(cfg, params, dev)
    base = _p17_engine(cfg, params, dev)
    rows.append(_p17_step_row("unsharded", *base[:4]))
    plain, restore = counted_plain_versions()
    shmap.reset_counters()
    _p17_zero()
    mesh_run = _p17_engine(cfg, sharded, dev, mesh=mesh)
    for k, v in _p17_launches().items():
        launches[k] = launches.get(k, 0) + v
    rows.append(_p17_step_row("mesh (1, 1) " + backend, *mesh_run[:4]))
    calls = shmap.counters()
    check(mesh_run[0] == base[0], "17b: tokens under the (1, 1) mesh == "
          "the unsharded engine's")
    check(all(calls[k] > 0 for k in shmap.KERNELS),
          f"17b: every wrapper ran ({calls})")
    if on_card:
        check(mesh_run[1]["decode_graph"] and mesh_run[1]["graph_replays"]
              == mesh_run[1]["decode_steps"],
              "17b: the decode graph is captured and replayed under the "
              "one-rank NCCL mesh")
        replay = replay_equals_eager(dev, cfg, sharded, mesh=mesh)
        rows.append({"replay_vs_eager_under_mesh": replay["steps"],
                     "bitwise_equal": True})
    # the train step, 8 x 128, bitwise
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    data = DataConfig(seed=0, global_batch=8, seq_len=128)
    batch = device_batch(cfg, data, 0, dev)
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    ref_step = make_train_step(cfg, opt)
    step, sh, sharder = make_sharded_train_step(cfg, opt, mesh)
    sstate, sbatch = shd.shard_tree(state, sh), sharder(batch)
    times = {}
    for name, fn, st, b in (("unsharded", ref_step, state, batch),
                            ("mesh", step, sstate, sbatch)):
        fn(st, b)                                  # warm
        if on_card:
            torch.cuda.synchronize()
        if name == "mesh":
            _p17_zero()
        t0 = time.perf_counter()
        out = fn(st, b)
        float(out[1]["loss"])
        times[name] = (time.perf_counter() - t0) * 1e3
        if name == "mesh":
            for k, v in _p17_launches().items():
                launches[k] = launches.get(k, 0) + v
            new, met = out
        else:
            ref_new, ref_met = out
    restore()
    same = all(torch.equal(ctx.full(a), b) for a, b in
               zip(tree_leaves(new), tree_leaves(ref_new)))
    rows.append({"train_step": "8 x 128 under the (1, 1) mesh",
                 "loss": float(met["loss"]),
                 "loss_bitwise": bool(torch.equal(met["loss"],
                                                  ref_met["loss"])),
                 "state_bitwise": same, "step_ms": times["mesh"],
                 "unsharded_step_ms": times["unsharded"]})
    check(torch.equal(met["loss"], ref_met["loss"]) and same,
          "17b: the train step's loss and state bitwise the unsharded step's")
    check(not on_card or sum(plain.values()) == 0,
          f"17b: plain versions called {plain}")
    _p17_out("b", rank).write_text(json.dumps({
        "rows": rows, "launches": launches, "wrapper_calls": calls,
        "backend": backend, "plain_calls": plain,
        "seconds": time.perf_counter() - t_all}))


def _p17_probe_one(name, api, dev):
    """One collective on this device's tensors over the world's 2 ranks:
    "ok", "wrong result", or the error it raised."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    r, w = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    x = torch.full((4 * w,), float(r + 1), device=dev)
    ranks = torch.arange(1, w + 1).float()
    try:
        if name == "all_reduce":
            if api == "c10d":
                dist.all_reduce(x)
            else:
                x = funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
            ok = bool((x == w * (w + 1) / 2).all())
        elif name == "all_gather_into_tensor":
            if api == "c10d":
                y = torch.empty(4 * w * w, device=dev)
                dist.all_gather_into_tensor(y, x)
            else:
                y = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, group))
            ok = bool((y.reshape(w, -1)[:, 0].cpu() == ranks).all())
        elif name == "reduce_scatter_tensor":
            if api == "c10d":
                y = torch.empty(4, device=dev)
                dist.reduce_scatter_tensor(y, x)
            else:
                y = funcol.wait_tensor(funcol.reduce_scatter_tensor(
                    x, "sum", 0, group))
            ok = bool((y == w * (w + 1) / 2).all())
        else:
            if api == "c10d":
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
            else:
                y = funcol.wait_tensor(funcol.all_to_all_single(
                    x, None, None, group))
            ok = bool((y.reshape(w, -1)[:, 0].cpu() == ranks).all())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return "ok" if ok else "wrong result"
    except Exception as exc:      # recorded: the probe's whole point
        return f"{type(exc).__name__}: {str(exc).splitlines()[0]}"


def _p17_probe_child(rank, on_card, store, keys, log):
    """17a's child: the probes in ``keys`` in turn; rank 0 appends
    ``start`` before and the result after each one to ``log``, so that a
    probe that kills the process is known by its unfinished start."""
    import faulthandler
    faulthandler.enable()
    import torch.distributed as dist
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    for api, name in keys:
        if rank == 0:
            with open(log, "a") as f:
                f.write(json.dumps({"start": [api, name]}) + "\n")
        got = _p17_probe_one(name, api, dev)
        if rank == 0:
            with open(log, "a") as f:
                f.write(json.dumps({"done": [api, name], "result": got})
                        + "\n")
    dist.barrier()
    dist.destroy_process_group()


def _p17_probe(on_card):
    """17a: which collectives gloo runs on the card's tensors, each through
    ``torch.distributed`` and through the functional collectives, in pairs
    of spawned ranks.  A probe that kills its processes (a signal) is
    recorded as such, and the probes after it run in a fresh pair."""
    import torch.multiprocessing as mp
    out_dir = ROOT / "chiprun_out"
    todo = [(api, name) for api in P17_APIS for name in P17_PROBES]
    results = {}
    attempt = 0
    while todo:
        attempt += 1
        store = out_dir / f"phase17_probe_store_{attempt}"
        log = out_dir / f"phase17_probe_{attempt}.jsonl"
        try:
            mp.start_processes(_p17_probe_child,
                               args=(on_card, str(store), todo, str(log)),
                               nprocs=2, join=True, start_method="spawn")
            died = None
        except mp.ProcessExitedException as exc:
            died = f"killed: {exc}"
        started = None
        for line in log.read_text().splitlines() if log.exists() else []:
            row = json.loads(line)
            if "done" in row:
                results[tuple(row["done"])] = row["result"]
                started = None
            else:
                started = tuple(row["start"])
        if died is None:
            break
        if started is None:
            raise RuntimeError(f"17a: the probe pair died outside a probe: "
                               f"{died}")
        results[started] = died
        todo = [k for k in todo if k not in results]
    return {f"{api} {name}": results[(api, name)]
            for api in P17_APIS for name in P17_PROBES}


def _p17_battery(dev, mesh12, mesh21, cfg):
    """17c: kernels 1-3 per shard at the model's shapes on 2 ranks, each
    rank's shard against its slice of the unsharded kernel on the same
    card: N, M, batch, heads, q-sequence and paged shards bitwise, K shards
    within ``1e-5 * max(scale, 1)``."""
    from repro_torch.kernels import dispatch, ops, shmap
    from repro_torch.kernels.shmap import MatmulPlan
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import P
    pol = "tcec_bf16x6"
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    M = 1024                                     # the 2 x 512 prefill
    g = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    def place(t, mesh, spec):
        return shd.distribute(t, mesh, shd.to_placements(spec, mesh))

    def mine(ref, mesh, out):
        return shd.local_shard(ref, mesh, out.placements)

    def k_plan(m, k, n):
        return MatmulPlan(P(None, "model"), P("model", None), P(None, None),
                          ("model",), (1, m, n, k // 2), "K")

    rows = []
    cases = [("wq (N)", mesh12, (M, D), (D, H * hd), None),
             ("wk / wv (N)", mesh12, (M, D), (D, Hkv * hd), None),
             ("w_gate / w_up (N)", mesh12, (M, D), (D, F), None),
             ("unembedding (N)", mesh12, (8, D), (D, V), None),
             ("wo (K, explicit plan)", mesh12, (M, H * hd), (H * hd, D),
              k_plan(M, H * hd, D)),
             ("w_down (K, explicit plan)", mesh12, (M, F), (F, D),
              k_plan(M, F, D)),
             ("K by the rule (N 1023)", mesh12, (M, D), (D, 1023), None),
             ("M (K 1025, N 1023)", mesh12, (M, 1025), (1025, 1023), None),
             ("batch (8 x 512 x 128 @ 128 x 512)", mesh21, (8, 512, hd),
              (8, hd, 512), None),
             ("M on data", mesh21, (M, D), (D, F), None)]
    for name, mesh, ash, bsh, plan in cases:
        a, b = rnd(*ash), rnd(*bsh)
        plan = plan or shmap.matmul_plan(a.shape, b.shape, mesh)
        ref = ops.tcec_matmul(a, b, pol)
        t0 = time.perf_counter()
        out = shmap.sharded_matmul(place(a, mesh, plan.a_spec),
                                   place(b, mesh, plan.b_spec), policy=pol,
                                   mesh=mesh, plan=plan)
        local = out.to_local()
        err = float((local - mine(ref, mesh, out)).abs().max())
        scale = float(ref.abs().max())
        limit = 1e-5 * max(scale, 1.0) if plan.psum_axes else 0.0
        rows.append({"case": name, "plan": plan.sharded_dim,
                     "local": list(plan.local), "max_abs_err": err,
                     "limit": limit, "seconds": time.perf_counter() - t0})
        check(err <= limit, f"17c {name}: {err} > {limit}")
    for name, Hq, Hk in (("heads (16/8 on 2 ranks)", H, Hkv),
                         ("q sequence (3/1 heads)", 3, 1)):
        q, k, v = rnd(2, 512, Hq, hd), rnd(2, 512, Hk, hd), \
            rnd(2, 512, Hk, hd)
        plan = shmap.attention_plan(q.shape, k.shape, mesh12)
        ref = dispatch._attention_local(q, k, v, None, None, pol, True, 0,
                                        None, dispatch._cfg(None))
        t0 = time.perf_counter()
        out = shmap.sharded_attention(
            place(q, mesh12, plan.q_spec), place(k, mesh12, plan.k_spec),
            place(v, mesh12, plan.v_spec), policy=pol, mesh=mesh12,
            plan=plan)
        err = float((out.to_local() - mine(ref, mesh12, out)).abs().max())
        rows.append({"case": name, "plan": plan.mode,
                     "local": list(plan.local), "max_abs_err": err,
                     "limit": 0.0, "seconds": time.perf_counter() - t0})
        check(err == 0.0, f"17c attention {name}: {err}")
    qd = rnd(4, H, hd)
    kp, vp = rnd(161, 16, Hkv, hd).bfloat16(), rnd(161, 16, Hkv, hd).bfloat16()
    bt = torch.arange(1, 161, device=dev, dtype=torch.int32).reshape(4, 40)
    lens = torch.tensor([520, 520, 208, 208], device=dev, dtype=torch.int32)
    plan = shmap.paged_plan(qd.shape, kp.shape, mesh12)
    ref = dispatch._paged_local(qd, kp, vp, bt, lens, pol, 0, None,
                                dispatch._cfg(None))
    t0 = time.perf_counter()
    out = shmap.sharded_paged_attention(
        place(qd, mesh12, plan.q_spec), place(kp, mesh12, plan.pool_spec),
        place(vp, mesh12, plan.pool_spec), bt, lens, policy=pol,
        mesh=mesh12, plan=plan)
    err = float((out.to_local() - mine(ref, mesh12, out)).abs().max())
    rows.append({"case": "paged decode (4 slots, Hkv 8 on 2 ranks)",
                 "plan": "heads", "local": list(plan.local),
                 "max_abs_err": err, "limit": 0.0,
                 "seconds": time.perf_counter() - t0})
    check(err == 0.0, f"17c paged: {err}")
    return rows


def _p17_model(dev, mesh12, mesh21, cfg, lens, max_tokens):
    """17d: qwen3-0.6b at full width on 2 ranks.  (1, 2): the engine's
    greedy tokens equal the unsharded engine's wherever the unsharded top-2
    gap exceeds 2e-3, and a teacher-forced prefill of each request's prompt
    and unsharded tokens has logits within 1e-3 (relative) of the
    unsharded prefill's; (2, 1): one 8 x 128 step's loss within 1e-5
    relative and every gradient within 1e-3 of its max|g|.  Times are
    printed, not gated: both ranks share one card."""
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)
    rows, launches = [], {}
    base = _p17_engine(cfg, params, dev, lens=lens, max_tokens=max_tokens)
    sharded = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh12, cfg), mesh12))
    _p17_zero()
    run = _p17_engine(cfg, sharded, dev, mesh=mesh12, lens=lens,
                      max_tokens=max_tokens)
    launches = _p17_launches()
    rows.append(_p17_step_row("unsharded", *base[:4]))
    rows.append(_p17_step_row("mesh (1, 2) gloo", *run[:4]))
    worst, compared, moved = 0.0, 0, []
    with torch.no_grad():
        for i, (p, want, have) in enumerate(zip(base[4], base[0], run[0])):
            seq = torch.tensor([list(p) + want[:-1]], device=dev)
            ref, _ = model.prefill(params, seq)
            with ctx.use_mesh(mesh12):
                got, _ = model.prefill(sharded, seq)
            got = ctx.full(got)
            rows_ref = ref[0, len(p) - 1:, :cfg.vocab_size]
            worst = max(worst, float((got - ref).abs().max()
                                     / ref.abs().max()))
            top2 = rows_ref.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).tolist()
            for j, (x, y) in enumerate(zip(want, have)):
                if gap[j] <= 2e-3:
                    break
                compared += 1
                if x != y:
                    moved.append((i, j))
    rows.append({"teacher_forced_logits_max_rel_diff": worst,
                 "limit": 1e-3, "tokens_compared": compared,
                 "tokens_differing": moved})
    check(worst <= 1e-3, f"17d: logits under (1, 2) within 1e-3 ({worst})")
    check(not moved, f"17d: greedy tokens differ at {moved}")
    data = DataConfig(seed=0, global_batch=8, seq_len=128)
    batch = device_batch(cfg, data, 0, dev)

    def grads(p, b):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = model.loss_fn(p, b)
        return loss, torch.autograd.grad(loss, tree_leaves(p))

    ref_loss, ref_g = grads(params, batch)
    s21 = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh21, cfg), mesh21))
    b21 = shd.shard_tree(batch, shd.to_shardings(
        shd.batch_specs(cfg, mesh21, batch), mesh21))
    _p17_zero()
    t0 = time.perf_counter()
    with ctx.use_mesh(mesh21, shd.batch_axes(cfg, mesh21)):
        loss, g = grads(s21, b21)
    loss = float(ctx.full(loss))
    dt = time.perf_counter() - t0
    for k, v in _p17_launches().items():
        launches[k] = launches.get(k, 0) + v
    rel = abs(loss - float(ref_loss)) / abs(float(ref_loss))
    gworst = max(float((ctx.full(a) - b).abs().max())
                 / max(float(b.abs().max()), 1e-30)
                 for a, b in zip(g, ref_g))
    rows.append({"train": "loss and gradients, 8 x 128 on (2, 1)",
                 "loss": loss, "loss_rel_diff": rel, "limit": 1e-5,
                 "grad_worst_rel": gworst, "grad_limit": 1e-3,
                 "seconds": dt})
    check(rel <= 1e-5, f"17d: loss on (2, 1) within 1e-5 ({rel})")
    check(gworst <= 1e-3, f"17d: gradients on (2, 1) within 1e-3 ({gworst})")
    return rows, launches


def _p17_two_ranks(rank, on_card, store, run_model):
    """17c, and 17d when ``run_model``, on two ranks over gloo (one card on
    the chip)."""
    get_config = _p17_setup(on_card)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    t_all = time.perf_counter()
    out = {}
    mesh12 = init_device_mesh(dev.type, (1, 2),
                              mesh_dim_names=("data", "model"))
    mesh21 = init_device_mesh(dev.type, (2, 1),
                              mesh_dim_names=("data", "model"))
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    out["battery"] = _p17_battery(dev, mesh12, mesh21, cfg)
    out["battery_s"] = time.perf_counter() - t0
    out["launches"] = {}
    if run_model:
        t0 = time.perf_counter()
        out["model"], out["launches"] = _p17_model(
            dev, mesh12, mesh21, cfg, lens=[200, 64, 17, 17], max_tokens=8)
        out["model_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_all
    _p17_out("acd", rank).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def parallel_path(dev):
    """Phase 17: returns the launches of its mesh runs (17b's engine and
    train step, 17d's engine and gradient step, rank 0's)."""
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for f in out_dir.glob("phase17_*"):
        f.unlink()
    rec = RECORD["phase17"] = {"card": RECORD.get("nvidia_smi")}
    t0 = time.perf_counter()
    mp.start_processes(_p17_one_rank, args=(on_card,), nprocs=1, join=True,
                       start_method="spawn")
    b = json.loads(_p17_out("b", 0).read_text())
    rec["17b"] = b
    for row in b["rows"]:
        emit({"phase17b": row})
    emit({"phase17b_s": time.perf_counter() - t0, "backend": b["backend"]})
    t0 = time.perf_counter()
    probe = rec["17a"] = _p17_probe(on_card)
    missing = [k for k, v in probe.items()
               if k.startswith("functional") and v != "ok"]
    emit({"phase17a_probe": probe, "phase17a_s": time.perf_counter() - t0,
          "runs": "17c on 2 ranks; 17d " + (
              "on 2 ranks" if not missing else
              "not on the card: over gloo on these tensors DTensor's "
              "redistributions lack " + ", ".join(missing)
              + " (17d runs in the CPU tests)")})
    check(probe["c10d all_reduce"] == "ok",
          "17a: gloo all_reduce on these tensors (17c's K plans need it)")
    t0 = time.perf_counter()
    store = out_dir / "phase17_store"
    mp.start_processes(_p17_two_ranks,
                       args=(on_card, str(store), not missing), nprocs=2,
                       join=True, start_method="spawn")
    acd = [json.loads(_p17_out("acd", r).read_text()) for r in (0, 1)]
    rec["17cd"] = acd
    for row in acd[0]["battery"]:
        emit({"phase17c": row})
    for row in acd[0].get("model", []):
        emit({"phase17d": row})
    emit({"phase17cd_s": time.perf_counter() - t0})
    launches = {k: b["launches"].get(k, 0) + acd[0]["launches"].get(k, 0)
                for k in ("tcec_matmul", "tcec_attention",
                          "tcec_paged_attention")}
    check(not on_card or all(v > 0 for v in launches.values()),
          f"phase 17: every kernel launched on the mesh runs ({launches})")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase17_s": rec["seconds"], "launches": launches})
    return launches


# ------------------------------------------------------------ phase 18
#
# The dry run (``launch/dryrun.py``, ``hlo_cost.py``, ``step.py::
# lower_cell``) held to the card.  18a runs in a child process: the dry
# run's fake world becomes the process's default group, which no NCCL
# group may share.  There qwen3-0.6b at full width is traced through
# ``lower_cell`` on a one-rank mesh at three steps, and then each step runs
# on the card.  18b traces one production cell through the dry run's CLI
# in a subprocess.

P18_STEPS = (("train 8 x 128", "train", 8, 128),
             ("forward_logits 2 x 512", "prefill", 2, 512),
             ("serve step 4 x 1024, dense cache", "decode", 4, 1024))


def _p18_kernel1_flops(on_card):
    """Wrap kernel 1's launch (its plain version on the CPU) to sum each
    call's kept terms x 2 batch M N K, from the shapes it is given;
    returns ``([flops, calls], restore)``."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import tcec_matmul as tm
    name = "launch" if on_card else "tcec_matmul_plain"
    orig = getattr(tm, name)
    seen = [0.0, 0]

    def wrapped(a, b, policy="tcec_bf16x6", *args, **kw):
        *bdims, M, K = a.shape
        seen[0] += (len(get_policy(policy).keep) * 2.0 * math.prod(bdims)
                    * M * b.shape[-1] * K)
        seen[1] += 1
        return orig(a, b, policy, *args, **kw)

    setattr(tm, name, wrapped)
    return seen, lambda: setattr(tm, name, orig)


def _p18_step(cfg, kind, B, S, dev):
    """The step of one 18a row on ``dev``, as a thunk, with the optimizer
    config ``lower_cell`` takes for this config (f32 moments)."""
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.launch.step import (make_prefill_step, make_serve_step,
                                         make_train_step)
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = device_batch(cfg, DataConfig(seed=0, global_batch=B, seq_len=S),
                         0, dev)
    if kind == "train":
        opt = adamw.OptConfig(moment_dtype="float32", factored_v=False)
        state = {"params": params, "opt": adamw.init_state(params, opt)}
        step = make_train_step(cfg, opt)
        return lambda: step(state, batch)
    if kind == "prefill":
        step = make_prefill_step(cfg)
        return lambda: step(params, {"tokens": batch["tokens"]})
    cache = model.init_cache(B, S, device=dev)
    tokens = batch["tokens"][:, 0].contiguous()
    step = make_serve_step(cfg)
    return lambda: step(params, cache, tokens, S - 1)


def _p18_child(rank, on_card, card):
    """18a (see the section comment); writes ``chiprun_out/
    phase18_18a_rank0.json``.  ``card`` is the parent's ``nvidia-smi``
    line."""
    get_config = _p17_setup(on_card)
    os.environ["REPRO_DRYRUN_DEVICES"] = "1"
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import HW, roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.step import lower_cell
    RECORD.setdefault("profile", [])
    dev = torch.device("cuda" if on_card else "cpu")
    t_all = time.perf_counter()
    mesh = make_production_mesh()
    cfg = get_config("qwen3-0.6b")
    rows, launches = [], {}
    for name, kind, B, S in P18_STEPS:
        t0 = time.perf_counter()
        pred, got_kind = lower_cell(cfg, ShapeConfig(name, S, B, kind), mesh)
        trace_s = time.perf_counter() - t0
        check(got_kind == kind, f"18a {name}: traced as {got_kind}")
        want = {k: pred["kernels"].get(k, {}).get("launches", 0)
                for k in ("tcec_matmul", "tcec_attention",
                          "tcec_paged_attention")}
        run = _p18_step(cfg, kind, B, S, dev)
        run()                                             # warm
        if on_card:
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        seen, restore = _p18_kernel1_flops(on_card)
        _p17_zero()
        out = run()
        got = _p17_launches()
        restore()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        del out
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        median = float(np.median(times))
        terms = roofline(pred)
        bound_ms = max(terms.values()) * 1e3
        row = {"step": name, "trace_s": trace_s,
               "launches_predicted": want, "launches_card": got,
               "kernel1_calls_card": seen[1],
               "kernel1_flops_predicted": pred["kernels"]["tcec_matmul"][
                   "flops"],
               "kernel1_flops_card": seen[0],
               "dot_flops_predicted": pred["dot_flops"],
               "dot_flops_by_dtype_predicted": pred["dot_flops_by_dtype"],
               "bytes_predicted": pred["bytes"],
               "peak_bytes_predicted": pred["memory"]["peak_size_in_bytes"],
               "memory_predicted": pred["memory"],
               "max_memory_allocated": peak,
               "roofline_terms_ms": {k: v * 1e3 for k, v in terms.items()},
               "roofline_step_ms": bound_ms, "step_ms_median": median,
               "step_ms_all": times,
               "roofline_fraction": bound_ms / median,
               "hw": HW["name"], "card": card}
        if on_card:
            prof = profile_window(f"18a {name}", run)
            row["device_busy_ms"] = prof["device_busy_ms"]
            row["port_kernels"] = prof["port_kernels"]
        rows.append(row)
        check(seen[1] == want["tcec_matmul"],
              f"18a {name}: kernel-1 calls {seen[1]} == the trace's "
              f"{want['tcec_matmul']}")
        check(not on_card or got == want,
              f"18a {name}: launches on the card {got} == the trace's {want}")
        check(seen[0] == row["kernel1_flops_predicted"],
              f"18a {name}: kernel-1 FLOPs from the launch shapes "
              f"{seen[0]} == the trace's {row['kernel1_flops_predicted']}")
    _p17_out("18a", rank).write_text(json.dumps({
        "rows": rows, "launches": launches,
        "seconds": time.perf_counter() - t_all}))
    torch.distributed.destroy_process_group()


def dryrun_path(dev):
    """Phase 18: returns the launches of 18a's card runs (one run of each
    step, counted from 0)."""
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    rec = RECORD["phase18"] = {"card": RECORD.get("nvidia_smi")}
    mp.start_processes(_p18_child, args=(on_card, RECORD.get("nvidia_smi")),
                       nprocs=1, join=True, start_method="spawn")
    a = json.loads(_p17_out("18a", 0).read_text())
    rec["18a"] = a
    for row in a["rows"]:
        emit({"phase18a": row})
    # 18b: one production cell through the CLI, on this host's CPU
    cell_dir = out_dir / "phase18_dryrun"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen3-0.6b", "--shape", "train_4k", "--out", str(cell_dir)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_DRYRUN_DEVICES", None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    cell_s = time.perf_counter() - t0
    cell = json.loads((cell_dir / "qwen3-0.6b__train_4k__16x16.json")
                      .read_text())
    row = {"phase18b": "qwen3-0.6b train_4k on the (16, 16) fake world",
           "status": cell["status"], "returncode": proc.returncode,
           "seconds": cell_s, "trace_s": cell.get("lower_s"),
           "roofline": cell.get("roofline"),
           "bottleneck": cell.get("bottleneck"),
           "roofline_fraction": cell.get("roofline_fraction"),
           "hlo_flops_per_device": cell.get("hlo_flops_per_device"),
           "collectives": cell.get("collectives", {}).get("counts"),
           "memory": cell.get("memory")}
    rec["18b"] = row
    emit(row)
    check(proc.returncode == 0 and cell["status"] == "ok",
          f"18b: the cell traced ok ({cell.get('error')})")
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase18_s": rec["seconds"], "launches": a["launches"]})
    return a["launches"]


# ------------------------------------------------------------ phase 19
#
# Every non-dense family under a mesh: a child process with one rank over
# NCCL on a (1, 1) mesh (19b), as 17b is for qwen3; then 19c, the
# vocab-parallel loss at qwen3's full-width loss shape on two ranks over
# gloo on the one card.  Each writes ``chiprun_out/phase17_19*.json``
# (``_p17_out``).

# the shmap wrappers each config's runs reach: kernel 3 only through the
# engine's paged decode (MLA decodes in the latent space, the dense cache
# attends in plain bf16), kernel 2 wherever a forward attends
P19_REACH = {"granite-moe-1b-a400m": ("matmul", "attention", "paged"),
             "deepseek-v3-671b": ("matmul", "attention"),
             "mamba2-130m": ("matmul",),
             "zamba2-1.2b": ("matmul", "attention"),
             "internvl2-2b": ("matmul", "attention"),
             "seamless-m4t-large-v2": ("matmul", "attention")}
P19_ENGINE = ("granite-moe-1b-a400m", "deepseek-v3-671b")
P19_TRAIN = ("granite-moe-1b-a400m", "mamba2-130m", "zamba2-1.2b",
             "internvl2-2b", "seamless-m4t-large-v2")
# depth cuts that keep phase 19 near 250 s: under the mesh each eager
# decode step pays DTensor's host cost on every op (on the H100, at full
# depth, zamba2's 38 layers took 77 s, seamless's 24 + 24 79 s; with those
# two halved, internvl2's 24 65 s and mamba2's 24 32 s); widths stay
P19_DEPTH = {"zamba2-1.2b": dict(n_layers=19),
             "seamless-m4t-large-v2": dict(n_layers=12, n_enc_layers=12),
             "internvl2-2b": dict(n_layers=12),
             "mamba2-130m": dict(n_layers=12)}


def _p19_dense(cfg, params, dev, B=4, P=64, gen=16, T=512):
    """Phases 9a / 10c's ``generate_dense`` run (``B`` greedy prompts of
    ``P`` tokens, ``gen`` generated) under the installed mesh, if any; for
    the enc-dec family 10a's served run in its place: ``prefill_cross`` on
    B x T stub frames, then the same loop over ``decode_step``, the cache
    laid out by ``cache_specs`` under a mesh as ``generate_dense`` lays out
    its own.  Returns (tokens, seconds, the generated steps' ms)."""
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    model = get_model(cfg)
    mod = model.module
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, P))
    steps, step = [], mod.decode_step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = step(*a, **kw)
        _sync(dev)
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    mod.decode_step = timed
    try:
        _sync(dev)
        t0 = time.perf_counter()
        if cfg.family != "audio":
            out = serve.generate_dense(cfg, params, prompts, gen, device=dev)
        else:
            frames = torch.from_numpy(rng.standard_normal(
                (B, T, cfg.frontend_dim)).astype(np.float32)).to(dev)
            cache = model.init_cache(B, P + gen + 1, mem_len=T, device=dev)
            mesh = ctx.current_mesh()
            if mesh is not None:
                cache = shd.shard_tree(cache, shd.to_shardings(
                    shd.cache_specs(cfg, mesh, cache, B, P + gen + 1),
                    mesh))
            toks, picked = torch.from_numpy(prompts).to(dev), []
            with torch.no_grad():
                mod.prefill_cross(params, frames, cfg, cache)
                for i in range(P):
                    logits, cache = model.decode_step(params, cache,
                                                      toks[:, i], i)
                for i in range(gen):
                    tok = torch.argmax(ctx.full(logits)[:, :cfg.vocab_size],
                                       dim=-1)
                    picked.append(tok)
                    logits, cache = model.decode_step(params, cache, tok,
                                                      P + i)
            out = torch.stack(picked, 1).cpu().numpy()
        _sync(dev)
        dt = time.perf_counter() - t0
    finally:
        mod.decode_step = step
    fed = P if model.prefill is None else 0
    return out.tolist(), dt, steps[fed:]


def _p19_train(cfg, params, dev, mesh, on_card, rows, launches, calls):
    """The train step (8 x 128; the SSM families 4 x 256, a whole chunk)
    unsharded and under the mesh, each once to warm and once timed: the
    loss and every parameter and moment bitwise (the unsharded state is
    held on the host meanwhile, so that the card holds two states, not
    three)."""
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import shmap
    from repro_torch.launch.step import make_sharded_train_step, \
        make_train_step
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    ssm = cfg.family in ("ssm", "hybrid")
    data = DataConfig(seed=0, global_batch=4 if ssm else 8,
                      seq_len=cfg.ssm_chunk if ssm else 128)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    batch = device_batch(cfg, data, 0, dev)
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    step, sh, sharder = make_sharded_train_step(cfg, opt, mesh)
    sstate, sbatch = shd.shard_tree(state, sh), sharder(batch)
    times, peaks = {}, {}
    for name, fn, st, b in (("unsharded", make_train_step(cfg, opt), state,
                             batch), ("mesh", step, sstate, sbatch)):
        fn(st, b)                                    # warm
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if name == "mesh":
            _p17_zero()
            shmap.reset_counters()
        t0 = time.perf_counter()
        new, met = fn(st, b)
        float(met["loss"])
        times[name] = (time.perf_counter() - t0) * 1e3
        peaks[name] = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                       else None)
        if name == "unsharded":
            ref = [t.cpu() for t in tree_leaves(new)]
            ref_met = {k: v.cpu() for k, v in met.items()}
            del new, met
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    for k, v in _p17_launches().items():
        launches[k] = launches.get(k, 0) + v
    for k, v in shmap.counters().items():
        calls[k] = calls.get(k, 0) + v
    loss_same = torch.equal(met["loss"].cpu(), ref_met["loss"])
    same = loss_same and all(torch.equal(ctx.full(a).cpu(), b)
                             for a, b in zip(tree_leaves(new), ref))
    rows.append({"config": cfg.name, "train_step": f"{data.global_batch} x "
                 f"{data.seq_len} under the (1, 1) mesh",
                 "loss": float(met["loss"]), "loss_bitwise": loss_same,
                 "state_bitwise": same, "step_ms": times["mesh"],
                 "unsharded_step_ms": times["unsharded"],
                 "peak_gb": peaks["mesh"],
                 "unsharded_peak_gb": peaks["unsharded"]})
    check(same, f"19b {cfg.name}: the train step's loss and state bitwise "
          "the unsharded step's")
    del new, state, sstate, ref


def _p19_one_rank(rank, on_card):
    """19b: one rank over NCCL, a (1, 1) mesh; each config at full width
    from seed-0 weights, deepseek-v3-671b at phase 13's 4 layers, zamba2
    and seamless at the depths of ``P19_DEPTH``: the
    serving tokens (the engine for granite and deepseek, with its decode
    graph captured and replayed under the mesh; ``_p19_dense`` for the
    others) equal the unsharded run's, the train step bitwise (not
    deepseek's: its full-width training waits for parameter sharding
    across cards), every wrapper the config reaches ran, and no plain
    version was called.  Deterministic algorithms, as in 17b."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    get_config = _p17_setup(on_card)
    from repro_torch.kernels import shmap
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    dev = torch.device("cuda" if on_card else "cpu")
    t_all = time.perf_counter()
    mesh = make_host_mesh(1, device=dev.type)
    backend = torch.distributed.get_backend()
    rows, launches, reached = [], {}, {}
    plain, restore = counted_plain_versions()
    for arch in P19_REACH:
        t_cfg = time.perf_counter()
        cfg = deepseek_config() if arch == DEEPSEEK else get_config(arch)
        cfg = cfg.replace(**{k: min(v, getattr(cfg, k)) for k, v in
                             P19_DEPTH.get(arch, {}).items()})
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        params = get_model(cfg).init(seed=0, device=dev)
        sharded = shd.shard_tree(params, shd.to_shardings(
            shd.param_specs(params, mesh, cfg), mesh))
        calls = {}
        if arch in P19_ENGINE:
            _p17_engine(cfg, params, dev)                   # warm, capture
            base = _p17_engine(cfg, params, dev)
            rows.append(dict(_p17_step_row("unsharded", *base[:4]),
                             config=arch))
            shmap.reset_counters()
            _p17_zero()
            run = _p17_engine(cfg, sharded, dev, mesh=mesh)
            stats = run[1]
            row = dict(_p17_step_row("mesh (1, 1) " + backend, *run[:4]),
                       config=arch)
            same = run[0] == base[0]
            check(not on_card or (stats["decode_graph"]
                                  and stats["graph_replays"]
                                  == stats["decode_steps"]),
                  f"19b {arch}: the decode graph is captured and replayed "
                  "under the mesh")
        else:
            _p19_dense(cfg, params, dev, P=4, gen=2)        # warm
            base = _p19_dense(cfg, params, dev)
            rows.append({"config": arch, "run": "unsharded",
                         "seconds": base[1],
                         "tokens_per_s": 4 * 16 / base[1],
                         "decode_step_ms_median": float(np.median(base[2]))})
            shmap.reset_counters()
            _p17_zero()
            with ctx.use_mesh(mesh):
                run = _p19_dense(cfg, sharded, dev)
            row = {"config": arch, "run": "mesh (1, 1) " + backend,
                   "seconds": run[1], "tokens_per_s": 4 * 16 / run[1],
                   "decode_step_ms_median": float(np.median(run[2])),
                   "decode_step_ms_p90": float(np.percentile(run[2], 90))}
            same = run[0] == base[0]
        for k, v in _p17_launches().items():
            launches[k] = launches.get(k, 0) + v
        for k, v in shmap.counters().items():
            calls[k] = calls.get(k, 0) + v
        row["tokens_equal"] = same
        row["serve_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                if on_card else None)
        rows.append(row)
        check(same, f"19b {arch}: tokens under the (1, 1) mesh == the "
              "unsharded run's")
        del sharded
        if arch in P19_TRAIN:
            _p19_train(cfg, params, dev, mesh, on_card, rows, launches,
                       calls)
        check(all(calls.get(k, 0) > 0 for k in P19_REACH[arch]),
              f"19b {arch}: every wrapper it reaches ran ({calls})")
        reached[arch] = calls
        rows.append({"config": arch, "seconds": time.perf_counter() - t_cfg})
        del params
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    restore()
    check(not on_card or sum(plain.values()) == 0,
          f"19b: plain versions called {plain}")
    _p17_out("19b", rank).write_text(json.dumps({
        "rows": rows, "launches": launches, "wrapper_calls": reached,
        "backend": backend, "plain_calls": plain,
        "seconds": time.perf_counter() - t_all}))


def _p19_loss_grad64(logits, labels, z_loss_w=1e-4):
    """The gradient of ``lm.cross_entropy`` in closed form, in f64:
    ``(softmax (1 + 2 z logz) - onehot) mask / tokens``."""
    mask = (labels >= 0).double()
    w = mask / mask.sum().clamp_min(1.0)
    g = logits.double()
    logz = torch.logsumexp(g, dim=-1)
    g.sub_(logz[..., None]).exp_().mul_(((1 + 2 * z_loss_w * logz) * w)[
        ..., None])
    g.scatter_add_(-1, labels.clamp_min(0).long()[..., None], -w[..., None])
    return g


def _p19_loss(rank, on_card, store, shape):
    """19c: ``lm.cross_entropy`` on (B, S, V) f32 logits drawn from a seed
    (qwen3's full-width loss shape on the card), split over the vocab on a
    (1, 2) mesh of two ranks over gloo on the one card, against the
    unsharded loss computed in each rank: the loss within 1e-6 relative,
    this rank's gradient shard within 1e-6 of ``max|g|`` of the gradient
    computed in f64, and the peak allocated above what was live when the
    loss began (the logits' shard) below the global logits' bytes.  The
    unsharded f32 gradient's distance to the shard and to f64 is
    reported: a row's f32 log-normalizer (about 20 here) is known to one
    unit in the last place, 1.9e-6, and each gradient entry carries that
    relative error times its probability, in the unsharded gradient as in
    the shard.  Only ``c10d`` all-reduces are used (17a's probe finds them
    on the card)."""
    import faulthandler
    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        from repro_torch.models.lm import cross_entropy
        from repro_torch.parallel import ctx
        from repro_torch.parallel import sharding as shd
        dev = torch.device("cuda" if on_card else "cpu")
        mesh = init_device_mesh(dev.type, (1, 2),
                                mesh_dim_names=("data", "model"))
        B, S, V = shape
        g = torch.Generator(dev).manual_seed(19)
        logits = torch.randn((B, S, V), generator=g, device=dev) * 4
        labels = torch.randint(0, V, (B, S), generator=g, device=dev)
        labels[0, :7] = -1
        placements = shd.to_placements(shd.P("data", None, "model"), mesh)
        x = logits.clone().requires_grad_()
        ref, _ = cross_entropy(x, labels)
        (g,) = torch.autograd.grad(ref, x)
        ref, f32 = float(ref), shd.local_shard(g, mesh, placements).clone()
        del x, g
        exact = _p19_loss_grad64(logits, labels)
        exact = shd.local_shard(exact, mesh, placements).clone()
        scale = float(exact.abs().max())
        xd = shd.distribute(logits, mesh, placements).requires_grad_()
        del logits
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with ctx.use_mesh(mesh):
            loss, _ = cross_entropy(xd, labels)
            (gd,) = torch.autograd.grad(loss, xd)
        loss = float(loss.to_local())
        dt = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base if on_card
                else None)
        here = gd.to_local()

        def err(a, b):
            return float((a.double() - b.double()).abs().max()) / scale
        row = {"rank": rank, "shape": [B, S, V], "loss": loss,
               "unsharded_loss": ref,
               "loss_rel_err": abs(loss - ref) / abs(ref),
               "grad_err_over_max": err(here, exact),
               "grad_vs_unsharded_f32_over_max": err(here, f32),
               "unsharded_f32_vs_f64_over_max": err(f32, exact),
               "grad_placements": str(tuple(gd.placements)),
               "peak_above_inputs_bytes": peak,
               "global_logits_bytes": 4 * B * S * V, "ms": dt}
        _p17_out("19c", rank).write_text(json.dumps(row))
    finally:
        dist.destroy_process_group()


def family_mesh_path(dev):
    """Phase 19: returns 19b's launches."""
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for f in out_dir.glob("phase17_19*"):
        f.unlink()
    rec = RECORD["phase19"] = {"card": RECORD.get("nvidia_smi")}
    t0 = time.perf_counter()
    mp.start_processes(_p19_one_rank, args=(on_card,), nprocs=1, join=True,
                       start_method="spawn")
    b = json.loads(_p17_out("19b", 0).read_text())
    rec["19b"] = b
    for row in b["rows"]:
        emit({"phase19b": row})
    emit({"phase19b_s": time.perf_counter() - t0, "backend": b["backend"],
          "wrapper_calls": b["wrapper_calls"]})
    # 19c where 17a found gloo's all-reduce on the card's tensors
    probe = RECORD.get("phase17", {}).get("17a") or _p17_probe(on_card)
    t0 = time.perf_counter()
    if probe.get("c10d all_reduce") == "ok":
        shape = (8, 128, 151936) if on_card else (4, 16, 1024)
        mp.start_processes(_p19_loss, args=(on_card, str(
            out_dir / "phase19_store"), shape), nprocs=2, join=True,
            start_method="spawn")
        c = [json.loads(_p17_out("19c", r).read_text()) for r in (0, 1)]
        rec["19c"] = c
        for row in c:
            emit({"phase19c": row})
        check(all(r["loss_rel_err"] <= 1e-6 for r in c),
              "19c: the vocab-parallel loss within 1e-6 of the unsharded")
        check(all(r["grad_err_over_max"] <= 1e-6 for r in c),
              "19c: each gradient shard within 1e-6 of max|g| of the f64 "
              "gradient")
        check(not on_card or all(r["peak_above_inputs_bytes"]
                                 < r["global_logits_bytes"] for r in c),
              "19c: each rank's peak below the global logits' bytes")
    else:
        rec["19c"] = ("not run: gloo's all_reduce on the card's tensors "
                      f"failed in 17a's probe ({probe.get('c10d all_reduce')}"
                      "); the CPU tests hold the loss on two ranks")
        emit({"phase19c": rec["19c"]})
    emit({"phase19c_s": time.perf_counter() - t0})
    rec["launches"] = b["launches"]
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase19_s": rec["seconds"], "launches": b["launches"]})
    return b["launches"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.kernels import _build, tcec_matmul as tm
    dev = torch.device("cuda")
    t_run = time.perf_counter()
    # any tuning of this process (REPRO_TUNE=1, or a scope that turns it
    # on) starts cold from a file of this run, never the home directory's
    RECORD["tune_cache"] = str(use_tune_cache(
        fresh_tune_cache("tcec_autotune.json")).tune_cache)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    RECORD["nvidia_smi"] = smi
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    build_s = _build.build()
    emit({"build_s": build_s})
    RECORD["build_s"] = build_s
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.txt").write_text("\n".join(
        f"== {k}\n{v}" for k, v in _build.build_logs.items()))

    # phase 2: every kernel at its main-path shapes, plus a ragged one
    check(tm.path(64) == "skinny" and tm.path(65) == "wgmma",
          "the M 64 / 65 rows straddle the path threshold")
    k1 = None
    for case in KERNEL1_CASES + DEEPSEEK_KERNEL1_CASES:
        row = matmul_case(dev=dev, **case)
        k1 = k1 or row
    matmul_epilogue_check(dev)
    # kernel 2 at the engine's four prefill shapes, then x10 with a softcap
    # and a window (ragged: 150 is a multiple of neither key tile)
    k2 = attention_case("prefill 2x512, 16/8 heads", 2, 512, 16, 8, 128, dev)
    attention_case("prefill 2x208 (ragged)", 2, 208, 16, 8, 128, dev)
    attention_case("prefill 2x64", 2, 64, 16, 8, 128, dev)
    attention_case("prefill 2x32", 2, 32, 16, 8, 128, dev)
    attention_case("training 8x128, 16/8 heads", 8, 128, 16, 8, 128, dev)
    attention_case("x10, softcap 30, window 100, 2x150", 2, 150, 16, 8, 128,
                   dev, policy="tcec_bf16x10", window=100, softcap=30.0)
    attention_case("prefill 2x512, 16/8 heads, hd 64", 2, 512, 16, 8, 64,
                   dev)
    # qwen3-0.6b's training length in phase 11b
    attention_case("prefill 1x16384, 16/8 heads", 1, 16384, 16, 8, 128, dev,
                   reps=5)
    attention_case("zamba2 2x512, 32/32 heads, hd 64", 2, 512, 32, 32, 64,
                   dev)
    # seamless (phase 10): the encoder's non-causal self-attention, and the
    # cross-attention of a decode step: one query row against the memory
    attention_case("seamless encoder 2x512, 16/16 heads, hd 64, non-causal",
                   2, 512, 16, 16, 64, dev, causal=False)
    attention_case("seamless cross-attention at decode, 4 x 1 against T 512",
                   4, 1, 16, 16, 64, dev, causal=False, T=512, reps=40)
    # phase 12's head_dim 256: gemma-2b's MQA prefill, gemma2-9b's global
    # and local layers (softcap 50; the window binds at 1 x 8192), and x3
    # and x10 at 256 (32- and 16-key tiles); qwen2.5-14b's 40/8 heads of
    # 128 (rep 5: 4 padding rows a block)
    attention_case("gemma-2b prefill 2x512, 8/1 heads, hd 256", 2, 512, 8, 1,
                   256, dev)
    attention_case("gemma2-9b prefill 2x512, 16/8 heads, hd 256, softcap 50",
                   2, 512, 16, 8, 256, dev, softcap=50.0)
    attention_case("gemma2-9b local 1x8192, hd 256, window 4096, softcap 50",
                   1, 8192, 16, 8, 256, dev, window=4096, softcap=50.0,
                   reps=5)
    attention_case("x3 2x512, 16/8 heads, hd 256", 2, 512, 16, 8, 256, dev,
                   policy="tcec_bf16x3")
    attention_case("x10 2x512, 16/8 heads, hd 256", 2, 512, 16, 8, 256, dev,
                   policy="tcec_bf16x10")
    attention_case("qwen2.5-14b prefill 2x512, 40/8 heads", 2, 512, 40, 8,
                   128, dev)
    # phase 13: deepseek-v3-671b's MLA prefill, qk head dim 192 (nope 128 +
    # rope 64: the 256 instantiation) beside a v head dim of 128
    attention_case("deepseek MLA prefill 2x512, 128/128 heads, hd 192, "
                   "hdv 128", 2, 512, 128, 128, 192, dev, hdv=128)
    # phase 16: a chunk of qwen3-0.6b's chunked prefill, 256 queries at
    # positions 256-511 against the f32 scratch of 768 keys
    attention_case("qwen3 chunk: C 256 at start 256, scratch 768", 1, 256,
                   16, 8, 128, dev, T=768, q0=256)
    k3 = paged_case("decode 4 slots", [520, 520, 208, 208], 16, 8, 128, 16,
                    40, dev)
    paged_case("decode 4 slots, hd 64", [520, 520, 208, 208], 16, 8, 64, 16,
               40, dev)
    paged_case("ragged, window 100", [0, 1, 17, 300], 16, 8, 128, 16, 40,
               dev, window=100)
    # bound by bytes: 134 MB of K/V, more than the L2 in one call
    paged_case("decode 32 slots x 1024", [1024] * 32, 16, 8, 128, 16, 64,
               dev, copies=3, plain_reps=1)
    # phase 12: gemma-2b's MQA decode at hd 256 (one kv head: C 1), and
    # gemma2-9b's local layer where its window binds (C 2, 104 MB of K/V)
    paged_case("gemma-2b decode 4 slots, 8/1 heads, hd 256",
               [520, 520, 208, 208], 8, 1, 256, 16, 40, dev)
    paged_case("gemma2-9b decode 4 slots, hd 256, window 4096, softcap 50",
               [5000, 5000, 4200, 300], 16, 8, 256, 16, 320, dev,
               window=4096, softcap=50.0, copies=2)
    # phase 16's f32 pools: the f32 instantiation at qwen3-0.6b's decode and
    # at gemma2-9b's (the window binds, softcap 50)
    k3f = paged_case("f32 pools: decode 4 slots", [520, 520, 208, 208], 16, 8,
                     128, 16, 40, dev, dtype=torch.float32)
    paged_case("f32 pools: gemma2-9b decode 4 slots, hd 256, window 4096, "
               "softcap 50", [5000, 5000, 4200, 300], 16, 8, 256, 16, 320,
               dev, window=4096, softcap=50.0, copies=2, dtype=torch.float32)

    paper_check(dev)                               # phase 3
    launches, model = main_path(dev)               # phases 4 and 5
    where_time_goes(dev, *model)                   # phase 6
    del model
    train_launches = training(dev)                 # phase 7
    moe_launches = moe_path(dev)                   # phase 8
    ssm_launches = ssm_path(dev)                   # phase 9
    encdec_launches = encdec_vlm_path(dev)         # phase 10
    numerics_launches = paper_numerics(dev)        # phase 11
    large_launches = large_dense(dev)              # phase 12
    deepseek_launches = deepseek_path(dev)         # phase 13
    config_launches = numerics_path(dev)           # phase 14
    resilience_launches = resilience_path(dev)     # phase 15
    prefix_launches, prefix_f32 = prefix_path(dev)  # phase 16
    parallel_launches = parallel_path(dev)         # phase 17
    dryrun_launches = dryrun_path(dev)             # phase 18
    family_mesh_launches = family_mesh_path(dev)   # phase 19

    src = "src/repro_torch/csrc/{}.cu"
    rep = "src/repro/kernels/{}"
    kernels = []
    for name, row, replaces in (
            ("tcec_matmul", k1, "tcec_matmul.py:69"),
            ("tcec_attention", k2, "tcec_attention.py:102"),
            ("tcec_paged_attention", k3, "tcec_paged_attention.py:61"),
            ("tcec_paged_attention_f32", k3f, "tcec_paged_attention.py:61")):
        if name == "tcec_paged_attention_f32":      # phase 16's f32 pools
            count = prefix_f32
        else:
            count = (launches[name] + train_launches.get(name, 0)
                     + moe_launches[name] + ssm_launches[name]
                     + encdec_launches[name] + numerics_launches[name]
                     + large_launches[name] + deepseek_launches[name]
                     + config_launches[name] + resilience_launches[name])
            if name != "tcec_paged_attention":
                count += prefix_launches[name]
            count += parallel_launches[name]
            count += dryrun_launches.get(name, 0)
            count += family_mesh_launches.get(name, 0)
        kernels.append({
            "name": name, "route": "cuda",
            "source": src.format("tcec_paged_attention"
                                 if name.endswith("_f32") else name),
            "replaces": rep.format(replaces),
            "launches": count,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    RECORD["kernels"] = kernels
    RECORD["run_s"] = time.perf_counter() - t_run
    emit({"run_s": RECORD["run_s"]})
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
