"""Continuous-batching serving engine over the paged KV cache.

The core of the JAX package's engine, in PyTorch:

  * admission: waiting requests are admitted FIFO whenever a slot and
    enough pages are free (``scheduler.py``); admissions with the same
    padded prompt length prefill together as one batch;
  * prefill: one sequence-level forward (``models.lm.prefill``: kernel 1
    for every projection, expert product and the unembed, kernel 2 for
    attention) returns the logits and every layer's K/V, which are written
    into the request's pages.  In the MoE family a prompt's padding takes
    expert capacity, so grouping admissions by padded length (as the JAX
    engine does) is part of the result, not only of the speed;
  * decode: one step advances every slot through
    :func:`_decode_and_sample` (``models.lm.decode_step_paged``, kernel 3
    over the pages, then the vectorized sampler); inactive slots point at
    the scrap page 0 and are ignored.  On ``cuda`` the step is one replay
    of a captured CUDA graph (:class:`_DecodeGraph`) between one upload of
    the packed per-slot inputs and one download of the tokens and guard
    bits; on the CPU the same function runs eagerly;
  * completion: stop tokens / ``max_tokens`` finish a request on the host;
    a request that outgrows its block-table row finishes with
    ``length_cap``; its slot and pages recycle into the next admission;
  * preemption: when the pool runs dry the youngest running request is
    evicted (recompute-style) and re-admitted later.

Not ported yet: per-request deadlines, a bounded waiting queue, and the
parking of a request after repeated preemptions (the JAX engine parks after
8; here a request is always re-queued at the front).

A decode step whose logits are not finite finishes the affected slots with
``FinishReason.ERROR``.  The JAX engine would first re-run the step on its
XLA fallback path; here that re-run would be a fallback that hides the
kernel, so it is left out.  Also not ported yet: the prefix cache, chunked
prefill, async scheduling (the dispatch / consume split and the
double-buffered staging are its seam), fault injection, tracing spans,
meshes and defragmentation.

Numerics contract (tests/test_torch_serving.py): with parameters bridged
from JAX, greedy output is token-identical to the JAX engine's.

The engine pins its numerics config at construction (``numerics_config``,
else the caller's ``numerics.active()``), as JAX's does: its model handle
runs every prefill, eager decode step, the decode graph's warm-up and its
capture under that config, so a ``numerics.use`` entered mid-serve changes
none of them (and no replay re-runs Python).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch import numerics, resolve_device
from repro_torch.kernels import (tcec_attention, tcec_matmul,
                                 tcec_paged_attention)
from repro_torch.models import get_model
from . import sampling
from .errors import FinishReason, RequestRejected, RequestResult
from .kv_cache import DEFAULT_PAGE_SIZE, PagePool, write_prompt_pages
from .sampling import SamplingParams, draw_uniform, new_generator, sample_one
from .scheduler import Request, Scheduler

# The decode step's per-slot inputs, packed into one byte buffer that goes
# to the device in one copy: name, dtype, columns (None: one a slot).  f64
# comes first, so every field starts at a multiple of its item size.
_INPUTS = (("uniforms", torch.float64, None), ("temps", torch.float32, None),
           ("topps", torch.float32, None), ("topks", torch.int32, None),
           ("lengths", torch.int32, None), ("next_tok", torch.int32, None),
           ("block_tables", torch.int32, "maxp"))


def _input_bytes(B: int, maxp: int) -> int:
    return sum(B * (maxp if cols else 1) * dt.itemsize
               for _, dt, cols in _INPUTS)


def _input_views(buf, B: int, maxp: int) -> dict:
    """Named views of a packed input buffer ``buf`` (uint8, on any
    device)."""
    views, off = {}, 0
    for name, dt, cols in _INPUTS:
        shape = (B, maxp) if cols else (B,)
        n = math.prod(shape) * dt.itemsize
        views[name] = buf[off:off + n].view(dt).reshape(shape)
        off += n
    return views


class _Staging:
    """One packed host buffer of the decode inputs (pinned when the engine
    runs on ``cuda``), with torch and numpy views of its fields."""

    def __init__(self, B: int, maxp: int, pin: bool):
        self.buffer = torch.zeros(_input_bytes(B, maxp), dtype=torch.uint8,
                                  pin_memory=pin)
        self.tensors = _input_views(self.buffer, B, maxp)
        self.arrays = {k: t.numpy() for k, t in self.tensors.items()}


class Engine:
    """Continuous-batching engine for the dense and MoE families.

    max_slots: decode batch width (inactive slots are masked).
    num_pages: pool size including the reserved scrap page 0.
    page_size: tokens per page.
    max_pages_per_slot: block-table width; a request that outgrows it
        finishes early (``length_cap``), like any server's max context.
    cache_dtype: page-pool element dtype (bf16; kernel 3 takes bf16 pools).
    device: where the pools live and the steps run (default ``cuda``); the
        parameters must already be there.
    numerics_config: the :class:`repro_torch.numerics.NumericsConfig` every
        step runs under (default: the one active at construction).
    """

    def __init__(self, cfg, params, *, max_slots: int = 4,
                 num_pages: int | None = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 max_pages_per_slot: int | None = None,
                 cache_dtype=torch.bfloat16, device=None,
                 numerics_config: numerics.NumericsConfig | None = None):
        self.numerics_config = numerics_config or numerics.active()
        self.model = get_model(cfg, self.numerics_config)
        if self.model.decode_step_paged is None:
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path; use "
                "launch.serve.generate_dense")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters on {params['embed'].device}, "
                             f"engine on {self.device}")
        if num_pages is None:
            num_pages = 1 + max_slots * 32
        if max_pages_per_slot is None:
            max_pages_per_slot = min(64, num_pages - 1)
        self.cfg = cfg
        self.params = params
        self.pool = PagePool(num_pages, page_size)
        self.sched = Scheduler(self.pool, max_slots)
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.pools = self.model.init_paged_cache(
            num_pages, page_size, dtype=cache_dtype, device=self.device)
        # host mirrors of the per-slot device state
        self.block_tables = np.zeros((max_slots, max_pages_per_slot),
                                     np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.next_tok = np.zeros((max_slots,), np.int32)
        self.temps = np.zeros((max_slots,), np.float32)
        self.topks = np.zeros((max_slots,), np.int32)
        self.topps = np.ones((max_slots,), np.float32)
        self.uniforms = np.ones((max_slots,), np.float64)
        # double-buffered staging of those mirrors: the buffer of step N is
        # not written again before step N + 2, so an asynchronous scheduler
        # may fill the next one while a step is in flight
        pin = self.device.type == "cuda"
        self._staging = [_Staging(max_slots, max_pages_per_slot, pin)
                         for _ in range(2)]
        self._graph: _DecodeGraph | None = None   # captured on first use
        self._requests: dict[int, Request] = {}
        self._stats = {"numerics_errors": 0, "rejections": 0,
                       "length_caps": 0}
        self.n_decode_steps = 0
        self.n_prefills = 0

    # ------------------------------------------------------------ intake

    def add_request(self, prompt,
                    params: SamplingParams | None = None) -> int:
        """Enqueue a request; returns its rid.  Raises
        :class:`RequestRejected` for requests that can never be served."""
        params = params or SamplingParams()
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if params.max_tokens < 1:
            self._stats["rejections"] += 1
            raise RequestRejected(
                f"max_tokens must be >= 1, got {params.max_tokens}")
        need = self.pool.pages_for(len(prompt) + 1)
        if need > min(self.max_pages_per_slot, self.pool.num_pages - 1):
            self._stats["rejections"] += 1
            raise RequestRejected(
                f"prompt needs {need} pages; engine caps at "
                f"{self.max_pages_per_slot} per slot")
        req = self.sched.add(prompt, params)
        req.generator = new_generator(params)
        self._requests[req.rid] = req
        return req.rid

    # ----------------------------------------------------------- prefill

    def _admit_and_prefill(self):
        # a preempted request may have generated its way past the per-slot
        # cap: finish it from the queue instead of re-admitting it
        cap = min(self.max_pages_per_slot, self.pool.num_pages - 1)
        for req in [r for r in list(self.sched.waiting)
                    if self.pool.pages_for(len(r.full_sequence) + 1) > cap]:
            self._stats["length_caps"] += 1
            req.finish_reason = FinishReason.LENGTH_CAP.value
            self.sched.drop(req)
        admitted = self.sched.admit()
        ps = self.pool.page_size
        groups: dict[int, list[Request]] = {}
        for req in admitted:
            padded = max(1, -(-len(req.full_sequence) // ps)) * ps
            groups.setdefault(padded, []).append(req)
        for padded, reqs in sorted(groups.items()):
            toks = np.zeros((len(reqs), padded), np.int64)
            for i, req in enumerate(reqs):
                toks[i, :len(req.full_sequence)] = req.full_sequence
            logits, kv = self.model.prefill(
                self.params, torch.from_numpy(toks).to(self.device))
            self.n_prefills += 1
            pages = np.asarray([req.pages[:padded // ps] for req in reqs],
                               np.int64)
            write_prompt_pages(self.pools, kv,
                               torch.from_numpy(pages).to(self.device))
            for i, req in enumerate(reqs):
                plen = len(req.full_sequence)
                self.lengths[req.slot] = plen
                self._sync_slot(req)
                row = logits[i, plen - 1, :self.cfg.vocab_size].float()
                if not bool(torch.isfinite(row).all()):
                    self._stats["numerics_errors"] += 1
                    self._finish(req, FinishReason.ERROR)
                    continue
                self._accept_token(
                    req, sample_one(row, req.params, req.generator))

    def _sync_slot(self, req: Request):
        s = req.slot
        self.block_tables[s] = 0
        self.block_tables[s, :len(req.pages)] = req.pages
        self.temps[s] = req.params.temperature
        self.topks[s] = req.params.top_k
        self.topps[s] = req.params.top_p

    def _clear_slot(self, slot: int):
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        self.next_tok[slot] = 0
        self.temps[slot] = 0.0
        self.topks[slot] = 0
        self.topps[slot] = 1.0

    def _accept_token(self, req: Request, tok: int) -> bool:
        """Host-side completion logic; True while still running."""
        if tok in req.params.stop_tokens:
            self._finish(req, FinishReason.STOP)
            return False
        req.out.append(tok)
        if len(req.out) >= req.params.max_tokens:
            self._finish(req, FinishReason.LENGTH)
            return False
        self.next_tok[req.slot] = tok
        return True

    def _finish(self, req: Request, reason: FinishReason):
        req.finish_reason = reason.value
        slot = req.slot
        self.sched.finish(req)
        self._clear_slot(slot)

    # ------------------------------------------------------------ decode

    def _ensure_pages(self):
        """Every running slot must own the page its next token writes to;
        grow (possibly preempting) before the step, not during it."""
        ps = self.pool.page_size
        for req in sorted(self.sched.running.values(),
                          key=self.sched.admitted_at):
            if req.slot is None:        # preempted by an earlier grow
                continue
            page_idx = int(self.lengths[req.slot]) // ps
            if page_idx >= self.max_pages_per_slot:
                self._stats["length_caps"] += 1
                self._finish(req, FinishReason.LENGTH_CAP)
                continue
            if page_idx < len(req.pages):
                continue
            before = {r.rid: r.slot for r in self.sched.running.values()}
            grown = self.sched.grow(req)
            if not grown:
                slot = req.slot
                if len(req.pages) + 1 >= self.pool.num_pages:
                    # the pool cannot hold even this one request
                    self._finish(req, FinishReason.ERROR)
                else:
                    self.sched.preempt(req)
                    self._clear_slot(slot)
            for rid, slot in before.items():
                r = self._requests[rid]
                if r.slot is None and rid != req.rid:
                    self._clear_slot(slot)      # preempted: mask its slot
            if grown:
                self._sync_slot(req)

    def _decode_dispatch(self):
        """Launch one decode step for every running slot and return the
        in-flight record (None when nothing runs).  Each sampled request
        draws its uniform here; the mirrors are copied into this step's
        staging buffer, so they are free to change once this returns."""
        running = list(self.sched.running.values())
        if not running:
            return None
        for req in running:
            self.uniforms[req.slot] = draw_uniform(req.params, req.generator)
        stage = self._staging[self.n_decode_steps % 2]
        for name, host in stage.arrays.items():
            np.copyto(host, getattr(self, name))
        if self.device.type == "cuda":
            if self._graph is None:
                self._graph = _DecodeGraph(self)
            out, done = self._graph.launch(
                stage.buffer, any(not r.params.greedy for r in running))
        else:
            v = stage.tensors
            toks, finite, _ = _decode_and_sample(
                self.params, self.pools, v["block_tables"], v["lengths"],
                v["next_tok"], v["temps"], v["topks"], v["topps"],
                v["uniforms"], model=self.model, cfg=self.cfg)
            out, done = torch.stack([finite.long(), toks]), None
        self.n_decode_steps += 1
        return {"running": running, "out": out, "done": done}

    def _decode_consume(self, inflight):
        """Wait for a dispatched step (the step's one sync) and apply it:
        a slot whose logits are not finite fails with ``ERROR``; every other
        slot caches its input token and takes its new one."""
        if inflight["done"] is not None:
            inflight["done"].synchronize()
        finite, toks = inflight["out"].tolist()
        for req in inflight["running"]:
            if not finite[req.slot]:
                self._stats["numerics_errors"] += 1
                self._finish(req, FinishReason.ERROR)
                continue
            self.lengths[req.slot] += 1      # its input token is now cached
            self._accept_token(req, int(toks[req.slot]))

    # ------------------------------------------------------------- drive

    @torch.no_grad()
    def step(self):
        """One engine iteration: admit and prefill, grow pages, then one
        decode step for every running slot."""
        self._admit_and_prefill()
        self._ensure_pages()
        inflight = self._decode_dispatch()
        if inflight is not None:
            self._decode_consume(inflight)

    def run(self, prompts=None, params=None) -> dict[int, RequestResult]:
        """Optionally enqueue ``prompts`` (with one :class:`SamplingParams`
        each, or one shared), run to drain, and return :meth:`results`."""
        if prompts is not None:
            if params is None or isinstance(params, SamplingParams):
                params = [params] * len(prompts)
            for prompt, sp in zip(prompts, params):
                self.add_request(prompt, sp)
        while self.sched.has_work:
            self.step()
        return self.results()

    def results(self) -> dict[int, RequestResult]:
        return {rid: RequestResult(req.out, req.finish_reason)
                for rid, req in self._requests.items()}

    def stats(self) -> dict:
        """Engine counters; on ``cuda`` also the decode program's: its
        eager warm-up steps, its capture time and its replays (all of them,
        and of the sampler graph)."""
        g = self._graph
        return {**self._stats, "prefills": self.n_prefills,
                "decode_steps": self.n_decode_steps,
                "preemptions": self.sched.n_preemptions,
                "decode_warmups": 0 if g is None else 1,
                "capture_s": 0.0 if g is None else g.capture_s,
                "graph_replays": 0 if g is None else g.replays,
                "sampler_replays": 0 if g is None else g.sampler_replays}


def _decode_step(params, pools, block_tables, lengths, toks, *, model, cfg):
    """The model half of :func:`_decode_and_sample`: the paged decode
    (each slot's K/V written into its page in place), the logits sliced to
    the vocabulary in f32, the per-slot ``isfinite`` guard bit and the
    greedy argmax.  Returns ``(logits, finite, greedy)``."""
    logits = model.decode_step_paged(params, pools, block_tables, lengths,
                                     toks)
    logits = logits[:, :cfg.vocab_size].float()
    return logits, torch.isfinite(logits).all(dim=-1), torch.argmax(logits,
                                                                     dim=-1)


def _decode_and_sample(params, pools, block_tables, lengths, toks, temps,
                       topks, topps, uniforms, *, model, cfg):
    """The engine step: paged model decode and vectorized sampling for
    the whole slot array (the JAX engine's jitted step, without its fault
    mask; the pools are updated in place rather than returned).

    Returns ``(tokens, finite, logits)``: ``finite`` is the per-slot guard
    bit; False means the slot's logits hold a non-finite value and its
    token must not be trusted.  The CPU engine runs this eagerly; on
    ``cuda`` :class:`_DecodeGraph` replays it."""
    logits, finite, _ = _decode_step(params, pools, block_tables, lengths,
                                     toks, model=model, cfg=cfg)
    tokens = sampling.sample(logits, temps, topks, topps, uniforms)
    return tokens, finite, logits


class _DecodeGraph:
    """The engine's decode step on the card, as captured CUDA graphs over
    static device buffers.

    * ``main``: :func:`_decode_step` over the static inputs, writing the
      guard bits and the greedy tokens into ``out``;
    * ``sampler``: :func:`sampling.sample` over ``main``'s static logits,
      overwriting the tokens.  It is replayed only on steps where a running
      slot samples, so an all-greedy step sorts nothing.

    A step is one upload of the packed inputs, the replays, and one
    download of ``out`` (guard bits and tokens), which the consume waits
    for: the step's one sync.  Capture happens on the first decode step,
    after one eager warm-up step on a side stream with every slot at the
    scrap page 0 and length 0 (its K/V lands in scrap): the warm-up loads
    each kernel's library and makes every kernel-side setup call, so the
    capture holds nothing but launches.  The engine's parameters and pools
    must keep their storage from then on.  A failed capture or replay
    raises; there is no eager fallback.

    The kernels' Python wrappers run only at capture, so their launch
    counters see nothing of a replay: the increase each counter showed
    during capture (``launches``, and kernel 1's ``epilogue_launches``) is
    reset there (the capture launched nothing) and added at every replay.
    The warm-up's launches are real and stay counted.
    """

    def __init__(self, engine):
        t0 = time.perf_counter()
        dev = engine.device
        B, maxp = engine.max_slots, engine.max_pages_per_slot
        self.inputs = torch.zeros(_input_bytes(B, maxp), dtype=torch.uint8,
                                  device=dev)
        v = _input_views(self.inputs, B, maxp)
        self.out = torch.zeros((2, B), dtype=torch.int64, device=dev)
        self.host_out = torch.zeros((2, B), dtype=torch.int64,
                                    pin_memory=True)
        self.done = torch.cuda.Event()
        self._counters = (tcec_matmul, tcec_attention, tcec_paged_attention)

        def main():
            logits, finite, greedy = _decode_step(
                engine.params, engine.pools, v["block_tables"],
                v["lengths"], v["next_tok"], model=engine.model,
                cfg=engine.cfg)
            self.out[0].copy_(finite)
            self.out[1].copy_(greedy)
            return logits

        def sampler(logits):
            self.out[1].copy_(sampling.sample(logits, v["temps"], v["topks"],
                                              v["topps"], v["uniforms"]))

        # the inputs are zeros: every slot at page 0, length 0
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            sampler(main())
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [m.launches for m in self._counters]
        epilogues = dict(tcec_matmul.epilogue_launches)
        self.main = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.main):
            self.logits = main()
        self.per_replay = [m.launches - n
                           for m, n in zip(self._counters, before)]
        for m, n in zip(self._counters, before):
            m.launches = n
        self.epilogues_per_replay = {
            k: n - epilogues[k]
            for k, n in tcec_matmul.epilogue_launches.items()}
        tcec_matmul.epilogue_launches.update(epilogues)
        self.sampler = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.sampler):
            sampler(self.logits)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0
        self.sampler_replays = 0

    def launch(self, staged, sample: bool):
        """Upload ``staged`` (the packed pinned inputs), replay, and start
        the download; returns the pinned output ``(2, B)`` (guard bits,
        tokens) and the event that marks it complete."""
        self.inputs.copy_(staged, non_blocking=True)
        self.main.replay()
        if sample:
            self.sampler.replay()
            self.sampler_replays += 1
        self.host_out.copy_(self.out, non_blocking=True)
        self.done.record()
        self.replays += 1
        for m, n in zip(self._counters, self.per_replay):
            m.launches += n
        for k, n in self.epilogues_per_replay.items():
            tcec_matmul.epilogue_launches[k] += n
        return self.host_out, self.done
