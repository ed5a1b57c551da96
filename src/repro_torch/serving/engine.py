"""Continuous-batching serving engine over the paged KV cache.

The core of the JAX package's engine, in PyTorch:

  * admission: waiting requests are admitted FIFO whenever a slot and
    enough pages are free (``scheduler.py``); admissions with the same
    padded prompt length prefill together as one batch;
  * prefill: one sequence-level forward (``models.lm.prefill``: kernel 1
    for every projection and the unembed, kernel 2 for attention) returns
    the logits and every layer's K/V, which are written into the request's
    pages;
  * decode: one step advances every slot through
    ``models.lm.decode_step_paged`` (kernel 3 over the pages); inactive
    slots point at the scrap page 0 and are ignored;
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
prefill, async scheduling, fault injection, tracing spans, meshes and
defragmentation.

Numerics contract (tests/test_torch_serving.py): with parameters bridged
from JAX, greedy output is token-identical to the JAX engine's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import get_model
from .errors import FinishReason, RequestRejected, RequestResult
from .kv_cache import DEFAULT_PAGE_SIZE, PagePool, write_prompt_pages
from .sampling import SamplingParams, new_generator, sample_one
from .scheduler import Request, Scheduler


class Engine:
    """Continuous-batching engine for the dense family.

    max_slots: decode batch width (inactive slots are masked).
    num_pages: pool size including the reserved scrap page 0.
    page_size: tokens per page.
    max_pages_per_slot: block-table width; a request that outgrows it
        finishes early (``length_cap``), like any server's max context.
    cache_dtype: page-pool element dtype (bf16; kernel 3 takes bf16 pools).
    device: where the pools live and the steps run (default ``cuda``); the
        parameters must already be there.
    """

    def __init__(self, cfg, params, *, max_slots: int = 4,
                 num_pages: int | None = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 max_pages_per_slot: int | None = None,
                 cache_dtype=torch.bfloat16, device=None):
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
        self.model = get_model(cfg)
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
        self.next_tok = np.zeros((max_slots,), np.int64)
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

    def _clear_slot(self, slot: int):
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        self.next_tok[slot] = 0

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

    def _decode(self):
        """One decode step for every running slot."""
        running = list(self.sched.running.values())
        if not running:
            return
        dev = self.device
        logits = self.model.decode_step_paged(
            self.params, self.pools,
            torch.from_numpy(self.block_tables).to(dev),
            torch.from_numpy(self.lengths).to(dev),
            torch.from_numpy(self.next_tok).to(dev))
        self.n_decode_steps += 1
        logits = logits[:, :self.cfg.vocab_size].float()
        finite, greedy = torch.stack([torch.isfinite(logits).all(dim=-1),
                                      torch.argmax(logits, dim=-1)]).tolist()
        for req in running:
            if not finite[req.slot]:
                self._stats["numerics_errors"] += 1
                self._finish(req, FinishReason.ERROR)
                continue
            self.lengths[req.slot] += 1      # its input token is now cached
            tok = (int(greedy[req.slot]) if req.params.greedy else
                   sample_one(logits[req.slot], req.params, req.generator))
            self._accept_token(req, tok)

    # ------------------------------------------------------------- drive

    @torch.no_grad()
    def step(self):
        """One engine iteration: admit and prefill, grow pages, then one
        decode step for every running slot."""
        self._admit_and_prefill()
        self._ensure_pages()
        self._decode()

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
        return {**self._stats, "prefills": self.n_prefills,
                "decode_steps": self.n_decode_steps,
                "preemptions": self.sched.n_preemptions}
